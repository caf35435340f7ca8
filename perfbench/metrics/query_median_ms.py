"""query_median_ms: the median latency of every query answered in the
traced window, in milliseconds: its client's submit (parse and bind
included) to the end of the ``QueryService.run`` that returned it. The
same statistic as the window's median; kept per layer, since where the
latencies of a mix's templates leave a gap at the middle the median jumps
across it from run to run."""

import numpy as np


def read(ctx):
    lat = [r.latency_s for r in ctx.records if r.ok]
    return 1e3 * float(np.percentile(np.asarray(lat, np.float64), 50)) \
        if lat else None
