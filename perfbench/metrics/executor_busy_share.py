"""executor_busy_share: the share of the executor's time in which the
device is busy, in percent: device-busy time inside the union of the
program's ``rj.query`` spans (``Executor.execute``: evaluation and its
synchronize) over the length of that union. Nothing to read where the
program records no ``rj.query`` span."""

from perfbench import program_spans as ps


def read(ctx):
    if ctx.tracer is None:
        return None
    spans = ps.union(ctx.tracer, (ps.QUERY,))
    total = ps.length_ns(spans)
    if not total:
        return None
    busy = ps.busy_inside_ns(ctx.tracer.busy_intervals(), spans)
    return 100.0 * busy / total
