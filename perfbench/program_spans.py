"""The program's own spans (``rj.*``, named in ``repro_torch.obs``) in a
traced window: their intervals, and the device's busy time inside them.

The spans come from ``ctx.tracer.cpu`` and the busy time from
``ctx.tracer.busy_intervals()``. A program that emits no such spans gives
empty intervals, and the readers then report nothing.
"""

from __future__ import annotations

import numpy as np

from perfbench.trace import _union_ns

QUERY = "rj.query"
SYNC = "rj.sync."
#: RelJoin's run-time decisions: method selection, runtime-filter planning
#: and the region's join order.
SELECTION = ("rj.select", "rj.filters.plan", "rj.replan")


def _events(tracer, match):
    """(starts, ends) of the window's CPU events whose name ``match``es."""
    cs, ce, cn = tracer.cpu
    ws, we = tracer.window_ns
    keep = np.asarray([match(n) for n in cn], dtype=bool)
    keep &= (cs >= ws) & (cs <= we)
    return cs[keep], ce[keep]


def count(tracer, prefix: str) -> int:
    """Events of the window whose name starts with ``prefix``."""
    return len(_events(tracer, lambda n: n.startswith(prefix))[0])


def union(tracer, names) -> tuple:
    """Merged intervals of the window's events named in ``names``; nested
    and overlapping spans are counted once."""
    names = frozenset(names)
    return _union_ns(*_events(tracer, names.__contains__))


def length_ns(intervals) -> int:
    s, e = intervals
    return int((e - s).sum())


def busy_before(busy, t: np.ndarray) -> np.ndarray:
    """Device-busy ns before each time in ``t``, over the merged ``busy``
    intervals."""
    bs, be = busy
    t = np.asarray(t, np.int64)
    if not len(bs):
        return np.zeros(t.shape, np.int64)
    done = np.concatenate([[0], np.cumsum(be - bs)])  # before interval j
    i = np.searchsorted(bs, t, side="right")  # intervals begun by t
    j = np.maximum(i - 1, 0)
    part = np.minimum(t - bs[j], be[j] - bs[j])
    return np.where(i > 0, done[j] + part, 0)


def busy_inside_ns(busy, intervals) -> int:
    """Device-busy ns inside disjoint ``intervals``."""
    s, e = intervals
    if not len(s):
        return 0
    return int((busy_before(busy, e) - busy_before(busy, s)).sum())
