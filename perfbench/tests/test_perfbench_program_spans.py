"""The readers of the program's own spans (``program_spans.py`` and the
three metrics on it) on synthetic tracers: nested spans count once, the
idle time inside a span is its length less the busy intervals, and a
window without ``rj.query`` spans (a program that emits none) gives no
reading."""

import types

import _paths  # noqa: F401
import numpy as np
import pytest

from perfbench import program_spans as ps
from perfbench.cell import Context, load_reader
from perfbench.trace import _union_ns

READERS = ("host_syncs_per_query", "executor_busy_share",
           "selection_idle_ms")


class FakeTracer:
    """What the readers use of ``perfbench.trace.Tracer``."""

    def __init__(self, spans, busy, window=(0, 1000)):
        self.window_ns = window
        self.cpu = (np.asarray([s for _, s, _ in spans], np.int64),
                    np.asarray([e for _, _, e in spans], np.int64),
                    [n for n, _, _ in spans])
        self._busy = _union_ns(np.asarray([s for s, _ in busy], np.int64),
                               np.asarray([e for _, e in busy], np.int64))

    def busy_intervals(self):
        return self._busy


def _ctx(tracer, answered=2):
    records = [types.SimpleNamespace(ok=True)] * answered
    return Context(records, {}, {}, {}, tracer)


#: Two queries; the first holds a join with a selection inside it (and a
#: re-plan nested in the selection), the second a filter plan.
SPANS = [
    ("perfbench.run", 0, 1000),
    ("rj.query", 100, 400),
    ("rj.op.join", 120, 380),
    ("rj.select", 150, 250),
    ("rj.replan", 160, 200),
    ("rj.sync.count", 300, 310),
    ("rj.sync.exchange", 320, 330),
    ("rj.query", 500, 700),
    ("rj.filters.plan", 520, 560),
    ("rj.sync.count", 600, 610),
    ("aten::item", 600, 609),
]
BUSY = [(50, 130), (140, 170), (240, 260), (600, 900)]


def test_nested_spans_count_once():
    t = FakeTracer(SPANS, BUSY)
    sel = ps.union(t, ps.SELECTION)
    assert sel[0].tolist() == [150, 520] and sel[1].tolist() == [250, 560]
    assert ps.length_ns(sel) == 140
    assert ps.length_ns(ps.union(t, (ps.QUERY,))) == 500
    assert ps.count(t, ps.SYNC) == 3


def test_idle_inside_a_span_is_the_complement_of_busy():
    t = FakeTracer(SPANS, BUSY)
    busy = t.busy_intervals()
    # rj.select [150, 250]: busy 150-170 and 240-250.
    assert ps.busy_inside_ns(busy, (np.array([150]), np.array([250]))) == 30
    queries = ps.union(t, (ps.QUERY,))
    # [100, 400]: 100-130, 140-170, 240-260; [500, 700]: 600-700.
    assert ps.busy_inside_ns(busy, queries) == 30 + 30 + 20 + 100


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_busy_before_matches_a_direct_sum(seed):
    rng = np.random.default_rng(seed)
    s = np.sort(rng.integers(0, 10_000, 50))
    busy = _union_ns(s, s + rng.integers(1, 400, 50))
    t = rng.integers(-100, 11_000, 200)
    direct = [sum(max(0, min(x, e) - b) for b, e in zip(*busy)) for x in t]
    assert ps.busy_before(busy, t).tolist() == direct
    assert ps.busy_before((np.zeros(0, np.int64),) * 2, t).tolist() == \
        [0] * len(t)


def test_readers_on_a_synthetic_window():
    ctx = _ctx(FakeTracer(SPANS, BUSY))
    values = {n: load_reader(n).read(ctx) for n in READERS}
    assert values["host_syncs_per_query"] == 3 / 2
    assert values["executor_busy_share"] == pytest.approx(100.0 * 180 / 500)
    # Selection [150, 250] and [520, 560]: 140 ns, 30 busy.
    assert values["selection_idle_ms"] == pytest.approx(110 / 1e6 / 2)


def test_spans_outside_the_window_are_left_out():
    spans = SPANS + [("rj.sync.count", 1200, 1210)]
    ctx = _ctx(FakeTracer(spans, BUSY))
    assert load_reader("host_syncs_per_query").read(ctx) == 3 / 2


@pytest.mark.parametrize("name", READERS)
def test_no_query_span_reads_nothing(name):
    without = [s for s in SPANS if s[0] != "rj.query"]
    reader = load_reader(name)
    assert reader.read(_ctx(FakeTracer(without, BUSY))) is None
    assert reader.read(_ctx(FakeTracer([("perfbench.run", 0, 1000)],
                                       BUSY))) is None
    assert reader.read(_ctx(None)) is None


@pytest.mark.parametrize("name", ["host_syncs_per_query",
                                  "selection_idle_ms"])
def test_no_query_answered_reads_nothing(name):
    ctx = _ctx(FakeTracer(SPANS, BUSY), answered=0)
    assert load_reader(name).read(ctx) is None
