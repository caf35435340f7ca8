"""The readers of the program's row mover (``row_moves_per_query``,
``row_move_idle_ms``) on synthetic tracers: moves nested in an exchange,
a compaction and a local join, the idle time inside their union, and no
reading where the program records no ``rj.move`` span (the program before
the mover had it)."""

import _paths  # noqa: F401
import pytest
from test_perfbench_program_spans import SPANS, FakeTracer, _ctx

from perfbench.cell import load_reader

READERS = ("row_moves_per_query", "row_move_idle_ms")

#: SPANS' two queries with an exchange, a compaction and a local join in
#: the first, each holding one move, and a compaction in the second.
MOVES = SPANS + [
    ("rj.exchange", 130, 170),
    ("rj.move", 140, 160),
    ("rj.local_join", 260, 290),
    ("rj.move", 265, 275),
    ("rj.compact", 340, 370),
    ("rj.move", 350, 360),
    ("rj.compact", 620, 660),
    ("rj.move", 640, 650),
]
BUSY = [(50, 130), (140, 150), (240, 270), (600, 900)]


def test_readers_on_a_synthetic_window():
    ctx = _ctx(FakeTracer(MOVES, BUSY))
    assert load_reader("row_moves_per_query").read(ctx) == 4 / 2
    # Moves [140, 160], [265, 275], [350, 360], [640, 650]: 50 ns; busy
    # 140-150, 265-270 and 640-650: 25 ns.
    assert load_reader("row_move_idle_ms").read(ctx) == pytest.approx(
        25 / 1e6 / 2)


def test_moves_outside_the_window_are_left_out():
    ctx = _ctx(FakeTracer(MOVES + [("rj.move", 1100, 1200)], BUSY))
    assert load_reader("row_moves_per_query").read(ctx) == 4 / 2


@pytest.mark.parametrize("name", READERS)
def test_no_move_span_reads_nothing(name):
    reader = load_reader(name)
    assert reader.read(_ctx(FakeTracer(SPANS, BUSY))) is None
    assert reader.read(_ctx(None)) is None
    assert reader.read(_ctx(FakeTracer(MOVES, BUSY), answered=0)) is None
