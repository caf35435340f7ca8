"""The port's executor on the main path: q1-q12 under the four paper
strategies.

Against the golden fixture (every query and strategy, on both local-join
paths), and against the JAX ``Executor`` on a few queries that together
cover broadcast, shuffle hash, sort join, semi and anti joins: the same
decisions, rows (``rows_close``: float sums differ in order), exchange
bytes and cardinality trail.
"""

import json
from pathlib import Path

import pytest

from repro.joins.ref import rows_as_set, rows_close
from repro.sql import Executor as JExecutor
from repro.sql import RelJoinStrategy as JRelJoinStrategy
from repro.sql import all_queries as j_all_queries
from repro.sql import default_strategies as j_default_strategies
from repro.sql.logical import signature as j_signature
from repro_torch.sql import (Executor, all_queries, default_strategies,
                             generate, signature)
from repro_torch.sql.strategies import RelJoinStrategy

GOLDEN = json.loads((Path(__file__).parent / "fixtures" / "golden_plans.json"
                     ).read_text())["queries"]
QUERIES = sorted(all_queries())


@pytest.fixture(scope="module")
def port_catalog():
    return generate(0.1, 4, 42, device="cpu")


def decisions(res):
    return [{"method": d.selection.method.value,
             "swapped": bool(d.selection.swapped_sides)}
            for d in res.decisions]


def test_query_plans_equal_reference():
    ref = j_all_queries()
    assert sorted(ref) == QUERIES
    for name, plan in all_queries().items():
        assert signature(plan) == j_signature(ref[name]), name


def test_strategy_names_equal_reference():
    assert ([s.name for s in default_strategies()]
            == [s.name for s in j_default_strategies()])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("query", QUERIES)
def test_decisions_equal_golden(port_catalog, query, use_kernel):
    plan = all_queries()[query]
    rows = []
    for s in default_strategies():
        res = Executor(port_catalog, s, use_kernel=use_kernel).execute(plan)
        assert decisions(res) == GOLDEN[query]["strategies"][s.name], s.name
        assert res.wall_time_s > 0
        rows.append(rows_as_set(res.table.to_numpy()))
    # Every join method gives the same result.
    assert all(rows_close(rows[0], r) for r in rows[1:])


def _selection(d):
    sel = d.selection
    # repr: a forced selection quotes a NaN cost, which equals nothing.
    return (sel.method.value, sel.swapped_sides, repr(sel.cost), sel.reason,
            d.left_stats.size_bytes, d.left_stats.cardinality,
            d.right_stats.size_bytes, d.right_stats.cardinality)


@pytest.mark.parametrize("query,strategy", [
    ("q1_star3", "RelJoin(w=1)"), ("q3_cross_channel", "RelJoin(w=1)"),
    ("q8_semi", "RelJoin(w=1)"), ("q12_anti", "RelJoin(w=1)"),
    ("q3_cross_channel", "ShuffleSort")])
def test_execution_equals_reference(catalog, port_catalog, query, strategy):
    jstrat = {s.name: s for s in j_default_strategies()}[strategy]
    tstrat = {s.name: s for s in default_strategies()}[strategy]
    want = JExecutor(catalog, jstrat).execute(j_all_queries()[query])
    got = Executor(port_catalog, tstrat).execute(all_queries()[query])
    assert [_selection(d) for d in got.decisions] == \
        [_selection(d) for d in want.decisions]
    assert got.rows == want.rows
    assert got.network_bytes == want.network_bytes
    assert got.local_bytes == want.local_bytes
    assert got.straggler_bytes == want.straggler_bytes
    assert ([(c.kind, c.estimated, c.measured) for c in got.cardinalities]
            == [(c.kind, c.estimated, c.measured)
                for c in want.cardinalities])
    assert rows_close(rows_as_set(got.table.to_numpy()),
                      rows_as_set(want.table.to_numpy()))
    # The kernel path (plain versions on the CPU) gives the same run.
    kern = Executor(port_catalog, tstrat, use_kernel=True).execute(
        all_queries()[query])
    assert kern.network_bytes == want.network_bytes
    assert rows_close(rows_as_set(kern.table.to_numpy()),
                      rows_as_set(want.table.to_numpy()))


@pytest.mark.parametrize("flag", ["verify", "reopt"])
def test_later_slice_options_raise(catalog, port_catalog, flag):
    """Named for the guards these options had before their slice: each now
    runs, and reaches the executor from its argument or from the strategy
    as it does in the reference. On q1 (no reorderable region without
    ``reorder``) the run equals the option-off run."""
    plan = all_queries()["q1_star3"]
    base = Executor(port_catalog, RelJoinStrategy()).execute(plan)
    strat, jstrat = RelJoinStrategy(), JRelJoinStrategy()
    setattr(strat, flag, True)
    setattr(jstrat, flag, True)
    for got, want in (
            (Executor(port_catalog, RelJoinStrategy(), **{flag: True}),
             JExecutor(catalog, JRelJoinStrategy(), **{flag: True})),
            (Executor(port_catalog, strat), JExecutor(catalog, jstrat)),
            (Executor(port_catalog, strat, **{flag: False}),
             JExecutor(catalog, jstrat, **{flag: False}))):
        assert getattr(got, flag) is getattr(want, flag)
        assert got.reopt_qerror == want.reopt_qerror
        res = got.execute(plan)
        assert decisions(res) == decisions(base)
        assert res.network_bytes == base.network_bytes
        assert res.reopts == []
        assert rows_close(rows_as_set(res.table.to_numpy()),
                          rows_as_set(base.table.to_numpy()))


def test_reorder_option_runs(port_catalog):
    """``reorder=True`` (the reordering slice) runs: pushdown, pruning and
    the DP on q1, with the rows of the written order."""
    plan = all_queries()["q1_star3"]
    got = Executor(port_catalog, RelJoinStrategy(), reorder=True)
    assert got.reorder and got.hypercube
    res, base = (got.execute(plan),
                 Executor(port_catalog, RelJoinStrategy()).execute(plan))
    assert res.rows == base.rows
    assert rows_close(rows_as_set(res.table.to_numpy()),
                      rows_as_set(base.table.to_numpy()))


def test_shared_intermediates_raise(port_catalog):
    """Named for the guard ``intermediates`` had before the service
    slice: an injected table now stands in for the Join or Aggregate whose
    signature keys it (no join runs, no byte moves), and a key that
    matches no node changes nothing."""
    plan = all_queries()["q1_star3"]
    base = Executor(port_catalog, RelJoinStrategy()).execute(plan)
    inner = Executor(port_catalog, RelJoinStrategy()).execute(plan.child)
    got = Executor(port_catalog, RelJoinStrategy(),
                   intermediates={signature(plan.child): inner.table}
                   ).execute(plan)
    assert got.decisions == [] and got.network_bytes == 0.0
    assert rows_close(rows_as_set(got.table.to_numpy()),
                      rows_as_set(base.table.to_numpy()))
    t = port_catalog.tables["item"]
    other = Executor(port_catalog, RelJoinStrategy(),
                     intermediates={"x": t}).execute(plan)
    assert decisions(other) == decisions(base)
    assert other.network_bytes == base.network_bytes


def test_default_local_join_path_follows_the_device(port_catalog):
    assert Executor(port_catalog, RelJoinStrategy()).use_kernel is False
    assert Executor(port_catalog, RelJoinStrategy(),
                    use_kernel=True).use_kernel is True
