"""The rest of the query suite on the port's executor, on the CPU: the skew
targets q16-q18 and the text-only queries q24-q34, parsed from SQL text.

Against the golden fixture (every decision of the four default strategies,
on both local-join paths; on the CPU the kernels run as their plain
versions; ``tests/test_torch_reorder.py`` holds ``optimize`` against the
``dp`` entries of all 37 queries), and against the JAX ``Executor`` on the
queries whose shapes the earlier suites lack: q26 (LEFT JOIN, a dimension
preserved against an aggregated fact), q27 and q28 (semi and anti joins
whose build is an aggregate), q32 (AVG under SUM, compared with
``rows_close``: float sums differ in order). The same decisions, rows,
exchange bytes and cardinality trail, under RelJoin and ShuffleSort.
"""

import json
from pathlib import Path

import pytest

from repro.joins.ref import rows_as_set, rows_close
from repro.sql import Executor as JExecutor
from repro.sql import default_strategies as j_default_strategies
from repro.sql import text_queries as j_text_queries
from repro_torch.sql import (Executor, default_strategies, generate,
                             skewed_queries, text_queries)

GOLDEN = json.loads((Path(__file__).parent / "fixtures" / "golden_plans.json"
                     ).read_text())["queries"]


def suite():
    """q16-q18 and q24-q34: the queries the earlier suites leave out."""
    return {**skewed_queries(), **text_queries()}


QUERIES = sorted(suite())
#: The text-only shapes held against the JAX Executor, and the strategies.
REFERENCE_QUERIES = ("q26_outer_agg", "q27_semi_rich", "q28_anti_catalog",
                     "q32_inventory_turns")
REFERENCE_STRATEGIES = ("RelJoin(w=1)", "ShuffleSort")


@pytest.fixture(scope="module")
def port_catalog():
    return generate(0.1, 4, 42, device="cpu")


def decisions(res):
    return [{"method": d.selection.method.value,
             "swapped": bool(d.selection.swapped_sides)}
            for d in res.decisions]


def test_suite_is_the_fourteen_missing_queries():
    assert len(QUERIES) == 14
    assert all(q in GOLDEN for q in QUERIES)
    assert QUERIES[:3] == ["q16_hot_customer", "q17_hot_customer_star",
                           "q18_hot_catalog_customer"]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("query", QUERIES)
def test_decisions_equal_golden(port_catalog, query, use_kernel):
    plan = suite()[query]
    rows = []
    for s in default_strategies():
        res = Executor(port_catalog, s, use_kernel=use_kernel).execute(plan)
        assert decisions(res) == GOLDEN[query]["strategies"][s.name], s.name
        rows.append(rows_as_set(res.table.to_numpy()))
    # Every join method gives the same result.
    assert all(rows_close(rows[0], r) for r in rows[1:])


def _selection(d):
    sel = d.selection
    # repr: a forced selection quotes a NaN cost, which equals nothing.
    return (sel.method.value, sel.swapped_sides, repr(sel.cost), sel.reason,
            d.left_stats.size_bytes, d.left_stats.cardinality,
            d.right_stats.size_bytes, d.right_stats.cardinality)


@pytest.fixture(scope="module")
def reference_runs(catalog):
    """The JAX ``Executor``'s runs this file compares with, computed once
    (each compiles its shapes)."""
    plans = j_text_queries()
    strategies = {s.name: s for s in j_default_strategies()}
    return {(q, s): JExecutor(catalog, strategies[s]).execute(plans[q])
            for q in REFERENCE_QUERIES for s in REFERENCE_STRATEGIES}


@pytest.mark.parametrize("strategy", REFERENCE_STRATEGIES)
@pytest.mark.parametrize("query", REFERENCE_QUERIES)
def test_execution_equals_reference(port_catalog, reference_runs, query,
                                    strategy):
    want = reference_runs[(query, strategy)]
    tstrat = {s.name: s for s in default_strategies()}[strategy]
    plan = text_queries()[query]
    for use_kernel in (False, True):
        got = Executor(port_catalog, tstrat,
                       use_kernel=use_kernel).execute(plan)
        assert [_selection(d) for d in got.decisions] == \
            [_selection(d) for d in want.decisions], use_kernel
        assert got.rows == want.rows
        assert got.network_bytes == want.network_bytes
        assert got.local_bytes == want.local_bytes
        assert got.straggler_bytes == want.straggler_bytes
        assert ([(c.kind, c.estimated, c.measured)
                 for c in got.cardinalities]
                == [(c.kind, c.estimated, c.measured)
                    for c in want.cardinalities])
        assert rows_close(rows_as_set(got.table.to_numpy()),
                          rows_as_set(want.table.to_numpy())), use_kernel


def test_outer_join_pads_unmatched_customers(port_catalog):
    """q26: every customer survives the LEFT JOIN; those with no sale carry
    zeros in the aggregated fact's columns, so each region's SUM is the
    sum over its matched customers alone."""
    from repro_torch.sql.logical import Join
    plan = text_queries()["q26_outer_agg"]
    join = plan.child
    assert isinstance(join, Join)
    res = Executor(port_catalog, default_strategies()[3]).execute(join)
    cols = res.table.to_numpy()
    n_customers = port_catalog.tables["customer"].count()
    assert res.rows == n_customers
    matched = cols["ss_customer_sk_matched"].astype(bool)
    assert not matched.all() and matched.any()
    assert (cols["sum_ss_net_profit"][~matched] == 0).all()
