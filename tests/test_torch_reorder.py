"""The port's plan optimizer and join reordering against the JAX package, on
the CPU: q13-q15 under ``ReorderingStrategy``.

The planner pieces (pushdown, pruning, static leaf estimates, the System-R
DP, ``optimize``) are held against their reference twins on the same plans
and the same statistics, field for field; ``optimize`` against every golden
``dp`` entry; the executor against the golden q13-q15 entries on both
local-join paths, and against the JAX ``Executor`` on q13-q15 under
``Reorder(RelJoin)`` and on q20 under ``Reorder(Filtered(RelJoin))``: the
same decisions, rows (``rows_close``: float sums differ in order), exchange
bytes and cardinality trail.
"""

import dataclasses
import enum
import json
import math
from pathlib import Path

import pytest

from repro.core.cost_model import CostParams as JCostParams
from repro.joins.ref import rows_as_set, rows_close
from repro.sql import Executor as JExecutor
from repro.sql import FilteredStrategy as JFilteredStrategy
from repro.sql import RelJoinStrategy as JRelJoinStrategy
from repro.sql import ReorderingStrategy as JReorderingStrategy
from repro.sql import all_queries as j_all_queries
from repro.sql import cyclic_queries as j_cyclic_queries
from repro.sql import default_strategies as j_default_strategies
from repro.sql import filtered_queries as j_filtered_queries
from repro.sql import misordered_queries as j_misordered_queries
from repro.sql import skewed_queries as j_skewed_queries
from repro.sql import text_queries as j_text_queries
from repro.sql import planner as jp
from repro.sql.logical import augment_edges as j_augment_edges
from repro.sql.logical import extract_join_graph as j_extract_join_graph
from repro.sql.logical import signature as j_signature
from repro_torch.core.cost_model import CostParams
from repro_torch.core.stats import StatsSource, TableStats
from repro_torch.sql import (Executor, FilteredStrategy, PlanCache,
                             RelJoinStrategy, ReorderingStrategy, all_queries,
                             cyclic_queries,
                             default_strategies, every_query,
                             filtered_queries, generate, misordered_queries,
                             optimize, signature, skewed_queries,
                             text_queries)
from repro_torch.sql import planner as tp
from repro_torch.sql.logical import augment_edges, extract_join_graph

GOLDEN = json.loads((Path(__file__).parent / "fixtures" / "golden_plans.json"
                     ).read_text())["queries"]
MISORDERED = sorted(misordered_queries())
REORDER = "Reorder(RelJoin(w=1))"


def optimizer_queries():
    """Every query of the golden fixture, q1-q37."""
    return {**every_query(), **skewed_queries(), **filtered_queries(),
            **text_queries(), **cyclic_queries()}


@pytest.fixture(scope="module")
def port_catalog():
    return generate(0.1, 4, 42, device="cpu")


def canon(x):
    """A package-neutral form of planner outputs: dataclasses and enums of
    either package become tuples of their fields and values; NaN equals
    NaN."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, canon(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (list, tuple)):
        return tuple(canon(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((str(k), canon(v)) for k, v in x.items()))
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def port_stats(s) -> TableStats:
    return TableStats(s.size_bytes, s.cardinality,
                      StatsSource(s.source.value), s.skew)


def decisions(res):
    return [{"method": d.selection.method.value,
             "swapped": bool(d.selection.swapped_sides)}
            for d in res.decisions]


def _selection(d):
    sel = d.selection
    # repr: a forced selection quotes a NaN cost, which equals nothing.
    return (sel.method.value, sel.swapped_sides, repr(sel.cost), sel.reason,
            d.left_stats.size_bytes, d.left_stats.cardinality,
            d.right_stats.size_bytes, d.right_stats.cardinality)


# ---------------------------------------------------------------------------
# Queries and strategies
# ---------------------------------------------------------------------------

def test_misordered_plans_equal_reference():
    ref = j_misordered_queries()
    assert sorted(ref) == MISORDERED
    for name, plan in misordered_queries().items():
        assert signature(plan) == j_signature(ref[name]), name
    assert sorted(every_query()) == sorted([*all_queries(), *MISORDERED])


@pytest.mark.parametrize("w", [None, 2.0])
def test_reordering_strategy_equals_reference(w):
    for inner, jinner in zip(default_strategies(), j_default_strategies()):
        got, want = (ReorderingStrategy(inner, w=w),
                     JReorderingStrategy(jinner, w=w))
        assert got.name == want.name
        assert (got.reorder, got.w, got.runtime_filters, got.reopt) == (
            want.reorder, want.w, want.runtime_filters, want.reopt)
    got = ReorderingStrategy(FilteredStrategy(RelJoinStrategy(w=3.0)))
    want = JReorderingStrategy(JFilteredStrategy(JRelJoinStrategy(w=3.0)))
    assert (got.name, got.w, got.runtime_filters, got.filter_kinds) == (
        want.name, want.w, want.runtime_filters, want.filter_kinds)
    assert ReorderingStrategy(reopt=True).name == \
        JReorderingStrategy(reopt=True).name


def test_reopt_through_reordering_strategy_raises(catalog, port_catalog):
    """Named for the guard checkpoint re-optimization had before its slice:
    ``reopt`` now reaches the executor from ``ReorderingStrategy`` or from
    the executor's arguments, as in the reference, and q13 runs with its
    checkpoints audited and the rows of the reopt-off run."""
    for got, want in (
            (Executor(port_catalog, ReorderingStrategy(reopt=True)),
             JExecutor(catalog, JReorderingStrategy(reopt=True))),
            (Executor(port_catalog, RelJoinStrategy(), reorder=True,
                      reopt=True),
             JExecutor(catalog, JRelJoinStrategy(), reorder=True,
                       reopt=True))):
        assert (got.reorder, got.reopt, got.reopt_qerror) == \
            (want.reorder, want.reopt, want.reopt_qerror)
    plan = misordered_queries()["q13_fact_fact_first"]
    res = Executor(port_catalog, ReorderingStrategy(reopt=True),
                   verify=True).execute(plan)
    base = Executor(port_catalog, ReorderingStrategy()).execute(plan)
    assert res.reopts and res.reopt_count == 0
    assert decisions(res) == decisions(base)
    assert res.network_bytes == base.network_bytes
    assert rows_close(rows_as_set(res.table.to_numpy()),
                      rows_as_set(base.table.to_numpy()))


# ---------------------------------------------------------------------------
# The planner against its reference twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("query", sorted(optimizer_queries()))
def test_rewrites_equal_reference(catalog, port_catalog, query):
    plan = optimizer_queries()[query]
    jplan = _reference_plan(query)
    schema, jschema = (tp.catalog_schema(port_catalog),
                       jp.catalog_schema(catalog))
    assert schema == jschema
    pushed = tp.push_down_filters(plan, schema)
    assert signature(pushed) == j_signature(
        jp.push_down_filters(jplan, jschema))
    assert signature(tp.prune_projections(pushed, schema)) == j_signature(
        jp.prune_projections(jp.push_down_filters(jplan, jschema), jschema))
    got = tp.modeled_plan_cost(plan, tp.catalog_base_stats(port_catalog),
                               schema, CostParams(p=4),
                               port_catalog.key_domains,
                               port_catalog.column_stats)
    want = jp.modeled_plan_cost(jplan, jp.catalog_base_stats(catalog),
                                jschema, JCostParams(p=4),
                                catalog.key_domains, catalog.column_stats)
    assert got == want


def _reference_plan(query):
    return {**j_all_queries(), **j_misordered_queries(),
            **j_skewed_queries(), **j_filtered_queries(),
            **j_text_queries(), **j_cyclic_queries()}[query]


@pytest.mark.parametrize("query", sorted(optimizer_queries()))
def test_optimize_equals_golden_dp(port_catalog, query):
    opt = optimize(optimizer_queries()[query], port_catalog)
    assert {"reordered": opt.reordered,
            "signature": signature(opt.plan)} == GOLDEN[query]["dp"]
    assert opt.chosen_cost <= opt.plan_order_cost


@pytest.mark.parametrize("query", MISORDERED)
def test_optimize_regions_equal_reference(catalog, port_catalog, query):
    got = optimize(misordered_queries()[query], port_catalog)
    want = jp.optimize(j_misordered_queries()[query], catalog)
    assert canon(got.regions) == canon(want.regions)
    assert got.reordered


def _region_inputs(catalog, port_catalog, query):
    """Both packages' region graphs of a pushed-down, pruned q13-q15, and
    the reference's static leaf statistics and retain fractions."""
    schema, jschema = (tp.catalog_schema(port_catalog),
                       jp.catalog_schema(catalog))
    plan = tp.prune_projections(tp.push_down_filters(
        misordered_queries()[query], schema), schema)
    jplan = jp.prune_projections(jp.push_down_filters(
        j_misordered_queries()[query], jschema), jschema)
    graph = extract_join_graph(plan.child, schema)
    jgraph = j_extract_join_graph(jplan.child, jschema)
    assert canon(augment_edges(graph)) == canon(j_augment_edges(jgraph))
    jbase = jp.catalog_base_stats(catalog)
    jstats = [jp.estimate_leaf_stats(l, jbase, jschema, catalog.key_domains,
                                     catalog.column_stats)
              for l in jgraph.leaves]
    jretain = [jp.stats_retain_fraction(l, catalog.key_domains,
                                        catalog.column_stats)
               for l in jgraph.leaves]
    base = tp.catalog_base_stats(port_catalog)
    stats = [tp.estimate_leaf_stats(l, base, schema, port_catalog.key_domains,
                                    port_catalog.column_stats)
             for l in graph.leaves]
    assert canon(stats) == canon(jstats)
    return graph, jgraph, jstats, jretain


@pytest.mark.parametrize("bushy", [False, True])
@pytest.mark.parametrize("query", MISORDERED)
def test_enumerate_join_order_equals_reference(catalog, port_catalog, query,
                                               bushy):
    graph, jgraph, jstats, retain = _region_inputs(catalog, port_catalog,
                                                   query)
    stats = [port_stats(s) for s in jstats]
    for p in (4, 8):
        got = tp.enumerate_join_order(stats, retain, augment_edges(graph),
                                      CostParams(p=p), bushy=bushy)
        want = jp.enumerate_join_order(jstats, retain,
                                       j_augment_edges(jgraph),
                                       JCostParams(p=p), bushy=bushy)
        assert canon(got) == canon(want)
        assert got.order() == want.order()
        assert tp.modeled_tree_cost(graph, stats, retain, CostParams(p=p)) \
            == jp.modeled_tree_cost(jgraph, jstats, retain, JCostParams(p=p))
        # The executor's re-planning hook: a pinned probe root.
        for start in range(graph.n):
            got = tp.enumerate_join_order(stats, retain,
                                          augment_edges(graph),
                                          CostParams(p=p), start=start)
            want = jp.enumerate_join_order(jstats, retain,
                                           j_augment_edges(jgraph),
                                           JCostParams(p=p), start=start)
            assert canon(got) == canon(want), start


def test_optimize_later_slice_options_raise(catalog, port_catalog):
    """Named for the guards these options had before their slices:
    ``verify=True`` (the plan-verification slice) and ``plan_cache`` (the
    service slice) now run and give the reference's plan and regions; a
    second call is a hit that returns the stored plan."""
    plan = misordered_queries()["q13_fact_fact_first"]
    got = optimize(plan, port_catalog, verify=True)
    want = jp.optimize(j_misordered_queries()["q13_fact_fact_first"],
                       catalog, verify=True)
    assert signature(got.plan) == j_signature(want.plan)
    assert canon(got.regions) == canon(want.regions)
    cache = PlanCache()
    cold = optimize(plan, port_catalog, plan_cache=cache)
    assert signature(cold.plan) == j_signature(want.plan)
    assert canon(cold.regions) == canon(want.regions)
    assert optimize(plan, port_catalog, plan_cache=cache) is cold
    assert (cache.hits, cache.misses, len(cache)) == (1, 1, 1)


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("query", MISORDERED)
def test_decisions_equal_golden(port_catalog, query, use_kernel):
    plan = misordered_queries()[query]
    gold = GOLDEN[query]["strategies"]
    rows = []
    for s in default_strategies() + [ReorderingStrategy(RelJoinStrategy())]:
        res = Executor(port_catalog, s, use_kernel=use_kernel).execute(plan)
        name = REORDER if isinstance(s, ReorderingStrategy) else s.name
        assert decisions(res) == gold[name], name
        rows.append(rows_as_set(res.table.to_numpy()))
    assert all(rows_close(rows[0], r) for r in rows[1:])


@pytest.mark.parametrize("query", MISORDERED)
def test_every_strategy_reordered_keeps_its_rows(port_catalog, query):
    plan = misordered_queries()[query]
    for s in default_strategies():
        got = Executor(port_catalog, ReorderingStrategy(s)).execute(plan)
        base = Executor(port_catalog, s).execute(plan)
        assert rows_close(rows_as_set(got.table.to_numpy()),
                          rows_as_set(base.table.to_numpy())), s.name
        assert got.rows == base.rows


@pytest.fixture(scope="module")
def reference_runs(catalog):
    """The JAX ``Executor``'s runs this file compares with, computed once
    (each compiles its shapes)."""
    runs = {q: JExecutor(catalog, JReorderingStrategy(JRelJoinStrategy())
                         ).execute(p)
            for q, p in j_misordered_queries().items()}
    q20 = "q20_filter_below_earlier_exchange"
    runs[q20] = JExecutor(catalog, JReorderingStrategy(
        JFilteredStrategy(JRelJoinStrategy()))).execute(
        j_filtered_queries()[q20])
    return runs


def assert_same_run(got, want):
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


@pytest.mark.parametrize("query", MISORDERED)
def test_reordered_execution_equals_reference(port_catalog, reference_runs,
                                              query):
    plan = misordered_queries()[query]
    want = reference_runs[query]
    strat = ReorderingStrategy(RelJoinStrategy())
    assert_same_run(Executor(port_catalog, strat).execute(plan), want)
    # The kernel path (plain versions on the CPU) gives the same run.
    kern = Executor(port_catalog, strat, use_kernel=True).execute(plan)
    assert decisions(kern) == decisions(want)
    assert kern.network_bytes == want.network_bytes
    assert rows_close(rows_as_set(kern.table.to_numpy()),
                      rows_as_set(want.table.to_numpy()))


def test_reordered_filtered_q20_equals_reference(port_catalog,
                                                 reference_runs):
    """``Reorder(Filtered(RelJoin))``: the region filters run before the
    DP, which orders the region on post-filter statistics."""
    q20 = "q20_filter_below_earlier_exchange"
    want = reference_runs[q20]
    got = Executor(port_catalog, ReorderingStrategy(FilteredStrategy(
        RelJoinStrategy()))).execute(filtered_queries()[q20])
    assert_same_run(got, want)
    assert [(canon(f.plan), f.rows_before, f.rows_after, f.cached)
            for f in got.filters] == \
        [(canon(f.plan), f.rows_before, f.rows_after, f.cached)
         for f in want.filters]
    assert got.filters
