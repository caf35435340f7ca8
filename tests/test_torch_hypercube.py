"""The port's hypercube path against the JAX package, on the CPU: q35-q37
under ``ReorderingStrategy``.

Bottom to top: the fused three-way probe's plain version (``tiled_probe3``)
bit for bit against the reference's interpret-mode Pallas kernel; the
hypercube exchange's received slots and ``ExchangeReport`` for a flat cube,
a 2x4 cube and cubes with replicated axes; the multi-way join on both of
its branches against the numpy oracle and the reference function; the
hypercube planner on the reference's own inputs; and the executor against
the golden q35-q37 entries on both local-join paths and against the JAX
``Executor`` (rows within ``rows_close``, bytes and decisions exactly).
"""

import dataclasses
import enum
import json
import math
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cost_model import CostParams as JCostParams
from repro.joins import from_numpy as j_from_numpy
from repro.joins import partition_round_robin as j_partition_round_robin
from repro.joins.exchange import hypercube_shuffle as j_hypercube_shuffle
from repro.joins.methods import HypercubeLink as JHypercubeLink
from repro.joins.methods import HypercubeSpec as JHypercubeSpec
from repro.joins.methods import \
    hypercube_multiway_join as j_hypercube_multiway_join
from repro.joins.ref import ref_multiway_join, rows_as_set, rows_close
from repro.kernels.tiled_probe import tiled_probe3 as j_tiled_probe3
from repro.sql import Executor as JExecutor
from repro.sql import RelJoinStrategy as JRelJoinStrategy
from repro.sql import ReorderingStrategy as JReorderingStrategy
from repro.sql import cyclic_queries as j_cyclic_queries
from repro.sql import planner as jp
from repro.sql.logical import augment_edges as j_augment_edges
from repro.sql.logical import extract_join_graph as j_extract_join_graph
from repro.sql.logical import leaf_columns as j_leaf_columns
from repro.sql.logical import signature as j_signature
from repro_torch.core.cost_model import CostParams, JoinMethod
from repro_torch.core.stats import StatsSource, TableStats
from repro_torch.joins import (HypercubeLink, HypercubeSpec, from_numpy,
                               hypercube_multiway_join, hypercube_shuffle,
                               partition_round_robin)
from repro_torch.joins import methods as t_methods
from repro_torch.kernels import ref
from repro_torch.kernels.tiled_probe import tiled_probe3
from repro_torch.sql import (Executor, RelJoinStrategy, ReorderingStrategy,
                             cyclic_queries, default_strategies, generate,
                             signature)
from repro_torch.sql import planner as tp
from repro_torch.sql.logical import augment_edges, extract_join_graph
from repro_torch.sql.logical import leaf_columns

GOLDEN = json.loads((Path(__file__).parent / "fixtures" / "golden_plans.json"
                     ).read_text())["queries"]
CYCLIC = sorted(cyclic_queries())
REORDER = "Reorder(RelJoin(w=1))"
I32 = np.iinfo(np.int32)


@pytest.fixture(scope="module")
def port_catalog():
    return generate(0.1, 4, 42, device="cpu")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def canon(x):
    """A package-neutral form of planner outputs (dataclasses and enums of
    either package as tuples of their fields and values; NaN equals
    NaN)."""
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


def decisions(res):
    return [{"method": d.selection.method.value,
             "swapped": bool(d.selection.swapped_sides)}
            for d in res.decisions]


# ---------------------------------------------------------------------------
# K7: the fused three-way probe's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

def probe3_case(na, nb, nc, seed):
    """Keys with duplicates (first match matters), the sentinels -1 and -2,
    and the ends of the int32 range on every side."""
    rng = np.random.default_rng(seed)
    hi = max(nb, nc) // 2 + 2
    keys = [rng.integers(-2, hi, n).astype(np.int32) for n in (na, na, nb,
                                                               nc)]
    for k in keys:
        k[:4] = [-1, -2, I32.min, I32.max][:len(k[:4])]
    return keys


@pytest.mark.parametrize("na,nb,nc", [(1, 1, 1), (7, 3, 130),
                                      (257, 129, 5), (600, 700, 300)])
def test_probe3_plain_equals_reference_kernel(na, nb, nc):
    a1, a2, b, c = probe3_case(na, nb, nc, seed=na + nb + nc)
    w1, w2 = (np.asarray(o) for o in j_tiled_probe3(
        jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(b), jnp.asarray(c),
        interpret=True))
    g1, g2 = tiled_probe3(t(a1), t(a2), t(b), t(c))
    np.testing.assert_array_equal(g1.numpy(), w1)
    np.testing.assert_array_equal(g2.numpy(), w2)
    # The batched form: every row on its own builds.
    r1, r2 = tiled_probe3(t(np.stack([a1, a2])), t(np.stack([a2, a1])),
                          t(np.stack([b, b])), t(np.stack([c, c])))
    np.testing.assert_array_equal(r1[0].numpy(), w1)
    np.testing.assert_array_equal(r2[0].numpy(), w2)
    assert r1.dtype == torch.int32 and r1.shape == (2, na)


def test_probe3_sentinels_and_first_match():
    out1, out2 = ref.tiled_probe3_ref(
        t(np.array([[5, -1, 9, -2]], np.int32)),
        t(np.array([[-1, 4, 4, 7]], np.int32)),
        t(np.array([[1, 5, -1, 5, -2]], np.int32)),
        t(np.array([[4, -1, 4]], np.int32)))
    # A probe -1 meets a valid build -1; build -2 pads never meet a probe -1.
    assert out1.tolist() == [[1, 2, -1, 4]]
    assert out2.tolist() == [[1, 0, 0, -1]]


def test_probe3_wrapper_checks_and_empty_builds():
    a = t(np.array([[3, 4]], np.int32))
    with pytest.raises(TypeError):
        tiled_probe3(a.long(), a, a, a)
    with pytest.raises(ValueError):
        tiled_probe3(a, a[0], a, a)
    with pytest.raises(ValueError):
        tiled_probe3(a, a, t(np.zeros((2, 3), np.int32)), a)
    empty = torch.zeros((1, 0), dtype=torch.int32)
    o1, o2 = tiled_probe3(a, a, empty, a)
    assert o1.tolist() == [[-1, -1]] and o2.tolist() == [[0, 1]]


# ---------------------------------------------------------------------------
# The hypercube exchange
# ---------------------------------------------------------------------------

def exchange_table(n=300, seed=3):
    rng = np.random.default_rng(seed)
    return {"ka": rng.integers(-50, 1000, n).astype(np.int32),
            "kb": rng.integers(0, 40, n).astype(np.int32),
            "v": rng.random(n).astype(np.float32)}


def report_fields(ex):
    return (ex.kind, ex.network_bytes, ex.local_bytes, ex.overflow_rows,
            ex.elided, ex.straggler_bytes)


@pytest.mark.parametrize("dims,axis_keys", [
    ((8, 1), ((0, "ka"),)),                   # flat: a plain key shuffle
    ((2, 4), ((0, "ka"), (1, "kb"))),         # owns both axes, f = 1
    ((2, 4), ((1, "kb"),)),                   # axis 0 replicated, f = 2
    ((2, 2, 2), ((1, "ka"),)),                # two free axes, f = 4
    ((4, 2), ()),                             # owns nothing: f = p
])
def test_hypercube_shuffle_equals_reference(dims, axis_keys):
    cols = exchange_table()
    got, gex = hypercube_shuffle(
        partition_round_robin(from_numpy(cols, 320, device="cpu"), 8),
        dims, axis_keys, capacity_factor=2.0)
    want, wex = j_hypercube_shuffle(
        j_partition_round_robin(j_from_numpy(cols, 320), 8), dims,
        axis_keys, capacity_factor=2.0)
    assert report_fields(gex) == report_fields(wex)
    assert gex.kind == "hypercube" and gex.overflow_rows == 0
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for name in cols:
        np.testing.assert_array_equal(got.column(name).numpy(),
                                      np.asarray(want.column(name)))
    f = 8 // math.prod(dims[ax] for ax, _ in axis_keys)
    assert got.count() == f * len(cols["ka"])


def test_hypercube_shuffle_rejects_bad_cubes():
    table = partition_round_robin(from_numpy(exchange_table(), 320,
                                             device="cpu"), 8)
    with pytest.raises(ValueError):
        hypercube_shuffle(table, (2, 2), ((0, "ka"),))
    with pytest.raises(ValueError):
        hypercube_shuffle(table, (2, 4), ((2, "ka"),))


# ---------------------------------------------------------------------------
# The multi-way join, both branches
# ---------------------------------------------------------------------------

def triangle_tables():
    """The reference's triangle: R(ra, rb) probes S by rb and T by ra; the
    closing check s_c = t_c rides on the joined row."""
    rng = np.random.default_rng(zlib.crc32(b"hc-dist"))
    r = {"ra": rng.integers(0, 20, 160).astype(np.int32),
         "rb": rng.integers(0, 24, 160).astype(np.int32),
         "v": np.arange(160, dtype=np.int32)}
    s = {"sb": np.arange(24, dtype=np.int32),
         "s_c": rng.integers(0, 4, 24).astype(np.int32)}
    u = {"ta": np.arange(20, dtype=np.int32),
         "t_c": rng.integers(0, 4, 20).astype(np.int32)}
    axis_keys = (((0, "ra"), (1, "rb")), ((1, "sb"),), ((0, "ta"),))
    links = ((1, "rb", "sb"), (2, "ra", "ta"))
    return (r, s, u), axis_keys, links, (("s_c", "t_c"),)


def chain_tables():
    """A chained probe: the second link looks up a column the first link
    gathered, so the fused branch does not apply."""
    (r, s, _), _, _, _ = triangle_tables()
    w = {"wc": np.arange(4, dtype=np.int32),
         "w_v": np.array([10, 11, 12, 13], np.int32)}
    axis_keys = (((0, "rb"),), ((0, "sb"), (1, "s_c")), ((1, "wc"),))
    links = ((1, "rb", "sb"), (2, "s_c", "wc"))
    return (r, s, w), axis_keys, links, ()


def run_both(cols, axis_keys, links, checks, dims, use_kernel,
             port_kernel):
    got, grep = hypercube_multiway_join(
        [partition_round_robin(from_numpy(c, 192, device="cpu"), 8)
         for c in cols],
        HypercubeSpec(dims, axis_keys,
                      tuple(HypercubeLink(*lk) for lk in links), checks),
        capacity_factor=4.0, use_kernel=port_kernel)
    want, wrep = j_hypercube_multiway_join(
        [j_partition_round_robin(j_from_numpy(c, 192), 8) for c in cols],
        JHypercubeSpec(dims, axis_keys,
                       tuple(JHypercubeLink(*lk) for lk in links), checks),
        capacity_factor=4.0, use_kernel=use_kernel)
    return got, grep, want, wrep


@pytest.mark.parametrize("dims", [(2, 4), (8, 1)])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_multiway_join_equals_reference_and_oracle(dims, use_kernel):
    """``use_kernel`` takes the fused branch on both sides (K7's plain
    version here, the interpret-mode Pallas kernel there); without it both
    run the per-link gather-path hash joins."""
    cols, axis_keys, links, checks = triangle_tables()
    got, grep, want, wrep = run_both(cols, axis_keys, links, checks, dims,
                                     use_kernel, use_kernel)
    oracle = rows_as_set(ref_multiway_join(cols, links, checks))
    assert rows_as_set(got.to_numpy()) == oracle
    assert rows_as_set(want.to_numpy()) == oracle
    assert len(oracle) > 0
    assert grep.method is JoinMethod.HYPERCUBE_SHUFFLE
    assert grep.method.value == wrep.method.value
    assert [report_fields(e) for e in grep.exchanges] == \
        [report_fields(e) for e in wrep.exchanges]
    assert (grep.local_bytes, grep.output_rows) == \
        (wrep.local_bytes, wrep.output_rows)


@pytest.mark.parametrize("port_kernel", [False, True])
def test_per_link_branch_equals_reference_and_oracle(port_kernel):
    """A chained link keeps the per-link branch; with ``use_kernel`` the
    port's hash joins take their kernel path (K2's plain version). The
    reference runs its gather path: its kernel path drops probe rows of a
    full radix bucket (ROADMAP.md section 3), and these keys fill buckets."""
    cols, axis_keys, links, checks = chain_tables()
    got, grep, want, wrep = run_both(cols, axis_keys, links, checks, (2, 4),
                                     False, port_kernel)
    oracle = rows_as_set(ref_multiway_join(cols, links, checks))
    assert rows_as_set(got.to_numpy()) == oracle == \
        rows_as_set(want.to_numpy())
    assert [report_fields(e) for e in grep.exchanges] == \
        [report_fields(e) for e in wrep.exchanges]
    assert (grep.local_bytes, grep.output_rows) == \
        (wrep.local_bytes, wrep.output_rows)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_multiway_join_refuses_duplicate_columns(use_kernel):
    (r, s, u), axis_keys, links, checks = triangle_tables()
    u = {**u, "s_c": u["t_c"]}
    tables = [partition_round_robin(from_numpy(c, 192, device="cpu"), 8)
              for c in (r, s, u)]
    spec = HypercubeSpec((2, 4), axis_keys,
                         tuple(HypercubeLink(*lk) for lk in links), checks)
    with pytest.raises(ValueError, match="duplicate column"):
        hypercube_multiway_join(tables, spec, use_kernel=use_kernel)


# ---------------------------------------------------------------------------
# The hypercube planner on the reference's own inputs
# ---------------------------------------------------------------------------

def closing_edges(plan, schema, leaf_cols, extract):
    """The cyclic region under a query's eqcol filters, and its closing
    edges as ``((leaf, col), (leaf, col))`` pairs (the executor's rule)."""
    node = plan.child
    eqcols = []
    while getattr(node, "op", None) == "eqcol":
        eqcols.append(node)
        node = node.child
    graph = extract(node, schema)
    cols = [frozenset(leaf_cols(leaf, schema)) for leaf in graph.leaves]

    def owner(col):
        return next(i for i in range(graph.n) if col in cols[i])

    closing = [((owner(f.column), f.column),
                (owner(str(f.column2)), str(f.column2))) for f in eqcols]
    return graph, closing


@pytest.mark.parametrize("query", CYCLIC)
def test_planner_equals_reference_on_cyclic_regions(catalog, port_catalog,
                                                    query):
    schema, jschema = (tp.catalog_schema(port_catalog),
                       jp.catalog_schema(catalog))
    plan = tp.prune_projections(tp.push_down_filters(
        cyclic_queries()[query], schema), schema)
    jplan = jp.prune_projections(jp.push_down_filters(
        j_cyclic_queries()[query], jschema), jschema)
    assert signature(plan) == j_signature(jplan)
    graph, closing = closing_edges(plan, schema, leaf_columns,
                                   extract_join_graph)
    jgraph, jclosing = closing_edges(jplan, jschema, j_leaf_columns,
                                     j_extract_join_graph)
    assert closing == jclosing
    jbase = jp.catalog_base_stats(catalog)
    jstats = [jp.estimate_leaf_stats(l, jbase, jschema, catalog.key_domains,
                                     catalog.column_stats)
              for l in jgraph.leaves]
    retain = [jp.stats_retain_fraction(l, catalog.key_domains,
                                       catalog.column_stats)
              for l in jgraph.leaves]
    stats = [TableStats(s.size_bytes, s.cardinality,
                        StatsSource(s.source.value), s.skew) for s in jstats]
    base = tp.catalog_base_stats(port_catalog)
    assert canon([tp.estimate_leaf_stats(l, base, schema,
                                         port_catalog.key_domains,
                                         port_catalog.column_stats)
                  for l in graph.leaves]) == canon(jstats)
    n_plans = 0
    for p in (4, 8):
        params, jparams = CostParams(p=p), JCostParams(p=p)
        order = tp.enumerate_join_order(stats, retain, augment_edges(graph),
                                        params)
        jorder = jp.enumerate_join_order(jstats, retain,
                                         j_augment_edges(jgraph), jparams)
        assert canon(order) == canon(jorder)
        binary = tp.modeled_tree_cost(graph, stats, retain, params)
        assert binary == jp.modeled_tree_cost(jgraph, jstats, retain,
                                              jparams)
        binary = min(binary, order.cost)
        # The real quote, and one against a binary plan ten times dearer,
        # which the cube wins.
        for quote in (binary, 10 * binary):
            got = tp.plan_hypercube(graph, closing, stats, quote, params)
            want = jp.plan_hypercube(jgraph, jclosing, jstats, quote,
                                     jparams)
            assert canon(got) == canon(want)
            n_plans += got is not None
    assert n_plans >= 2


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------

def test_cyclic_plans_equal_reference():
    ref_plans = j_cyclic_queries()
    assert sorted(ref_plans) == CYCLIC
    for name, plan in cyclic_queries().items():
        assert signature(plan) == j_signature(ref_plans[name]), name


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("query", CYCLIC)
def test_decisions_equal_golden(port_catalog, query, use_kernel):
    plan = cyclic_queries()[query]
    gold = GOLDEN[query]["strategies"]
    rows = []
    for s in default_strategies() + [ReorderingStrategy(RelJoinStrategy())]:
        res = Executor(port_catalog, s, use_kernel=use_kernel).execute(plan)
        name = REORDER if isinstance(s, ReorderingStrategy) else s.name
        assert decisions(res) == gold[name], name
        rows.append(rows_as_set(res.table.to_numpy()))
    assert all(rows_close(rows[0], r) for r in rows[1:])


def test_fused_branch_runs_on_the_kernel_path(port_catalog, monkeypatch):
    """q35 and q36 (two links) resolve both links in one ``probe3`` call on
    the kernel path (once per capacity attempt: an exchange that overflows
    runs again at twice the slots); q37 (three links) takes the per-link
    branch."""
    calls = []
    real = t_methods.kops.probe3
    monkeypatch.setattr(t_methods.kops, "probe3",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    strat = ReorderingStrategy(RelJoinStrategy())
    for query, fused in (("q35_triangle", True),
                         ("q36_triangle_shared_axis", True),
                         ("q37_four_clique", False)):
        before = len(calls)
        res = Executor(port_catalog, strat, use_kernel=True).execute(
            cyclic_queries()[query])
        assert res.methods() == [JoinMethod.HYPERCUBE_SHUFFLE]
        assert (len(calls) > before) == fused, query
    assert all(shape[0] == port_catalog.p for shape in calls)


@pytest.mark.parametrize("query", CYCLIC)
def test_every_strategy_reordered_keeps_its_rows(port_catalog, query):
    plan = cyclic_queries()[query]
    for s in default_strategies():
        got = Executor(port_catalog, ReorderingStrategy(s)).execute(plan)
        base = Executor(port_catalog, s).execute(plan)
        binary = Executor(port_catalog, ReorderingStrategy(s),
                          hypercube=False).execute(plan)
        assert JoinMethod.HYPERCUBE_SHUFFLE not in binary.methods()
        for other in (base, binary):
            assert rows_close(rows_as_set(got.table.to_numpy()),
                              rows_as_set(other.table.to_numpy())), s.name
            assert got.rows == other.rows


#: (query, hypercube) runs held against the JAX ``Executor``.
REFERENCE_RUNS = [("q35_triangle", True), ("q35_triangle", False),
                  ("q36_triangle_shared_axis", True),
                  ("q37_four_clique", True)]


@pytest.fixture(scope="module")
def reference_runs(catalog):
    """The JAX ``Executor``'s runs (its default gather path), computed once:
    each compiles its shapes."""
    strat = JReorderingStrategy(JRelJoinStrategy())
    return {(q, hc): JExecutor(catalog, strat, hypercube=hc).execute(
        j_cyclic_queries()[q]) for q, hc in REFERENCE_RUNS}


def _selection(d):
    sel = d.selection
    return (sel.method.value, sel.swapped_sides, repr(sel.cost), sel.reason,
            d.left_stats.size_bytes, d.left_stats.cardinality,
            d.right_stats.size_bytes, d.right_stats.cardinality)


@pytest.mark.parametrize("query,hypercube", REFERENCE_RUNS)
def test_execution_equals_reference(port_catalog, reference_runs, query,
                                    hypercube):
    want = reference_runs[(query, hypercube)]
    got = Executor(port_catalog, ReorderingStrategy(RelJoinStrategy()),
                   hypercube=hypercube).execute(cyclic_queries()[query])
    assert [_selection(d) for d in got.decisions] == \
        [_selection(d) for d in want.decisions]
    assert [[report_fields(e) for e in d.report.exchanges]
            for d in got.decisions] == \
        [[report_fields(e) for e in d.report.exchanges]
         for d in want.decisions]
    assert got.rows == want.rows
    assert got.network_bytes == want.network_bytes
    assert got.local_bytes == want.local_bytes
    assert got.straggler_bytes == want.straggler_bytes
    assert ([(c.kind, c.estimated, c.measured) for c in got.cardinalities]
            == [(c.kind, c.estimated, c.measured)
                for c in want.cardinalities])
    assert rows_close(rows_as_set(got.table.to_numpy()),
                      rows_as_set(want.table.to_numpy()))
    assert (JoinMethod.HYPERCUBE_SHUFFLE in got.methods()) == hypercube
