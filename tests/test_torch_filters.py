"""The port's runtime-filter path against the JAX package, on the CPU.

The filter kernels' plain versions (bloom build and probe, key range) are
held bit for bit against the reference's interpret-mode Pallas kernels at
small sizes and against its numpy oracles at larger ones; the key-set
helpers, filter kinds, planner and cache against their reference twins; and
q19-q23 under ``FilteredStrategy`` against a few JAX ``Executor`` runs: the
same filters, methods, bytes and rows. The port's own runs then cover every
(query, strategy) pair, the warm cache and the LEFT_OUTER padding path.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import psts as j_psts
from repro.core.cost_model import CostParams as JCostParams
from repro.core.selection import JoinType as JJoinType
from repro.core.stats import TableStats as JTableStats
from repro.joins.ref import rows_as_set, rows_close
from repro.kernels import bloom as j_bloom
from repro.kernels import zone_map as j_zone_map
from repro.sql import Executor as JExecutor
from repro.sql import FilterCache as JFilterCache
from repro.sql import FilteredStrategy as JFilteredStrategy
from repro.sql import ReorderingStrategy as JReorderingStrategy
from repro.sql import default_strategies as j_default_strategies
from repro.sql import filtered_queries as j_filtered_queries
from repro.sql import logical as jl
from repro.sql import runtime_filters as j_rf
from repro.sql.datagen import Catalog as JCatalog
from repro.sql.planner import plan_runtime_filters as j_plan_runtime_filters
from repro_torch.core import psts
from repro_torch.core.cost_model import CostParams
from repro_torch.core.selection import JoinType
from repro_torch.core.stats import TableStats
from repro_torch.kernels import ref
from repro_torch.kernels.bloom import bloom_build, bloom_probe
from repro_torch.kernels.zone_map import key_range, merge_ranges, range_probe
from repro_torch.sql import (Catalog, Executor, FilterCache, FilteredStrategy,
                             ReorderingStrategy, default_strategies,
                             filtered_queries, generate, payload_from_numpy,
                             signature)
from repro_torch.sql import logical as tl
from repro_torch.sql import runtime_filters as t_rf
from repro_torch.sql.planner import plan_runtime_filters

GOLDEN = json.loads((Path(__file__).parent / "fixtures" / "golden_plans.json"
                     ).read_text())["queries"]
FILTERED = sorted(filtered_queries())

I32 = np.iinfo(np.int32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def words_u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


def keys_case(n, shape=None, seed=0, extremes=False):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-5000, 5000, n).astype(np.int32)
    if extremes and n >= 4:
        keys[:4] = [0, -1, I32.min, I32.max]
    return keys.reshape(shape) if shape else keys


def valid_case(n, pattern, seed=1, shape=None):
    if pattern == "all":
        v = np.ones(n, bool)
    elif pattern == "none":
        v = np.zeros(n, bool)
    else:
        v = np.random.default_rng(seed).random(n) < 0.5
    return v.reshape(shape) if shape else v


def np_bloom_probe(keys, words, k):
    """numpy oracle of the probe over the reference's own hash."""
    flat = np.asarray(keys, np.int32).reshape(-1)
    m_bits = words.shape[0] * 32
    h1 = j_bloom._np_hash32(flat, j_bloom.BLOOM_SEED_1)
    h2 = j_bloom._np_hash32(flat, j_bloom.BLOOM_SEED_2) | np.uint32(1)
    keep = np.ones(flat.shape, bool)
    with np.errstate(over="ignore"):
        for i in range(k):
            pos = (h1 + np.uint32(i) * h2) & np.uint32(m_bits - 1)
            keep &= ((words[pos >> np.uint32(5)] >> (pos & np.uint32(31)))
                     & np.uint32(1)).astype(bool)
    return keep.reshape(np.shape(keys))


# ---------------------------------------------------------------------------
# Kernels: plain versions against the reference, bit for bit
# ---------------------------------------------------------------------------

#: (n, shape, m_bits, k, valid pattern, extreme keys): run through the
#: reference's interpret-mode Pallas kernels (each case compiles once).
INTERPRET_CASES = [(1, None, 32, 1, "all", False),
                   (31, None, 256, 7, "none", False),
                   (200, (4, 50), 1024, 8, "random", True),
                   (1000, None, 4096, 8, "random", True)]


@pytest.mark.parametrize("n,shape,m_bits,k,pattern,extremes",
                         INTERPRET_CASES)
def test_bloom_pair_equals_reference_kernels(n, shape, m_bits, k, pattern,
                                             extremes):
    keys = keys_case(n, shape, extremes=extremes)
    valid = valid_case(n, pattern, shape=shape)
    want = np.asarray(j_bloom.bloom_build(jnp.asarray(keys),
                                          jnp.asarray(valid),
                                          m_bits=m_bits, k=k))
    got = bloom_build(t(keys), t(valid), m_bits=m_bits, k=k)
    assert got.dtype == torch.int32 and got.shape == (m_bits // 32,)
    assert np.array_equal(words_u32(got), want)
    probe = np.concatenate([keys.reshape(-1), keys_case(n, seed=9)])
    want_keep = np.asarray(j_bloom.bloom_probe(jnp.asarray(probe),
                                               jnp.asarray(want), k=k))
    assert np.array_equal(bloom_probe(t(probe), got, k=k).numpy(), want_keep)


@pytest.mark.parametrize("n,shape,pattern,extremes", [
    (0, None, "all", False), (1, None, "all", False),
    (31, None, "none", False), (200, (4, 50), "random", True),
    (1000, None, "random", True)])
def test_key_range_equals_reference_kernel(n, shape, pattern, extremes):
    keys = keys_case(n, shape, extremes=extremes)
    valid = valid_case(n, pattern, shape=shape)
    want = np.asarray(j_zone_map.key_range(jnp.asarray(keys),
                                           jnp.asarray(valid)))
    got = key_range(t(keys), t(valid))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,m_bits,k,pattern", [
    (0, 32, 8, "all"), (1, 32, 1, "all"), (31, 32, 8, "random"),
    (1000, 256, 7, "none"), (20_000, 65536, 8, "random"),
    (20_000, 1 << 20, 8, "all"), (5000, 65536, 1, "random")])
def test_bloom_pair_equals_numpy_oracles(n, m_bits, k, pattern):
    keys = keys_case(n, seed=n, extremes=True)
    valid = valid_case(n, pattern, seed=n)
    want = j_bloom.bloom_build_ref(keys, valid, m_bits=m_bits, k=k)
    got = bloom_build(t(keys), t(valid), m_bits=m_bits, k=k)
    assert np.array_equal(words_u32(got), want)
    assert np.array_equal(words_u32(ref.bloom_build_ref(
        t(keys), t(valid), m_bits, k)), want)
    probe = np.concatenate([keys, keys_case(n, seed=n + 1, extremes=True)])
    keep = bloom_probe(t(probe), got, k=k).numpy()
    assert np.array_equal(keep, np_bloom_probe(probe, want, k))
    assert keep[:n][valid].all()  # no false negatives


def test_bloom_keys_any_shape_and_valid_none():
    keys = keys_case(600, (6, 100), extremes=True)
    flat = bloom_build(t(keys.reshape(-1)), m_bits=2048, k=7)
    assert torch.equal(bloom_build(t(keys), m_bits=2048, k=7), flat)
    assert np.array_equal(words_u32(flat), j_bloom.bloom_build_ref(
        keys, m_bits=2048, k=7))
    keep = bloom_probe(t(keys), flat, k=7)
    assert keep.shape == (6, 100) and bool(keep.all())


@pytest.mark.parametrize("n", [0, 1, 31, 100_003])
@pytest.mark.parametrize("pattern", ["all", "none", "random"])
def test_key_range_equals_numpy_oracle(n, pattern):
    keys = keys_case(n, seed=n, extremes=True)
    valid = valid_case(n, pattern, seed=n)
    want = j_zone_map.key_range_ref(keys, valid)
    assert np.array_equal(key_range(t(keys), t(valid)).numpy(), want)
    if n:
        assert np.array_equal(key_range(t(keys.reshape(1, n))).numpy(),
                              j_zone_map.key_range_ref(keys))


def test_empty_builds_reject_everything():
    keys = keys_case(100, extremes=True)
    none = np.zeros(100, bool)
    words = bloom_build(t(keys), t(none), m_bits=256, k=8)
    assert not bool(words.any())
    assert not bool(bloom_probe(t(keys), words, k=8).any())
    lo_hi = key_range(t(keys), t(none))
    assert lo_hi.tolist() == [I32.max, I32.min]
    assert not bool(range_probe(t(keys), lo_hi).any())
    sk, n = psts.key_set(t(keys), t(none))
    assert int(n) == 0
    assert not bool(psts.semi_join_mask(t(keys), sk, n).any())
    empty = torch.zeros(0, dtype=torch.int32)
    assert not bool(psts.semi_join_mask(t(keys), empty).any())


@pytest.mark.parametrize("m_bits", [0, 16, 48, 100, 1000])
def test_bad_m_bits_raise_as_in_the_reference(m_bits):
    keys = keys_case(10)
    with pytest.raises(ValueError):
        bloom_build(t(keys), m_bits=m_bits, k=3)
    if m_bits:  # the reference lets m_bits = 0 through
        with pytest.raises(ValueError):
            j_bloom.bloom_build(jnp.asarray(keys), m_bits=m_bits, k=3)


def test_range_probe_and_merge_ranges_equal_reference():
    keys = keys_case(500, extremes=True)
    parts = np.array([[5, 90], [I32.max, I32.min], [-3, 12]], np.int32)
    want = np.asarray(j_zone_map.merge_ranges(jnp.asarray(parts)))
    got = merge_ranges(t(parts))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        range_probe(t(keys), got).numpy(),
        np.asarray(j_zone_map.range_probe(jnp.asarray(keys),
                                          jnp.asarray(want))))


# ---------------------------------------------------------------------------
# Helpers: key sets, filter kinds, planner, cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,pattern", [(0, "all"), (1, "all"),
                                       (300, "random"), (300, "none")])
def test_key_set_and_semi_join_mask_equal_reference(n, pattern):
    rng = np.random.default_rng(n)
    keys = rng.integers(-20, 20, n).astype(np.int32)
    if n >= 3:
        keys[:3] = [I32.max, I32.min, -1]
    valid = valid_case(n, pattern, seed=n)
    jk, jn = j_psts.key_set(jnp.asarray(keys), jnp.asarray(valid))
    tk, tn = psts.key_set(t(keys), t(valid))
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert tn.dim() == 0 and int(tn) == int(jn)
    assert psts.distinct_count(t(keys), t(valid)) == j_psts.distinct_count(
        jnp.asarray(keys), jnp.asarray(valid))
    probe = np.concatenate([keys, rng.integers(-30, 30, 50).astype(np.int32),
                            np.array([I32.max], np.int32)])
    for n_arg in ("count", None):
        want = j_psts.semi_join_mask(jnp.asarray(probe), jk,
                                     jn if n_arg else None)
        got = psts.semi_join_mask(t(probe), tk, tn if n_arg else None)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_psts_report_equals_reference():
    from repro.core.cost_model import JoinMethod as JM
    from repro_torch.core.cost_model import JoinMethod as TM
    names = ["shuffle_sort", "broadcast_hash", "shuffle_hash"]
    base = ["broadcast_hash", "broadcast_hash", "shuffle_sort"]
    want = j_psts.compute_psts([JM(m) for m in names], [JM(m) for m in base],
                               8.0, 10.0, [1.0, 2.0, 3.0], [2.0, 2.0, 5.0])
    got = psts.compute_psts([TM(m) for m in names], [TM(m) for m in base],
                            8.0, 10.0, [1.0, 2.0, 3.0], [2.0, 2.0, 5.0])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


#: (probe (size, card), build (size, card), sigma, build leaf filter):
#: the planner cases of tests/test_filter_kinds.py.
PLANNER_CASES = {
    "zone_map": ((1 << 20, 32_768), (2_048, 128), 0.25,
                 ("pk", "lt", 128, 0.25)),
    "semi_join": ((1 << 20, 32_768), (80, 5), 0.08,
                  ("payload", "eq", 0, 0.08)),
    "bloom": ((1 << 20, 32_768), (1 << 14, 1_024), 0.1,
              ("payload", "lt", 1, 0.1)),
    "nothing": ((1 << 20, 32_768), (1 << 14, 1_024), 1.0, None),
}


def _leaves(mod, spec):
    if spec is None:
        return [mod.Scan("fact"), mod.Scan("dim")]
    col, op, value, sel = spec
    return [mod.Scan("fact"),
            mod.Filter(mod.Scan("dim"), col, op, value, selectivity=sel)]


@pytest.mark.parametrize("kinds", [None, ("bloom",)])
@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
def test_plan_runtime_filters_equals_reference(case, kinds):
    probe, build, sigma, spec = PLANNER_CASES[case]
    extra = {} if kinds is None else {"kinds": kinds}
    want = j_plan_runtime_filters(
        [jl.JoinEdge(0, 1, "fk", "pk")],
        [JTableStats(*map(float, probe)), JTableStats(*map(float, build))],
        [1.0, sigma], JCostParams(p=8, w=1.0), leaves=_leaves(jl, spec),
        **extra)
    got = plan_runtime_filters(
        [tl.JoinEdge(0, 1, "fk", "pk")],
        [TableStats(*map(float, probe)), TableStats(*map(float, build))],
        [1.0, sigma], CostParams(p=8, w=1.0), leaves=_leaves(tl, spec),
        **extra)
    assert [dataclasses.asdict(f) for f in got] == \
        [dataclasses.asdict(f) for f in want]
    if case != "nothing":
        assert [f.kind for f in got] == [kinds[0] if kinds else case]


@pytest.mark.parametrize("kind", ["bloom", "zone_map", "semi_join"])
@pytest.mark.parametrize("n_keys,sigma,band", [(5.0, 0.08, None),
                                               (1024.0, 0.1, 0.1),
                                               (12_000.0, 0.3, None)])
def test_filter_quotes_equal_reference(kind, n_keys, sigma, band):
    want = j_rf.FILTER_KINDS[kind].quote(n_keys, sigma, band, 10,
                                         JCostParams(p=8, w=1.0))
    got = t_rf.FILTER_KINDS[kind].quote(n_keys, sigma, band, 10,
                                        CostParams(p=8, w=1.0))
    assert (None if got is None else dataclasses.asdict(got)) == \
        (None if want is None else dataclasses.asdict(want))
    assert t_rf.DEFAULT_FILTER_KINDS == j_rf.DEFAULT_FILTER_KINDS


def _chain_leaves(mod):
    scan = mod.Scan("customer")
    f1 = mod.Filter(scan, "c_income", "lt", 74_000, selectivity=0.3)
    f2 = mod.Filter(f1, "c_region", "in", 0, values=(3, 1, 3))
    swapped = mod.Filter(mod.Filter(scan, "c_region", "in", 0,
                                    values=(1, 3)),
                         "c_income", "lt", 74_000, selectivity=0.3)
    agg = mod.Aggregate(scan, "c_region", (("c_income", "sum"),))
    return [scan, f1, f2, swapped,
            mod.Project(f2, ("c_customer_sk", "c_region")), agg]


def test_cache_keys_equal_reference():
    for tleaf, jleaf in zip(_chain_leaves(tl), _chain_leaves(jl)):
        assert t_rf.predicate_chain(tleaf) == j_rf.predicate_chain(jleaf)
        assert t_rf.chain_stats_key(tleaf, "c_customer_sk") == \
            j_rf.chain_stats_key(jleaf, "c_customer_sk")
        for kind, m_bits, k in (("bloom", 2048, 7), ("zone_map", 64, 0)):
            assert t_rf.filter_cache_key(tleaf, "c_customer_sk", kind,
                                         m_bits, k) == \
                j_rf.filter_cache_key(jleaf, "c_customer_sk", kind, m_bits,
                                      k)


def _drive_cache(cache, catalogs, stats):
    key = ("customer", (), "c_customer_sk", "bloom", 256, 8)
    other = key[:5] + (7,)
    log = []
    cache.sync(catalogs[0])
    log.append(cache.lookup(key))
    cache.store(key, "payload", stats)
    cache.store(None, "ignored", stats)
    log += [cache.lookup(key), cache.lookup(other), cache.lookup(None),
            cache.contains(key), cache.contains(None), len(cache),
            cache.measured_build_stats(key[:3]) is stats]
    cache.sync(catalogs[0])
    log.append(cache.lookup(key))
    cache.sync(catalogs[1])
    log += [cache.lookup(key), len(cache), cache.measured_build_stats(key[:3])]
    cache.sync(catalogs[0])
    return log + [cache.hits, cache.misses, cache.invalidations]


def test_filter_cache_counts_as_the_reference():
    got = _drive_cache(FilterCache(), [Catalog({}, 1), Catalog({}, 1)],
                       TableStats(640.0, 5.0))
    want = _drive_cache(JFilterCache(), [JCatalog({}, 1), JCatalog({}, 1)],
                        JTableStats(640.0, 5.0))
    assert got == want
    assert got[-3:] == [2, 4, 1]


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

def test_filtered_query_plans_equal_reference():
    ref_plans = j_filtered_queries()
    assert sorted(ref_plans) == FILTERED
    for name, plan in filtered_queries().items():
        assert signature(plan) == jl.signature(ref_plans[name]), name


@pytest.fixture(scope="module")
def port_catalog():
    return generate(0.1, 4, 42, device="cpu")


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("query", FILTERED)
def test_unfiltered_decisions_equal_golden(port_catalog, query, use_kernel):
    plan = filtered_queries()[query]
    for s in default_strategies():
        res = Executor(port_catalog, s, use_kernel=use_kernel).execute(plan)
        got = [{"method": d.selection.method.value,
                "swapped": bool(d.selection.swapped_sides)}
               for d in res.decisions]
        assert got == GOLDEN[query]["strategies"][s.name], s.name
        assert res.filters == []


# ---------------------------------------------------------------------------
# Executor against the JAX package
# ---------------------------------------------------------------------------

def _outer(mod, join_type):
    """Fact LEFT OUTER JOIN a 30%-filtered customer: the filter drops probe
    rows that must come back null-padded."""
    f = mod.Filter(mod.Scan("customer"), "c_income", "lt", 74_000,
                   selectivity=0.3)
    return mod.Join(mod.Project(mod.Scan("store_sales"),
                                ("ss_customer_sk", "ss_net_profit")),
                    f, "ss_customer_sk", "c_customer_sk",
                    join_type=join_type)


#: The compared runs: (label, strategy name, query name or the outer join).
COMPARED = [("q19", "RelJoin(w=1)", "q19_filtered_customer"),
            ("q20", "ShuffleSort", "q20_filter_below_earlier_exchange"),
            ("q22", "RelJoin(w=1)", "q22_zone_map_window"),
            ("q23", "RelJoin(w=1)", "q23_semi_join_stores"),
            ("outer", "RelJoin(w=1)", None)]


@pytest.fixture(scope="module")
def jax_runs(catalog):
    """The five JAX ``Executor`` runs, each with its own (cold) cache so
    its built payloads can be read back."""
    strategies = {s.name: s for s in j_default_strategies()}
    plans = j_filtered_queries()
    runs = {}
    for label, strategy, query in COMPARED:
        cache = JFilterCache()
        plan = (plans[query] if query else _outer(jl, JJoinType.LEFT_OUTER))
        res = JExecutor(catalog, JFilteredStrategy(strategies[strategy],
                                                   cache=cache)).execute(plan)
        runs[label] = (res, cache)
    return runs


def _filters(res):
    return [(f.plan.kind, f.plan.probe, f.plan.build, f.plan.probe_key,
             f.plan.build_key, f.plan.m_bits, f.plan.k, f.plan.derived,
             f.rows_before, f.rows_after, f.cached, f.network_bytes,
             f.reduce_bytes) for f in res.filters]


def _joins(res):
    return [(d.selection.method.value, d.selection.swapped_sides,
             d.left_stats.size_bytes, d.left_stats.cardinality,
             d.right_stats.size_bytes, d.right_stats.cardinality,
             d.network_bytes, d.probe_shuffle_bytes) for d in res.decisions]


@pytest.mark.parametrize("label,strategy,query", COMPARED,
                         ids=[c[0] for c in COMPARED])
def test_filtered_execution_equals_reference(jax_runs, port_catalog, label,
                                             strategy, query):
    want, jcache = jax_runs[label]
    inner = {s.name: s for s in default_strategies()}[strategy]
    cache = FilterCache()
    plan = (filtered_queries()[query] if query
            else _outer(tl, JoinType.LEFT_OUTER))
    got = Executor(port_catalog, FilteredStrategy(inner, cache=cache)
                   ).execute(plan)
    assert len(got.filters) >= 1
    assert _filters(got) == _filters(want)
    assert _joins(got) == _joins(want)
    assert got.network_bytes == want.network_bytes
    assert got.local_bytes == want.local_bytes
    assert got.straggler_bytes == want.straggler_bytes
    assert got.probe_shuffle_bytes == want.probe_shuffle_bytes
    assert got.filter_network_bytes == want.filter_network_bytes
    assert got.rows == want.rows
    assert rows_close(rows_as_set(got.table.to_numpy()),
                      rows_as_set(want.table.to_numpy()))
    # The payloads: the port's own builds equal the reference's, and the
    # reference's payloads probe the port's columns as the reference does.
    assert sorted(cache._entries) == sorted(jcache._entries)
    for key, entry in jcache._entries.items():
        kind = key[3]
        arrays = jax_to_numpy(entry.payload)
        payload = payload_from_numpy(kind, arrays, "cpu")
        mine = cache._entries[key].payload
        if kind == "semi_join":
            assert torch.equal(mine[0], payload[0])
            assert int(mine[1]) == int(payload[1])
        else:
            assert torch.equal(mine, payload)
        rf = next(f.plan for f in got.filters if f.plan.kind == kind)
        col = port_catalog.table(_probe_table(rf.probe_key)).column(
            rf.probe_key)
        jcol = jnp.asarray(col.numpy())
        keep = t_rf.probe_filter_mask(rf, payload, col)
        jkeep = j_rf.probe_filter_mask(
            next(f.plan for f in want.filters if f.plan.kind == kind),
            entry.payload, jcol)
        assert np.array_equal(keep.numpy(), np.asarray(jkeep))


def jax_to_numpy(payload):
    if isinstance(payload, tuple):
        return tuple(np.asarray(a) for a in payload)
    return np.asarray(payload)


def _probe_table(column):
    return {"ss": "store_sales", "cs": "catalog_sales"}[column.split("_")[0]]


def test_outer_join_padding_keeps_unmatched_rows(port_catalog):
    """The LEFT_OUTER filter drops probe rows, and the padding path brings
    every one of them back: the filtered run's rows equal the unfiltered
    run's."""
    plan = _outer(tl, JoinType.LEFT_OUTER)
    s = default_strategies()[-1]
    got = Executor(port_catalog, FilteredStrategy(s)).execute(plan)
    base = Executor(port_catalog, s).execute(plan)
    assert got.filters and got.filters[0].rows_after < \
        got.filters[0].rows_before
    assert got.rows == base.rows
    assert rows_close(rows_as_set(got.table.to_numpy()),
                      rows_as_set(base.table.to_numpy()))
    anti = Executor(port_catalog, FilteredStrategy(s)).execute(
        _outer(tl, JoinType.LEFT_ANTI))
    assert anti.filters == []


# ---------------------------------------------------------------------------
# The port on its own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("query", FILTERED)
def test_filtered_rows_equal_unfiltered_rows(port_catalog, query):
    plan = filtered_queries()[query]
    want_kind = {"q22_zone_map_window": "zone_map",
                 "q23_semi_join_stores": "semi_join"}.get(query, "bloom")
    shipped = {"filtered": 0.0, "unfiltered": 0.0}
    for s in default_strategies():
        got = Executor(port_catalog, FilteredStrategy(s)).execute(plan)
        base = Executor(port_catalog, s).execute(plan)
        assert [f.plan.kind for f in got.filters] == [want_kind], s.name
        assert got.rows == base.rows
        assert rows_close(rows_as_set(got.table.to_numpy()),
                          rows_as_set(base.table.to_numpy())), s.name
        assert got.network_bytes == pytest.approx(
            sum(d.network_bytes for d in got.decisions)
            + got.filter_network_bytes)
        shipped["filtered"] += got.probe_shuffle_bytes
        shipped["unfiltered"] += base.probe_shuffle_bytes
    # A filter can turn a broadcast into a shuffle (the filtered fact falls
    # below its build side), so only the sum over strategies must drop.
    assert shipped["filtered"] < shipped["unfiltered"]


def test_warm_cache_reuses_every_filter(port_catalog):
    cache = FilterCache()
    s = default_strategies()[-1]
    cold = {q: Executor(port_catalog, FilteredStrategy(s, cache=cache)
                        ).execute(p)
            for q, p in filtered_queries().items()}
    assert cache.hits == 0 and len(cache) == 5
    for q, plan in filtered_queries().items():
        warm = Executor(port_catalog, FilteredStrategy(s, cache=cache)
                        ).execute(plan)
        assert warm.cached_filters >= 1 and warm.filter_reduce_bytes == 0
        assert cold[q].filter_reduce_bytes > 0
        assert rows_close(rows_as_set(warm.table.to_numpy()),
                          rows_as_set(cold[q].table.to_numpy()))
    assert cache.hits == 5 and cache.invalidations == 0
    other = generate(0.05, 4, 42, device="cpu")
    Executor(other, FilteredStrategy(s, cache=cache)).execute(
        filtered_queries()["q19_filtered_customer"])
    assert cache.invalidations == 1


@pytest.mark.parametrize("flag", ["skew_aware", "verify", "reopt"])
def test_later_slice_flags_raise_through_filtered_strategy(port_catalog,
                                                           flag):
    """Named for the guards these flags had before their slices: a flag of
    the wrapped strategy now reaches the executor through
    ``FilteredStrategy`` as it does in the reference, and the filtered run
    keeps the rows and filters of the flag-off run (uniform keys: skew
    snaps to 1.0; q19 has no reorderable region for ``reopt``)."""
    plan = filtered_queries()["q19_filtered_customer"]
    inner, jinner = default_strategies()[-1], j_default_strategies()[-1]
    setattr(inner, flag, True)
    setattr(jinner, flag, True)
    strat, jstrat = FilteredStrategy(inner), JFilteredStrategy(jinner)
    assert getattr(strat, flag) is getattr(jstrat, flag) is True
    assert (strat.skew_floor, strat.reopt_qerror) == \
        (jstrat.skew_floor, jstrat.reopt_qerror)
    ex = Executor(port_catalog, strat)
    assert getattr(ex, flag) is True
    res = ex.execute(plan)
    base = Executor(port_catalog,
                    FilteredStrategy(default_strategies()[-1])).execute(plan)
    assert res.methods() == base.methods()
    assert [f.plan for f in res.filters] == [f.plan for f in base.filters]
    assert res.network_bytes == base.network_bytes
    assert rows_close(rows_as_set(res.table.to_numpy()),
                      rows_as_set(base.table.to_numpy()))


def test_reopt_raises_through_filtered_reordering_strategy(port_catalog):
    """Named for the guard checkpoint re-optimization had before its slice:
    ``Filtered(Reorder(reopt=True))`` now runs its checkpoints on q20's
    region, disciplined, with the rows of the reopt-off run."""
    strat = FilteredStrategy(ReorderingStrategy(reopt=True))
    jstrat = JFilteredStrategy(JReorderingStrategy(reopt=True))
    assert strat.reorder is True and strat.reopt is True
    assert (strat.reopt, strat.reopt_qerror) == (jstrat.reopt,
                                                 jstrat.reopt_qerror)
    plan = filtered_queries()["q20_filter_below_earlier_exchange"]
    res = Executor(port_catalog, strat, verify=True).execute(plan)
    base = Executor(port_catalog, FilteredStrategy(ReorderingStrategy())
                    ).execute(plan)
    assert res.reopts
    for d in res.reopts:
        assert d.triggered == (d.q_error > d.threshold)
        if not d.triggered:
            assert d.new_next == d.old_next
    assert res.rows == base.rows
    assert rows_close(rows_as_set(res.table.to_numpy()),
                      rows_as_set(base.table.to_numpy()))


def test_filtered_strategy_names_equal_reference():
    assert [FilteredStrategy(s).name for s in default_strategies()] == \
        [JFilteredStrategy(s).name for s in j_default_strategies()]
