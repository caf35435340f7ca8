"""The port's skew handling against the JAX package's, on the CPU.

The skew primitives of ``joins/exchange.py`` (``key_skew``,
``hot_fine_buckets``, ``_salted_dest``, ``salted_shuffle``), the salted
shuffle hash join, and the executor's skew path under
``SkewAwareStrategy`` on q16-q18, on the Zipf catalogs of the reference's
skew suite (``zipf_catalogs``: ``generate(0.1, 8, 11, skew=z)`` for z = 0,
1.2 and 1.4).

Tolerances: skew factors, hot masks, fine ids, salted destinations, every
byte count and overflow compare exactly; the measured skew of each
decision to 1e-12 (both are the same float computation); rows as
multisets, float aggregates with ``rows_close`` (their summation order
differs). The JAX kernel path runs its Pallas kernels in interpret mode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.joins import exchange as jex
from repro.joins import methods as jmethods
from repro.joins import table as jtable
from repro.joins.ref import ref_equi_join, rows_as_set, rows_close
from repro.kernels.bloom import _np_hash32
from repro.sql import Executor as JExecutor
from repro.sql import SkewAwareStrategy as JSkewAwareStrategy
from repro.sql import skewed_queries as j_skewed_queries
from repro_torch.core.cost_model import JoinMethod
from repro_torch.joins import exchange, methods
from repro_torch.joins import table as ttable
from repro_torch.sql import (Executor, ForcedStrategy, RelJoinStrategy,
                             ReorderingStrategy, SkewAwareStrategy, generate,
                             skewed_queries)

ZIPF = (0.0, 1.2, 1.4)
SKEWED = sorted(skewed_queries())
#: Fact join keys of the zipf catalogs, hot and cold.
FACT_KEYS = (("store_sales", "ss_customer_sk"), ("store_sales", "ss_item_sk"),
             ("store_sales", "ss_store_sk"),
             ("catalog_sales", "cs_bill_customer_sk"),
             ("inventory", "inv_item_sk"))


@pytest.fixture(scope="module")
def port_zipf():
    """The port's twins of the reference's ``zipf_catalogs``."""
    return {z: generate(0.1, 8, 11, skew=z, device="cpu") for z in ZIPF}


def _rows(res):
    return rows_as_set(res.table.to_numpy())


def both_tables(cols, p, capacity=None):
    """The same numpy columns as a (JAX, port) pair of stacked tables."""
    jt = jtable.partition_round_robin(jtable.from_numpy(cols, capacity), p)
    tt = ttable.partition_round_robin(
        ttable.from_numpy(cols, capacity, device="cpu"), p)
    return jt, tt


def hot_fact_dim(seed, p, na=600, nb=60, zipf=1.3):
    """A fact with Zipf-distributed foreign keys (a few hot keys) and its
    unique-key dimension, as (JAX, port) pairs and numpy columns."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(zipf, na) - 1
    a = {"k": (ranks % nb).astype(np.int32),
         "v": rng.uniform(0, 1, na).astype(np.float32),
         "q": rng.integers(1, 9, na).astype(np.int32)}
    b = {"k": rng.permutation(nb).astype(np.int32),
         "payload": rng.integers(0, 99, nb).astype(np.int32)}
    return a, b, both_tables(a, p, na + 7), both_tables(b, p)


def partition_rows(t):
    """Each partition's valid rows, as a multiset."""
    valid = np.asarray(t.valid.numpy() if isinstance(t.valid, torch.Tensor)
                       else t.valid)
    cols = {n: np.asarray(c.numpy() if isinstance(c, torch.Tensor) else c)
            for n, c in t.columns.items()}
    return [rows_as_set({n: c[i][valid[i]] for n, c in cols.items()})
            for i in range(valid.shape[0])]


# ---------------------------------------------------------------------------
# The skew primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("z", ZIPF)
def test_key_skew_equals_reference(zipf_catalogs, port_zipf, z):
    for tname, key in FACT_KEYS:
        jt, tt = zipf_catalogs[z].table(tname), port_zipf[z].table(tname)
        for p, floor in ((8, 1.1), (8, 0.0), (4, 1.1), (3, 0.0)):
            got = exchange.key_skew(tt, key, p, floor)
            assert got == jex.key_skew(jt, key, p, floor), (tname, key, p)
            assert isinstance(got, float)


def test_key_skew_snaps_on_uniform_and_detects_zipf(port_zipf):
    """The reference suite's two statistics cells, on the port."""
    assert exchange.key_skew(port_zipf[0.0].table("store_sales"),
                             "ss_customer_sk", 8) == 1.0
    assert exchange.key_skew(port_zipf[1.2].table("store_sales"),
                             "ss_customer_sk", 8) > 1.5


@pytest.mark.parametrize("z", ZIPF)
def test_hot_fine_buckets_equal_reference(zipf_catalogs, port_zipf, z):
    n_hot = 0
    for tname, key in FACT_KEYS:
        jt, tt = zipf_catalogs[z].table(tname), port_zipf[z].table(tname)
        for mult, share in ((exchange.HOT_FINE_MULT,
                             exchange.HOT_PARTITION_SHARE), (2, 0.05)):
            nf = mult * 8
            jhot, jfine = jex.hot_fine_buckets(jt, key, nf, 8, share)
            hot, fine = exchange.hot_fine_buckets(tt, key, nf, 8, share)
            assert hot.dtype == torch.bool and hot.shape == (nf,)
            assert fine.dtype == torch.int32
            np.testing.assert_array_equal(hot.numpy(), np.asarray(jhot))
            np.testing.assert_array_equal(fine.numpy(), np.asarray(jfine))
            if (key, share) == ("ss_customer_sk",
                                exchange.HOT_PARTITION_SHARE):
                n_hot += int(hot.sum())
    # The customer key (the skewed queries' join key) has a hot bucket
    # only on the Zipf catalogs.
    assert (n_hot > 0) == (z > 0)


def test_skew_constants_equal_reference():
    assert exchange.SALT_SEED == int(jex.SALT_SEED)
    assert exchange.HOT_FINE_MULT == jex.HOT_FINE_MULT
    assert exchange.HOT_PARTITION_SHARE == jex.HOT_PARTITION_SHARE


@pytest.mark.parametrize("p", [2, 3, 8, 16])
def test_salted_dest_wraps_like_uint32(p):
    """Keys and salts whose two uint32 hashes sum past 2^32: the sum wraps
    before ``% p``, as the reference's uint32 arithmetic does."""
    rng = np.random.default_rng(p)
    cand = rng.integers(-2**31, 2**31 - 1, 20000, dtype=np.int64
                        ).astype(np.int32)
    hk = _np_hash32(cand, exchange.SHUFFLE_SEED).astype(np.int64)
    keys = cand[hk >= 2**31][:500]
    salts = np.resize(np.arange(16, dtype=np.int32), keys.size)
    hs = _np_hash32(salts, exchange.SALT_SEED).astype(np.int64)
    wraps = (hk[hk >= 2**31][:500] + hs) >= 2**32
    assert wraps.sum() > 100 and (~wraps).sum() > 0
    got = exchange._salted_dest(torch.from_numpy(keys),
                                torch.from_numpy(salts), p)
    want = np.asarray(jex._salted_dest(jnp.asarray(keys),
                                       jnp.asarray(salts), p))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # Salt 0 is the plain shuffle destination.
    zero = torch.zeros(keys.size, dtype=torch.int32)
    np.testing.assert_array_equal(
        exchange._salted_dest(torch.from_numpy(keys), zero, p).numpy(),
        exchange._dest_partition(torch.from_numpy(keys), p).numpy())


@pytest.mark.parametrize("factor", [2.0, 0.3])
@pytest.mark.parametrize("r", [2, 3, 8])
@pytest.mark.parametrize("p", [4, 8])
def test_salted_shuffle_equals_reference(p, r, factor):
    """Both sides' received rows, partition by partition, and both
    ``ExchangeReport``s field for field (overflow too: at factor 0.3 the
    probe side overflows at p = 4)."""
    _, _, (ja, ta), (jb, tb) = hot_fact_dim(p * 10 + r, p)
    jout = jex.salted_shuffle(ja, "k", jb, "k", r, factor)
    tout = exchange.salted_shuffle(ta, "k", tb, "k", r, factor)
    for jt, tt in zip(jout[:2], tout[:2]):
        assert tt.partitioned_by is None
        assert partition_rows(tt) == partition_rows(jt)
    for jrep, trep in zip(jout[2:], tout[2:]):
        assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
        assert trep.kind == "salted_shuffle"
    # The hot keys were spread: the probe straggler is below a plain
    # shuffle's.
    if factor == 2.0:
        assert tout[2].straggler_bytes < exchange.shuffle(
            ta, "k", factor)[1].straggler_bytes
    elif p == 4:
        assert tout[2].overflow_rows > 0


def test_salted_shuffle_leaves_duplicate_build_keys():
    """Replicas of a hot key's build row can land on one partition: the
    first-match probe then meets duplicate build keys."""
    _, _, (_, ta), (_, tb) = hot_fact_dim(1, 4)
    _, b_sh, _, _ = exchange.salted_shuffle(ta, "k", tb, "k", 8)
    dup = 0
    for i in range(4):
        keys = b_sh.column("k")[i][b_sh.valid[i]]
        dup += keys.numel() - torch.unique(keys).numel()
    assert dup > 0


# ---------------------------------------------------------------------------
# The salted shuffle hash join
# ---------------------------------------------------------------------------

def _report_dict(rep):
    return {"method": rep.method.value,
            "exchanges": [dataclasses.asdict(e) for e in rep.exchanges],
            "local_bytes": rep.local_bytes, "output_rows": rep.output_rows}


@pytest.mark.parametrize("join_type", ["inner", "left_outer", "left_semi",
                                       "left_anti"])
@pytest.mark.parametrize("salt_r", [1, 3])
def test_salted_join_equals_reference(salt_r, join_type):
    """Rows and report on both local-join paths against the JAX gather
    path (whose kernel path drops probe rows of full buckets, a fault of
    the reference the port does not share) and the numpy oracle."""
    a, b, (ja, ta), (jb, tb) = hot_fact_dim(salt_r, 4)
    jout, jrep = jmethods.run_equi_join(
        jmethods.JoinMethod.SALTED_SHUFFLE_HASH, ja, jb, "k", "k",
        join_type, salt_r=salt_r)
    want = rows_as_set(ref_equi_join(a, b, "k", "k", join_type))
    assert rows_as_set(jout.to_numpy()) == want
    for use_kernel in (False, True):
        tout, trep = methods.run_equi_join(
            JoinMethod.SALTED_SHUFFLE_HASH, ta, tb, "k", "k", join_type,
            use_kernel=use_kernel, salt_r=salt_r)
        assert _report_dict(trep) == _report_dict(jrep), use_kernel
        assert rows_as_set(tout.to_numpy()) == want, use_kernel
        assert tout.partitioned_by is None
    assert methods.EQUI_METHODS[JoinMethod.SALTED_SHUFFLE_HASH] is \
        methods.salted_shuffle_hash_join
    assert sorted(m.value for m in methods.EQUI_METHODS) == \
        sorted(m.value for m in jmethods.EQUI_METHODS)


# ---------------------------------------------------------------------------
# The executor's skew path: q16-q18 under SkewAwareStrategy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_skew_runs(zipf_catalogs):
    """The JAX ``Executor``'s q16-q18 under ``SkewAwareStrategy`` on every
    zipf catalog, computed once (each compiles its shapes)."""
    return {(z, q): JExecutor(zipf_catalogs[z], JSkewAwareStrategy()
                              ).execute(plan)
            for z in ZIPF for q, plan in j_skewed_queries().items()}


def _skew_decisions(res):
    return [(d.selection.method.value, d.selection.salt_r,
             bool(d.selection.swapped_sides), d.selection.reason)
            for d in res.decisions]


@pytest.mark.parametrize("query", SKEWED)
@pytest.mark.parametrize("z", ZIPF)
def test_skew_aware_runs_equal_reference(port_zipf, reference_skew_runs, z,
                                         query):
    want = reference_skew_runs[(z, query)]
    for use_kernel in (False, True):
        got = Executor(port_zipf[z], SkewAwareStrategy(),
                       use_kernel=use_kernel).execute(
            skewed_queries()[query])
        assert _skew_decisions(got) == _skew_decisions(want), use_kernel
        for g, w in zip(got.decisions, want.decisions):
            for side in ("left_stats", "right_stats"):
                assert getattr(g, side).skew == pytest.approx(
                    getattr(w, side).skew, rel=1e-12, abs=1e-12)
            assert g.network_bytes == w.network_bytes
            assert g.straggler_bytes == w.straggler_bytes
        assert got.rows == want.rows
        assert got.network_bytes == want.network_bytes
        assert got.local_bytes == want.local_bytes
        assert got.straggler_bytes == want.straggler_bytes
        assert rows_close(_rows(got), _rows(want))
    salted = JoinMethod.SALTED_SHUFFLE_HASH in got.methods()
    assert salted == (z > 0)


def test_skew_zero_selections_identical_to_reljoin(port_zipf):
    """At skew 0 SkewAwareStrategy's selections are RelJoinStrategy's."""
    cat = port_zipf[0.0]
    for qname, plan in skewed_queries().items():
        base = Executor(cat, RelJoinStrategy()).execute(plan)
        skew = Executor(cat, SkewAwareStrategy()).execute(plan)
        assert skew.methods() == base.methods(), qname
        assert rows_close(_rows(skew), _rows(base)), qname


def test_skewed_queries_select_salted_and_cut_straggler(port_zipf):
    """At Zipf 1.2 every skewed query salts at least once, keeps its rows,
    and lands fewer straggler bytes than RelJoin's plain shuffle plan."""
    cat = port_zipf[1.2]
    for qname, plan in skewed_queries().items():
        base = Executor(cat, RelJoinStrategy()).execute(plan)
        skew = Executor(cat, SkewAwareStrategy()).execute(plan)
        assert JoinMethod.SALTED_SHUFFLE_HASH in skew.methods(), qname
        assert JoinMethod.SALTED_SHUFFLE_HASH not in base.methods(), qname
        assert rows_close(_rows(skew), _rows(base)), qname
        assert skew.straggler_bytes < base.straggler_bytes, qname


def test_reordering_wrapper_forwards_skew_awareness(port_zipf):
    """Reorder(SkewAware) keeps skew handling live: the wrapper forwards
    ``skew_aware`` and ``skew_floor``, and the statistic is measured."""
    strat = ReorderingStrategy(SkewAwareStrategy(skew_floor=1.3))
    assert strat.skew_aware and strat.skew_floor == 1.3
    ex = Executor(port_zipf[1.2], strat)
    assert ex.skew_aware and ex.skew_floor == 1.3
    plan = skewed_queries()["q16_hot_customer"]
    res = Executor(port_zipf[1.2], ReorderingStrategy(SkewAwareStrategy())
                   ).execute(plan)
    assert any(d.left_stats.skew > 1 or d.right_stats.skew > 1
               for d in res.decisions)
    base = Executor(port_zipf[1.2], SkewAwareStrategy()).execute(plan)
    assert rows_close(_rows(res), _rows(base))


def test_skew_overrides_target_single_column():
    cat = generate(0.1, 8, 11, skew=0.0,
                   skew_overrides={"ss_customer_sk": 1.3}, device="cpu")
    ss = cat.table("store_sales")
    assert exchange.key_skew(ss, "ss_customer_sk", 8) > 1.3
    assert exchange.key_skew(ss, "ss_item_sk", 8) == 1.0
    res = Executor(cat, SkewAwareStrategy()).execute(
        skewed_queries()["q16_hot_customer"])
    assert JoinMethod.SALTED_SHUFFLE_HASH in res.methods()


def test_skew_statistic_reaches_selection(port_zipf):
    res = Executor(port_zipf[1.2], SkewAwareStrategy()).execute(
        skewed_queries()["q16_hot_customer"])
    d = res.decisions[0]
    assert d.selection.method is JoinMethod.SALTED_SHUFFLE_HASH
    assert d.left_stats.skew > 1.5
    assert d.selection.salt_r >= 2


def test_overflow_retry_geometric_doubling(port_zipf):
    """A Zipf-1.4 shuffle overflows the default slot budget; the executor's
    doubling retry absorbs it for the plain and the salted method alike."""
    cat = port_zipf[1.4]
    _, rep = exchange.shuffle(cat.table("store_sales"), "ss_customer_sk", 2.0)
    assert rep.overflow_rows > 0
    plan = skewed_queries()["q16_hot_customer"]
    forced = Executor(cat, ForcedStrategy(JoinMethod.SHUFFLE_HASH),
                      capacity_factor=2.0).execute(plan)
    salted = Executor(cat, SkewAwareStrategy(),
                      capacity_factor=2.0).execute(plan)
    assert forced.rows > 0
    assert rows_close(_rows(forced), _rows(salted))
    # A salted exchange that overflows doubles like a plain one: from a
    # budget too small for either side, the same result as from the
    # default budget, and no report with overflow is kept.
    tight = Executor(cat, SkewAwareStrategy(),
                     capacity_factor=0.25).execute(plan)
    assert tight.methods() == salted.methods()
    assert all(e.overflow_rows == 0 for d in tight.decisions
               for e in d.report.exchanges)
    assert rows_close(_rows(tight), _rows(salted))
    ss = cat.table("store_sales")
    cust = cat.table("customer")
    assert exchange.salted_shuffle(ss, "ss_customer_sk", cust,
                                   "c_customer_sk", 3, 0.25)[2].overflow_rows > 0
