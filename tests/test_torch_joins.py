"""The port's join engine against the JAX package's, on the same numpy
inputs: hashing, slotted scatter, exchanges, local joins, the three
distributed equi-join methods and group-by aggregation.

Integer columns, slot layouts and every byte count compare exactly; float
aggregates compare with ``rows_close`` (their summation order differs).
The JAX kernel path runs its Pallas kernels in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cost_model import JoinMethod as JJoinMethod
from repro.joins import aggregate as jagg
from repro.joins import exchange as jex
from repro.joins import local_join as jlj
from repro.joins import methods as jmethods
from repro.joins import slots as jslots
from repro.joins import table as jtable
from repro.joins.ref import ref_equi_join, rows_as_set, rows_close
from repro.kernels.bloom import _np_hash32
from repro_torch.core.cost_model import JoinMethod
from repro_torch.joins import aggregate, exchange, local_join, methods, slots
from repro_torch.joins import table as ttable

JOIN_TYPES = ["inner", "left_outer", "left_semi", "left_anti"]
METHODS = ["broadcast_hash", "shuffle_hash", "shuffle_sort"]


def both_tables(cols, p, capacity=None):
    """The same numpy columns as a (JAX, port) pair of stacked tables."""
    jt = jtable.partition_round_robin(jtable.from_numpy(cols, capacity), p)
    tt = ttable.partition_round_robin(
        ttable.from_numpy(cols, capacity, device="cpu"), p)
    return jt, tt


def assert_tables_equal(jt, tt):
    assert sorted(jt.columns) == sorted(tt.columns)
    assert jt.partitioned_by == tt.partitioned_by
    np.testing.assert_array_equal(np.asarray(jt.valid), tt.valid.numpy())
    for name, c in jt.columns.items():
        got = tt.columns[name]
        assert str(got.dtype).split(".")[-1] == str(c.dtype), name
        np.testing.assert_array_equal(np.asarray(c), got.numpy(), name)


def fact_dim(seed, na=400, nb=50, p=4, key_mult=2):
    rng = np.random.default_rng(seed)
    b = {"k": rng.permutation(nb).astype(np.int32),
         "payload": rng.integers(0, 99, nb).astype(np.int32),
         "w": rng.uniform(0, 1, nb).astype(np.float32)}
    a = {"k": rng.integers(0, nb * key_mult, na).astype(np.int32),
         "v": rng.uniform(0, 1, na).astype(np.float32),
         "q": rng.integers(1, 9, na).astype(np.int32)}
    return a, b, both_tables(a, p, na + 5), both_tables(b, p)


# ---------------------------------------------------------------------------
# hash32, slot_scatter
# ---------------------------------------------------------------------------

EXTREME_KEYS = np.array([-2**31, -2**31 + 1, -2, -1, 0, 1, 2, 12345,
                         2**31 - 2, 2**31 - 1], np.int32)


@pytest.mark.parametrize("seed", [jslots.SHUFFLE_SEED, jslots.BUCKET_SEED])
def test_hash32_bit_equal_on_extreme_keys(seed):
    keys = np.concatenate([EXTREME_KEYS, np.random.default_rng(0).integers(
        -2**31, 2**31 - 1, 1000, dtype=np.int64).astype(np.int32)])
    got = slots.hash32(torch.from_numpy(keys), int(seed)).numpy()
    np.testing.assert_array_equal(got, _np_hash32(keys, int(seed)))
    np.testing.assert_array_equal(
        got, np.asarray(jslots.hash32(jnp.asarray(keys), seed)))
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF


@pytest.mark.parametrize("p", [1, 3, 4, 8])
def test_dest_partition_equal(p):
    keys = np.concatenate([EXTREME_KEYS, np.arange(-500, 500, dtype=np.int32)])
    got = exchange._dest_partition(torch.from_numpy(keys), p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jex._dest_partition(jnp.asarray(keys), p)))


@pytest.mark.parametrize("n,nd,cap,seed", [(100, 4, 50, 1), (200, 8, 10, 2),
                                           (37, 1, 8, 3), (500, 5, 64, 4),
                                           (64, 16, 1, 5)])
def test_slot_scatter_equal(n, nd, cap, seed):
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, nd, (3, n)).astype(np.int32)
    valid = rng.uniform(size=(3, n)) < 0.8
    want = jax.vmap(lambda d, v: jslots.slot_scatter(d, v, nd, cap))(
        jnp.asarray(dest), jnp.asarray(valid))
    got = slots.slot_scatter(torch.from_numpy(dest), torch.from_numpy(valid),
                             nd, cap)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))


def test_pair_capacity_equal():
    for cap in (1, 8, 100, 12345):
        for nd in (1, 4, 8):
            for f in (0.5, 2.0, 8.0):
                assert (slots.pair_capacity(cap, nd, f)
                        == jslots.pair_capacity(cap, nd, f))


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

def test_from_numpy_casts_and_row_bytes():
    cols = {"i": np.arange(5, dtype=np.int64), "f": np.ones(5),
            "b": np.array([True, False, True, True, False])}
    jt, tt = both_tables(cols, 2, capacity=7)
    assert_tables_equal(jt, tt)
    assert tt.row_bytes == jt.row_bytes == 9
    assert tt.count() == jt.count() == 5
    tm, jm = tt.measure(), jt.measure()
    assert (tm.size_bytes, tm.cardinality, tm.source.value) == \
        (jm.size_bytes, jm.cardinality, jm.source.value)
    np.testing.assert_array_equal(
        ttable.concat_partitions(tt).valid.numpy(),
        np.asarray(jtable.concat_partitions(jt).valid))


@pytest.mark.parametrize("seed", range(3))
def test_compact_partitions_equal(seed):
    a, _, (ja, ta), _ = fact_dim(seed, na=300)
    rng = np.random.default_rng(seed)
    keep = rng.uniform(size=ta.valid.shape) < 0.3
    ja = ja.with_valid(ja.valid & jnp.asarray(keep))
    ta = ta.with_valid(ta.valid & torch.from_numpy(keep))
    assert_tables_equal(jtable.compact_partitions(ja),
                        ttable.compact_partitions(ta))


# ---------------------------------------------------------------------------
# Exchanges
# ---------------------------------------------------------------------------

def test_broadcast_equal():
    _, _, _, (jb, tb) = fact_dim(0)
    jfull, jrep = jex.broadcast(jb)
    tfull, trep = exchange.broadcast(tb)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert_tables_equal(jfull, tfull)


@pytest.mark.parametrize("factor", [2.0, 0.3])
@pytest.mark.parametrize("p", [2, 4])
def test_shuffle_equal(factor, p):
    """Same report field for field (overflow too, at factor 0.3) and the
    same received slots."""
    _, _, (ja, ta), _ = fact_dim(7, na=500, p=p, key_mult=1)
    jsh, jrep = jex.shuffle(ja, "k", factor)
    tsh, trep = exchange.shuffle(ta, "k", factor)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert (trep.overflow_rows > 0) == (factor < 1)
    assert_tables_equal(jsh, tsh)
    # A second shuffle on the same key is elided.
    assert dataclasses.asdict(exchange.shuffle(tsh, "k")[1]) == \
        dataclasses.asdict(jex.shuffle(jsh, "k")[1])


# ---------------------------------------------------------------------------
# Local joins
# ---------------------------------------------------------------------------

def _local_inputs(seed, p, na, nb, shared, key_mult=2):
    rng = np.random.default_rng(seed)
    ak = rng.integers(0, nb * key_mult, (p, na)).astype(np.int32)
    av = rng.uniform(size=(p, na)) < 0.9
    if shared:
        bk = rng.permutation(nb).astype(np.int32)
        bv = rng.uniform(size=nb) < 0.9
    else:
        bk = np.stack([rng.permutation(nb) for _ in range(p)]).astype(
            np.int32)
        bv = rng.uniform(size=(p, nb)) < 0.9
    return ak, av, bk, bv


def _jax_local(fn, ak, av, bk, bv, **kw):
    b_axis = None if bk.ndim == 1 else 0
    res = jax.vmap(lambda a, v, b, w: fn(a, v, b, w, **kw),
                   in_axes=(0, 0, b_axis, b_axis))(
        jnp.asarray(ak), jnp.asarray(av), jnp.asarray(bk), jnp.asarray(bv))
    return np.asarray(res.match_idx), np.asarray(res.found)


def _port_local(fn, ak, av, bk, bv, **kw):
    res = fn(*(torch.from_numpy(x) for x in (ak, av, bk, bv)), **kw)
    assert res.match_idx.dtype == torch.int32
    return res.match_idx.numpy(), res.found.numpy()


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("p,na,nb", [(2, 300, 64), (4, 200, 100)])
def test_hash_join_equal(use_kernel, shared, p, na, nb):
    ak, av, bk, bv = _local_inputs(p * na + nb, p, na, nb, shared)
    want = _jax_local(jlj.hash_join, ak, av, bk, bv, use_kernel=use_kernel)
    got = _port_local(local_join.hash_join, ak, av, bk, bv,
                      use_kernel=use_kernel)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_hash_join_kernel_path_keeps_probe_rows_of_full_buckets():
    """Few distinct probe keys fill one radix bucket past the reference's
    probe-slot capacity, which drops the rows beyond it. The port's kernel
    path lays such a bucket out over several probe tiles, so it agrees with
    the gather path, here and in the reference."""
    rng = np.random.default_rng(3)
    p, na, nb = 2, 400, 300
    ak = rng.choice(np.array([5, 17, 230], np.int32), (p, na))
    av = np.ones((p, na), bool)
    bk = rng.permutation(nb).astype(np.int32)
    bv = np.ones(nb, bool)
    gather = _jax_local(jlj.hash_join, ak, av, bk, bv, use_kernel=False)
    for use_kernel in (False, True):
        got = _port_local(local_join.hash_join, ak, av, bk, bv,
                          use_kernel=use_kernel)
        np.testing.assert_array_equal(got[0], gather[0])
        np.testing.assert_array_equal(got[1], gather[1])
    assert gather[1].all()


@pytest.mark.parametrize("use_kernel_sort", [False, True])
@pytest.mark.parametrize("nb", [64, 50])
def test_sort_join_equal(use_kernel_sort, nb):
    ak, av, bk, bv = _local_inputs(nb, 4, 150, nb, shared=False)
    want = _jax_local(jlj.sort_join, ak, av, bk, bv,
                      use_kernel_sort=use_kernel_sort)
    got = _port_local(local_join.sort_join, ak, av, bk, bv,
                      use_kernel_sort=use_kernel_sort)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# Distributed equi-join methods
# ---------------------------------------------------------------------------

def _report_dict(rep):
    return {"method": rep.method.value,
            "exchanges": [dataclasses.asdict(e) for e in rep.exchanges],
            "local_bytes": rep.local_bytes, "output_rows": rep.output_rows}


@pytest.mark.parametrize("join_type", JOIN_TYPES)
@pytest.mark.parametrize("method", METHODS)
def test_run_equi_join_equal(method, join_type):
    a, b, (ja, ta), (jb, tb) = fact_dim(METHODS.index(method) * 10
                                        + JOIN_TYPES.index(join_type))
    jout, jrep = jmethods.run_equi_join(JJoinMethod(method), ja, jb, "k",
                                        "k", join_type)
    tout, trep = methods.run_equi_join(JoinMethod(method), ta, tb, "k", "k",
                                       join_type)
    assert _report_dict(trep) == _report_dict(jrep)
    want = rows_as_set(ref_equi_join(a, b, "k", "k", join_type))
    assert rows_as_set(tout.to_numpy()) == want
    assert rows_as_set(jout.to_numpy()) == want
    assert tout.partitioned_by == jout.partitioned_by
    kout, krep = methods.run_equi_join(JoinMethod(method), ta, tb, "k", "k",
                                       join_type, use_kernel=True)
    assert rows_as_set(kout.to_numpy()) == want
    assert _report_dict(krep) == _report_dict(jrep)


@pytest.mark.parametrize("method", [JoinMethod.BROADCAST_NL,
                                    JoinMethod.CARTESIAN,
                                    JoinMethod.SALTED_SHUFFLE_HASH])
def test_later_slice_methods_raise(method):
    """Named for the guards these methods had before their slices: the
    salted shuffle hash join (the skew slice) and the nested-loop methods
    (the nested-loop slice) now run through ``run_equi_join`` and equal
    the reference's, report and rows."""
    a, b, (ja, ta), (jb, tb) = fact_dim(0)
    jout, jrep = jmethods.run_equi_join(JJoinMethod(method.value), ja, jb,
                                        "k", "k")
    tout, trep = methods.run_equi_join(method, ta, tb, "k", "k")
    assert _report_dict(trep) == _report_dict(jrep)
    assert rows_as_set(tout.to_numpy()) == rows_as_set(jout.to_numpy()) == \
        rows_as_set(ref_equi_join(a, b, "k", "k", "inner"))
    assert tout.partitioned_by is None


# ---------------------------------------------------------------------------
# Aggregation
# ---------------------------------------------------------------------------

AGGS = (("v", "sum"), ("v", "mean"), ("v", "min"), ("v", "max"),
        ("q", "sum"), ("q", "count"), ("q", "min"), ("q", "max"),
        ("q", "mean"))


@pytest.mark.parametrize("factor", [2.0, 0.3])
@pytest.mark.parametrize("seed", range(3))
def test_group_aggregate_equal(seed, factor):
    _, _, (ja, ta), _ = fact_dim(seed, na=600, nb=40)
    jout, jrep = jagg.group_aggregate(ja, "k", AGGS, factor)
    tout, trep = aggregate.group_aggregate(ta, "k", AGGS, factor)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert tout.partitioned_by == "k"
    jcols, tcols = jout.to_numpy(), tout.to_numpy()
    for name, c in jcols.items():
        assert tcols[name].dtype == c.dtype, name
    assert rows_close(rows_as_set(tcols), rows_as_set(jcols))


def test_global_aggregate_equal():
    _, _, (ja, ta), _ = fact_dim(5)
    want = jagg.global_aggregate(ja, AGGS)
    got = aggregate.global_aggregate(ta, AGGS)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
