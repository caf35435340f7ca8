"""The port's nested-loop joins against the JAX package's, on the CPU.

``BROADCAST_NL`` and ``CARTESIAN`` run through ``run_equi_join`` on the
reference's ``tests/test_joins.py`` tables (``make_tables``) and on
``tests/test_differential.py``'s adversarial cases, for every join type:
rows and every ``JoinReport`` byte must equal the reference's. The local
``nested_loop_join`` is held against the reference's on duplicate build
keys (the first match is kept), a non-equi predicate, empty and
all-invalid sides, and against itself with the chunk bound forced tiny.
"""

import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_differential import CAP_A, CAP_B, CASES, _case
from test_joins import make_tables

from repro.core.cost_model import JoinMethod as JJoinMethod
from repro.joins import local_join as jlj
from repro.joins import methods as jmethods
from repro.joins import table as jtable
from repro.joins.ref import ref_equi_join, rows_as_set
from repro_torch.core.cost_model import JoinMethod
from repro_torch.joins import broadcast_nl_join, cartesian_join, methods
from repro_torch.joins import local_join
from repro_torch.joins import table as ttable

NL_METHODS = ["broadcast_nl", "cartesian"]
JOIN_TYPES = ["inner", "left_outer", "left_semi", "left_anti"]


def _report_dict(rep):
    return {"method": rep.method.value,
            "exchanges": [dataclasses.asdict(e) for e in rep.exchanges],
            "local_bytes": rep.local_bytes, "output_rows": rep.output_rows}


def _port_table(cols, p, capacity=None):
    return ttable.partition_round_robin(
        ttable.from_numpy(cols, capacity, device="cpu"), p)


def _assert_same_join(method, ja, jb, ta, tb, join_type, want=None):
    jout, jrep = jmethods.run_equi_join(JJoinMethod(method), ja, jb, "k",
                                        "k", join_type)
    tout, trep = methods.run_equi_join(JoinMethod(method), ta, tb, "k", "k",
                                       join_type)
    assert _report_dict(trep) == _report_dict(jrep)
    got = rows_as_set(tout.to_numpy())
    assert got == rows_as_set(jout.to_numpy())
    if want is not None:
        assert got == want
    assert tout.partitioned_by == jout.partitioned_by
    return tout


@pytest.mark.parametrize("join_type", JOIN_TYPES)
@pytest.mark.parametrize("method", NL_METHODS)
def test_nl_methods_equal_reference_on_make_tables(method, join_type):
    """``tests/test_joins.py``'s tables (400 x 50 rows, p = 4)."""
    a, b, ja, jb = make_tables()
    a, b = a.to_numpy(), b.to_numpy()
    want = rows_as_set(ref_equi_join(a, b, "k", "k", join_type))
    _assert_same_join(method, ja, jb, _port_table(a, 4), _port_table(b, 4),
                      join_type, want)


@pytest.mark.parametrize("join_type", JOIN_TYPES)
@pytest.mark.parametrize("p", [1, 8])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("method", NL_METHODS)
def test_nl_methods_equal_reference_on_adversarial_cases(method, case, p,
                                                         join_type):
    """``tests/test_differential.py``'s grid: Zipf-skewed and all-duplicate
    probe keys, disjoint ranges, empty sides, every side padded to the
    grid's fixed capacities."""
    rng = np.random.default_rng(zlib.crc32(f"{case}/{p}".encode()))
    a_keys, b_keys = _case(case, rng)
    a = {"k": a_keys, "v": np.arange(len(a_keys), dtype=np.int32)}
    b = {"k": b_keys, "payload": np.arange(len(b_keys), dtype=np.int32) * 7}
    ja = jtable.partition_round_robin(jtable.from_numpy(a, CAP_A), p)
    jb = jtable.partition_round_robin(jtable.from_numpy(b, CAP_B), p)
    # The numpy oracle cannot gather a left outer join's payload from an
    # empty build; there the reference's rows alone are the yardstick.
    want = (None if join_type == "left_outer" and not len(b_keys) else
            rows_as_set(ref_equi_join(a, b, "k", "k", join_type)))
    _assert_same_join(method, ja, jb, _port_table(a, p, CAP_A),
                      _port_table(b, p, CAP_B), join_type, want)


@pytest.mark.parametrize("fn", [broadcast_nl_join, cartesian_join])
def test_nl_methods_take_a_row_predicate(fn):
    """The methods themselves take any row predicate, as the reference's:
    a band predicate that matches several build rows keeps the first."""
    a, b, ja, jb = make_tables(seed=4)
    ta, tb = _port_table(a.to_numpy(), 4), _port_table(b.to_numpy(), 4)
    def pred(ac, bc):
        return (ac["k"] >= bc["k"]) & (ac["k"] < bc["k"] + 5)

    jfn = getattr(jmethods, fn.__name__)
    for jt in JOIN_TYPES:
        tout, trep = fn(ta, tb, pred, jt, "k")
        jout, jrep = jfn(ja, jb, pred, jt, "k")
        assert _report_dict(trep) == _report_dict(jrep)
        assert rows_as_set(tout.to_numpy()) == rows_as_set(jout.to_numpy())


# ---------------------------------------------------------------------------
# The local nested-loop join
# ---------------------------------------------------------------------------

def _local_both(a_keys, a_valid, b_keys, b_valid, predicate, **kw):
    """(port, reference) results of one local join; the port takes every
    partition at once, the reference one partition per call."""
    got = local_join.nested_loop_join(
        {"k": torch.from_numpy(a_keys)}, torch.from_numpy(a_valid),
        {"k": torch.from_numpy(b_keys)}, torch.from_numpy(b_valid),
        predicate, **kw)
    want = [jlj.nested_loop_join({"k": jnp.asarray(ak)}, jnp.asarray(av),
                                 {"k": jnp.asarray(b_keys)},
                                 jnp.asarray(b_valid), predicate)
            for ak, av in zip(a_keys, a_valid)]
    return got, want


def _assert_local_equal(got, want):
    np.testing.assert_array_equal(
        got.match_idx.numpy(),
        np.stack([np.asarray(w.match_idx) for w in want]))
    np.testing.assert_array_equal(
        got.found.numpy(), np.stack([np.asarray(w.found) for w in want]))
    assert got.match_idx.dtype == torch.int32


EQ = lambda ac, bc: ac["k"] == bc["k"]  # noqa: E731
LT = lambda ac, bc: ac["k"] < bc["k"]  # noqa: E731


@pytest.mark.parametrize("predicate", [EQ, LT], ids=["eq", "lt"])
def test_first_match_kept_on_ties(predicate):
    """Build keys repeat: every probe row keeps the least matching build
    index, under equality and under ``<`` (many matches per row)."""
    b_keys = np.array([3, 5, 3, 3, 9, 5, 1], np.int32)
    b_valid = np.array([1, 1, 1, 1, 1, 1, 1], bool)
    a_keys = np.array([[3, 5, 9, 1, 4, 0], [5, 3, 3, 2, 8, 10]], np.int32)
    a_valid = np.ones_like(a_keys, bool)
    got, want = _local_both(a_keys, a_valid, b_keys, b_valid, predicate)
    _assert_local_equal(got, want)
    idx = got.match_idx.numpy()
    for r, row in enumerate(a_keys):
        for i, k in enumerate(row):
            hits = [j for j, bk in enumerate(b_keys)
                    if (bk == k if predicate is EQ else k < bk)]
            assert idx[r, i] == (hits[0] if hits else -1)
    # With the first copy of key 3 invalid, the next copy is kept.
    b_valid[0] = False
    got, want = _local_both(a_keys, a_valid, b_keys, b_valid, predicate)
    _assert_local_equal(got, want)


@pytest.mark.parametrize("side", ["probe", "build", "both"])
def test_all_invalid_sides(side):
    rng = np.random.default_rng(1)
    a_keys = rng.integers(0, 8, (3, 10)).astype(np.int32)
    b_keys = rng.permutation(8).astype(np.int32)
    a_valid = np.full(a_keys.shape, side == "build")
    b_valid = np.full(b_keys.shape, side == "probe")
    got, want = _local_both(a_keys, a_valid, b_keys, b_valid, EQ)
    _assert_local_equal(got, want)
    assert not got.found.any() and (got.match_idx == -1).all()


@pytest.mark.parametrize("na,nb", [(0, 5), (5, 0), (0, 0)])
def test_empty_sides(na, nb):
    """Zero-capacity sides: no probe row finds a match. The reference's
    ``jnp.argmax`` raises on a zero-capacity build; the port returns no
    match there, the numpy oracle's answer."""
    a_keys = np.zeros((2, na), np.int32)
    b_keys = np.zeros(nb, np.int32)
    got = local_join.nested_loop_join(
        {"k": torch.from_numpy(a_keys)}, torch.ones(2, na, dtype=torch.bool),
        {"k": torch.from_numpy(b_keys)}, torch.ones(nb, dtype=torch.bool),
        EQ)
    assert got.match_idx.shape == got.found.shape == (2, na)
    assert not got.found.any() and (got.match_idx == -1).all()
    if nb:
        _, want = _local_both(a_keys, np.ones((2, na), bool), b_keys,
                              np.ones(nb, bool), EQ)
        _assert_local_equal(got, want)


@pytest.mark.parametrize("max_pairs", [1, 7, 64, 1000])
@pytest.mark.parametrize("predicate", [EQ, LT], ids=["eq", "lt"])
def test_chunked_equals_unchunked(max_pairs, predicate):
    """A bound far below the pair count splits the probe rows into many
    chunks (one row a chunk at ``max_pairs`` = 1, and chunks that straddle
    partitions); the result is the one-chunk result and the reference's."""
    rng = np.random.default_rng(max_pairs)
    a_keys = rng.integers(0, 40, (4, 37)).astype(np.int32)
    a_valid = rng.random((4, 37)) < 0.8
    b_keys = rng.integers(0, 40, 23).astype(np.int32)
    b_valid = rng.random(23) < 0.9
    whole, want = _local_both(a_keys, a_valid, b_keys, b_valid, predicate)
    chunked = local_join.nested_loop_join(
        {"k": torch.from_numpy(a_keys)}, torch.from_numpy(a_valid),
        {"k": torch.from_numpy(b_keys)}, torch.from_numpy(b_valid),
        predicate, max_pairs=max_pairs)
    assert local_join.nl_chunk_rows(23, max_pairs) == max(1, max_pairs // 23)
    assert torch.equal(chunked.match_idx, whole.match_idx)
    assert torch.equal(chunked.found, whole.found)
    _assert_local_equal(chunked, want)
