"""The port's three kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain version (``repro_torch.kernels.ref``);
the JAX side runs the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it, and its jnp oracle. Inputs come from
numpy with a seed and are handed to both. All comparisons are exact; the
bitonic sort is not stable, so it is checked the way ``test_kernels.py``
checks it (sorted keys, and the values address those keys).

The CUDA kernels themselves are held against the plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.kernels.bitonic_sort import bitonic_sort_tile as j_bitonic
from repro.kernels.partition_hist import partition_hist as j_hist
from repro.kernels.tiled_probe import tiled_probe as j_probe
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bitonic_sort import MAX_TILE, bitonic_sort_tile
from repro_torch.kernels.partition_hist import partition_hist
from repro_torch.kernels.tiled_probe import tiled_probe


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def np_(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# K2 tiled_probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("na,nb", [(1, 1), (7, 5), (8, 128), (100, 100),
                                   (300, 700), (1000, 64), (2048, 2048)])
def test_probe_matches_pallas(na, nb):
    rng = np.random.default_rng(na * 1000 + nb)
    a = rng.integers(0, max(nb // 2, 2), size=na).astype(np.int32)
    b = rng.permutation(max(nb, 1)).astype(np.int32)[:nb]
    want = np_(j_probe(jnp.asarray(a), jnp.asarray(b), interpret=True))
    np.testing.assert_array_equal(tiled_probe(t(a), t(b)).numpy(), want)
    np.testing.assert_array_equal(
        ref.tiled_probe_ref(t(a[None]), t(b[None]))[0].numpy(),
        np_(jref.tiled_probe_ref(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("seed", range(6))
def test_probe_batched_rows_match_pallas_per_row(seed):
    """One batched call equals the reference's kernel run row by row, with
    duplicate build keys and both sentinels in the data."""
    rng = np.random.default_rng(seed)
    bsz, na, nb = int(rng.integers(1, 6)), int(rng.integers(1, 300)), \
        int(rng.integers(1, 300))
    a = rng.integers(-1, 40, (bsz, na)).astype(np.int32)
    b = rng.integers(-2, 40, (bsz, nb)).astype(np.int32)
    got = tiled_probe(t(a), t(b)).numpy()
    for r in range(bsz):
        want = np_(j_probe(jnp.asarray(a[r]), jnp.asarray(b[r]),
                           interpret=True))
        np.testing.assert_array_equal(got[r], want)


def test_probe_first_match_semantics():
    got = tiled_probe(t(np.array([5, 9, 5], np.int32)),
                      t(np.array([1, 5, 3, 5], np.int32)))
    np.testing.assert_array_equal(got.numpy(), [1, -1, 1])


def test_probe_sentinels_never_match():
    got = tiled_probe(t(np.array([-1, -1, 3], np.int32)),
                      t(np.array([-2, 3, -2], np.int32)))
    np.testing.assert_array_equal(got.numpy(), [-1, -1, 1])


def test_probe_empty_rows():
    assert tiled_probe(torch.zeros(3, 0, dtype=torch.int32),
                       torch.zeros(3, 4, dtype=torch.int32)).shape == (3, 0)
    got = tiled_probe(torch.zeros(2, 5, dtype=torch.int32),
                      torch.zeros(2, 0, dtype=torch.int32))
    assert (got == -1).all() and got.shape == (2, 5)


def test_probe_rejects_bad_input():
    with pytest.raises(TypeError):
        tiled_probe(torch.zeros(4, dtype=torch.float32),
                    torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError):
        j_probe(jnp.zeros(4, jnp.float32), jnp.zeros(4, jnp.int32))
    with pytest.raises(ValueError):
        tiled_probe(torch.zeros(2, 4, dtype=torch.int32),
                    torch.zeros(3, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        tiled_probe(torch.zeros(4, dtype=torch.int32),
                    torch.zeros(1, 4, dtype=torch.int32))


# ---------------------------------------------------------------------------
# K1 partition_hist
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,nd", [(1, 2), (100, 4), (1024, 8), (5000, 16),
                                  (10000, 128), (3, 1), (0, 4)])
def test_hist_matches_pallas(n, nd):
    rng = np.random.default_rng(n + nd)
    # -1 (invalid) and values >= nd are both left uncounted.
    d = rng.integers(-1, nd + 2, size=n).astype(np.int32)
    got = partition_hist(t(d), nd=nd).numpy()
    if n:
        np.testing.assert_array_equal(
            got, np_(j_hist(jnp.asarray(d), nd=nd, interpret=True)))
    np.testing.assert_array_equal(
        got, np.bincount(d[(d >= 0) & (d < nd)], minlength=nd))
    assert got.dtype == np.int32


def test_hist_all_invalid_and_conservation():
    assert int(partition_hist(torch.full((999,), -1, dtype=torch.int32),
                              nd=8).sum()) == 0
    rng = np.random.default_rng(0)
    d = rng.integers(0, 7, size=999).astype(np.int32)
    assert int(partition_hist(t(d), nd=7).sum()) == 999
    np.testing.assert_array_equal(
        ref.partition_hist_ref(t(d), 7).numpy(),
        np_(jref.partition_hist_ref(jnp.asarray(d), 7)))


def test_hist_rejects_bad_input():
    with pytest.raises(TypeError):
        partition_hist(torch.zeros(4, dtype=torch.int64), nd=4)
    with pytest.raises(TypeError):
        j_hist(jnp.zeros(4, jnp.float32), nd=4)
    with pytest.raises(ValueError):
        partition_hist(torch.zeros(2, 4, dtype=torch.int32), nd=4)


# ---------------------------------------------------------------------------
# K3 bitonic_sort_tile
# ---------------------------------------------------------------------------

def _assert_sorted_pairs(k, gk, gv):
    """gk is k sorted, and gv addresses the key it travels with."""
    np.testing.assert_array_equal(gk, np.sort(k, axis=-1))
    np.testing.assert_array_equal(np.take_along_axis(k, gv, axis=-1), gk)


@pytest.mark.parametrize("n", [2, 8, 64, 1024, 4096])
def test_bitonic_matches_pallas(n):
    rng = np.random.default_rng(n)
    k = rng.integers(-100, 100, size=n).astype(np.int32)  # duplicates
    v = np.arange(n, dtype=np.int32)
    gk, gv = bitonic_sort_tile(t(k), t(v))
    jk, jv = j_bitonic(jnp.asarray(k), jnp.asarray(v), interpret=True)
    np.testing.assert_array_equal(gk.numpy(), np_(jk))
    _assert_sorted_pairs(k, gk.numpy(), gv.numpy())
    _assert_sorted_pairs(k, np_(jk), np_(jv))


@pytest.mark.parametrize("logn", range(0, 13))
def test_bitonic_batched_every_pow2(logn):
    n = 1 << logn
    rng = np.random.default_rng(logn)
    k = rng.integers(-2**31, 2**31 - 1, size=(3, n), dtype=np.int64
                     ).astype(np.int32)
    k[:, ::3] = 7  # duplicates
    v = np.tile(np.arange(n, dtype=np.int32), (3, 1))
    gk, gv = bitonic_sort_tile(t(k), t(v))
    _assert_sorted_pairs(k, gk.numpy(), gv.numpy())


def test_bitonic_with_duplicates_and_negatives():
    k = np.asarray([3, -1, 3, 0, -5, 3, 7, -1], np.int32)
    v = np.arange(8, dtype=np.int32)
    gk, gv = ops.sort_pairs(t(k), t(v))
    _assert_sorted_pairs(k, gk.numpy(), gv.numpy())


def test_sort_pairs_non_pow2_is_the_stable_sort():
    """Outside the kernel's shapes the reference's ``jnp.argsort`` (stable)
    runs; so does the port's, values included."""
    from repro.kernels import ops as jops
    k = np.asarray([5, 1, 4, 1, 3, 1], np.int32)
    v = np.arange(6, dtype=np.int32)
    for n in (6, 8192):
        kk = np.resize(k, n).astype(np.int32)
        vv = np.arange(n, dtype=np.int32)
        gk, gv = ops.sort_pairs(t(kk), t(vv))
        jk, jv = jops.sort_pairs(jnp.asarray(kk), jnp.asarray(vv))
        np.testing.assert_array_equal(gk.numpy(), np_(jk))
        np.testing.assert_array_equal(gv.numpy(), np_(jv))
    assert ops.sort_pairs(t(k), t(v))[1].tolist() == [1, 3, 5, 4, 2, 0]


def test_bitonic_rejects_bad_input():
    with pytest.raises(ValueError):
        bitonic_sort_tile(torch.zeros(6, dtype=torch.int32),
                          torch.zeros(6, dtype=torch.int32))
    with pytest.raises(ValueError):
        bitonic_sort_tile(torch.zeros(2 * MAX_TILE, dtype=torch.int32),
                          torch.zeros(2 * MAX_TILE, dtype=torch.int32))
    with pytest.raises(TypeError):
        bitonic_sort_tile(torch.zeros(8, dtype=torch.float32),
                          torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        j_bitonic(jnp.zeros(6, jnp.int32), jnp.zeros(6, jnp.int32))


def test_plain_versions_do_not_count_launches():
    ops.reset_launch_counts()
    partition_hist(torch.zeros(8, dtype=torch.int32), nd=2)
    tiled_probe(torch.zeros(2, 8, dtype=torch.int32),
                torch.zeros(2, 8, dtype=torch.int32))
    bitonic_sort_tile(torch.zeros(2, 8, dtype=torch.int32),
                      torch.zeros(2, 8, dtype=torch.int32))
    words = ops.bloom_build(torch.zeros(8, dtype=torch.int32), m_bits=64,
                            k=2)
    ops.bloom_probe(torch.zeros(8, dtype=torch.int32), words, k=2)
    ops.key_range(torch.zeros(8, dtype=torch.int32))
    z = torch.zeros(2, 8, dtype=torch.int32)
    ops.probe3(z, z, z, z)
    ops.move_rows({"z": z}, z)
    assert ops.launch_counts() == {"partition_hist": 0, "tiled_probe": 0,
                                   "bitonic_sort_tile": 0, "bloom_build": 0,
                                   "bloom_probe": 0, "key_range": 0,
                                   "tiled_probe3": 0, "move_rows": 0}
