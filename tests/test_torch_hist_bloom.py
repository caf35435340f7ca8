"""The masked histogram (K1) and the bloom probe's branches (K5), on the CPU.

The CUDA kernels (``csrc/partition_hist.cu``, ``csrc/bloom.cu``) run only on
a card, where ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold every
branch against the plain versions. Here:

- the plain ``partition_hist`` with a validity mask equals the JAX
  package's interpret-mode kernel on ``where(valid, dest, -1)``, also on
  views that start off a 16-byte boundary and lengths that are not a
  multiple of 4;
- ``_exchange_by_dest``, which now hands the mask to the histogram instead
  of a ``where`` pass, reports the reference's bytes on tables with invalid
  rows;
- the wrappers' branch choices by size (``hist_branch``,
  ``filter_fits_shared``) at their edges, and that CPU tensors count no
  launch;
- ``chip_smoke.py``'s restated bound: integer operations at 16.75e12/s,
  and the bloom probe's least work counted from the data.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.joins import exchange as jex
from repro.joins import table as jtable
from repro.kernels.partition_hist import partition_hist as j_hist
from repro_torch.joins import exchange
from repro_torch.joins import table as ttable
from repro_torch.kernels import bloom, ops, ref
from repro_torch.kernels.bloom import (bloom_build, bloom_probe,
                                       filter_fits_shared)
from repro_torch.kernels.partition_hist import hist_branch, partition_hist

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_hist_bloom_tests", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# K1: the masked histogram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nd", [1, 8, 17, 128])
def test_masked_hist_matches_pallas_on_where(nd):
    rng = np.random.default_rng(nd)
    d = rng.integers(-1, nd + 2, size=3001).astype(np.int32)
    valid = rng.random(3001) < 0.6
    want = np.asarray(j_hist(jnp.where(jnp.asarray(valid), jnp.asarray(d),
                                       -1), nd=nd, interpret=True))
    got = partition_hist(t(d), nd=nd, valid=t(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ops.hist(t(d), nd, t(valid)).numpy(), want)
    np.testing.assert_array_equal(
        ref.partition_hist_ref(t(d), nd, t(valid)).numpy(), want)


@pytest.mark.parametrize("d0,v0,n", [(1, 1, 1001), (3, 0, 998), (2, 3, 7),
                                     (1, 2, 3), (0, 0, 1002)])
def test_masked_hist_on_views_and_odd_lengths(d0, v0, n):
    """Views 1-3 elements past their base (off a 16-byte boundary for the
    kernel), mask and destinations at different offsets, n % 4 != 0."""
    rng = np.random.default_rng(n)
    d = rng.integers(-1, 10, size=1010).astype(np.int32)
    valid = rng.random(1010) < 0.5
    dv, vv = t(d)[d0:d0 + n], t(valid)[v0:v0 + n]
    sel = d[d0:d0 + n][valid[v0:v0 + n]]
    want = np.bincount(sel[(sel >= 0) & (sel < 8)], minlength=8)
    np.testing.assert_array_equal(
        partition_hist(dv, nd=8, valid=vv).numpy(), want)
    whole = d[d0:d0 + n]
    np.testing.assert_array_equal(
        partition_hist(dv, nd=8).numpy(),
        np.bincount(whole[(whole >= 0) & (whole < 8)], minlength=8))


def test_masked_hist_rejects_a_bad_mask():
    d = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        partition_hist(d, nd=4, valid=torch.ones(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        partition_hist(d, nd=4, valid=torch.ones(7, dtype=torch.bool))


@pytest.mark.parametrize("nd,branch", [
    (1, "registers"), (4, "registers"), (8, "registers"), (9, "shared"),
    (16, "shared"), (17, "shared"), (128, "shared"), (12288, "shared"), (12289, "global"),
    (20000, "global")])
def test_hist_branch_by_nd(nd, branch):
    assert hist_branch(nd) == branch


@pytest.mark.parametrize("kind", ["shuffle", "hypercube"])
@pytest.mark.parametrize("p", [2, 8])
def test_exchange_report_with_invalid_rows_equals_reference(p, kind):
    """The straggler count now comes from the masked histogram: the
    report stays the reference's field for field on a table whose invalid
    rows carry live-looking destinations."""
    rng = np.random.default_rng(p)
    n = 700
    cols = {"k": rng.integers(0, 50, n).astype(np.int32),
            "v": rng.uniform(0, 1, n).astype(np.float32)}
    jt = jtable.partition_round_robin(jtable.from_numpy(cols, n + 9), p)
    tt = ttable.partition_round_robin(
        ttable.from_numpy(cols, n + 9, device="cpu"), p)
    keep = rng.random(np.asarray(jt.valid).shape) < 0.6
    jt = jt.with_valid(jt.valid & jnp.asarray(keep))
    tt = tt.with_valid(tt.valid & torch.from_numpy(keep))
    # Skewed destinations, so that the hottest one depends on the mask.
    dest = np.minimum(rng.geometric(0.3, keep.shape) - 1, p - 1).astype(
        np.int32)
    pair_cap = 4 * keep.shape[1] // p
    _, jrep = jex._exchange_by_dest(jt, jnp.asarray(dest), pair_cap, None,
                                    kind)
    _, trep = exchange._exchange_by_dest(tt, t(dest), pair_cap, None, kind)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    live = dest[np.asarray(jt.valid)]
    assert trep.straggler_bytes == np.bincount(live, minlength=p).max() * \
        tt.row_bytes


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    before = (partition_hist.launches, dict(partition_hist.branch_launches),
              bloom_probe.launches, dict(bloom_probe.filter_launches))
    d = t(np.array([0, 3, 3, -1, 9], np.int32))
    valid = t(np.array([True, True, False, True, True]))
    assert partition_hist(d, nd=4, valid=valid).tolist() == [1, 0, 0, 1]
    words = bloom_build(d, m_bits=1 << 21, k=3)
    assert bloom_probe(d, words, k=3).all()
    assert before == (partition_hist.launches, partition_hist.branch_launches,
                      bloom_probe.launches, bloom_probe.filter_launches)


# ---------------------------------------------------------------------------
# K5: the bloom probe's filter branches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m_bits,fits", [
    (32, True), (65_536, True), (1 << 20, True),
    (232_448 * 8, True), (232_448 * 8 + 32, False), (1 << 21, False),
    (1 << 22, False)])
def test_filter_fits_shared_at_the_227_kb_edge(m_bits, fits):
    assert filter_fits_shared(m_bits) is fits
    assert (m_bits // 8 <= bloom.SHARED_FILTER_BYTES) is fits


@pytest.mark.parametrize("m_bits,k", [(1 << 16, 1), (1 << 16, 8),
                                      (1 << 21, 5), (1 << 22, 8)])
def test_probe_on_views_equals_the_positions_rule(m_bits, k):
    """Keys 1-3 past their base (off a 16-byte boundary for the kernel),
    odd lengths, and the shared/device branch sizes: the plain probe keeps
    exactly the keys whose k positions are all set."""
    rng = np.random.default_rng(k)
    keys = t(rng.integers(-(2 ** 31), 2 ** 31 - 1, 5003,
                          dtype=np.int64).astype(np.int32))
    words = bloom_build(keys[:300], m_bits=m_bits, k=k)
    bits = (words.long() & 0xFFFFFFFF)
    for off in (1, 2, 3):
        kv = keys[off:]
        want = torch.ones(kv.shape, dtype=torch.bool)
        for i in range(k):
            pos = ref.bloom_positions(kv, i, m_bits)
            want &= ((bits[pos >> 5] >> (pos & 31)) & 1).bool()
        got = bloom_probe(kv, words, k=k)
        assert torch.equal(got, want)
        assert bool(got[:300 - off].all())


# ---------------------------------------------------------------------------
# The restated bound
# ---------------------------------------------------------------------------

def test_integer_peak_is_the_published_float32_rate_restated():
    assert cs.PEAK_INT_OPS_PER_S == pytest.approx(16.75e12)
    ms, by = cs.bound(0.0, 16.75e9)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_hist_least_work_at_the_main_path_shape():
    n = 8_388_608
    assert cs.hist_least_work(n, 8, True) == (5 * n + 32, n)
    ms, by = cs.bound(*cs.hist_least_work(n, 8, True))
    assert by == "bytes" and ms == pytest.approx(0.01252032, rel=1e-6)
    ms, by = cs.bound(*cs.hist_least_work(n, 8, False))
    assert by == "bytes" and ms == pytest.approx(0.01001626, rel=1e-6)


def test_bloom_probe_least_work_counts_the_bits_the_data_tests():
    """Each key stops at its first clear bit: build keys test all k,
    rejected keys 1 or more. Kept keys make the probe operation-bound."""
    rng = np.random.default_rng(3)
    build = t(rng.integers(0, 1 << 30, 500).astype(np.int32))
    words = bloom_build(build, m_bits=1 << 16, k=8)
    nbytes, n_ops = cs.bloom_probe_least_work(build, words, 8)
    assert nbytes == 5 * 500 + (1 << 16) // 8
    assert n_ops == 13 * 500 + 7 * 8 * 500
    others = t(rng.integers(-(2 ** 31), -1, 500).astype(np.int32))
    _, ops_others = cs.bloom_probe_least_work(others, words, 8)
    assert 13 * 500 + 7 * 500 <= ops_others < 13 * 500 + 7 * 2 * 500
    big = build.repeat(200)
    assert cs.bound(*cs.bloom_probe_least_work(big, words, 8))[1] == \
        "operations"
