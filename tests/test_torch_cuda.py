"""The port on an NVIDIA card: each CUDA kernel against its plain version,
and the main path, the text-only and skew-target suites, the skew-aware
path, the runtime-filter path, the reordering and hypercube path, the
query service and the nested-loop joins on the card against the same paths
on the CPU, the distributed twins on the card (4 ranks under gloo, 1
under NCCL) against the global view, and the dense decoder's smoke configs
on the card against the CPU.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the JAX package, and uses no fixture of
``conftest.py``, so on a machine without JAX it runs as

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.joins.ref import rows_as_set, rows_close
from repro_torch.joins.slots import BUCKET_SEED, SHUFFLE_SEED
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bitonic_sort import bitonic_sort_tile
from repro_torch.kernels.bloom import (ONE_CLUSTER_KEYS, bloom_build,
                                       bloom_probe, build_branch,
                                       filter_fits_shared)
from repro_torch.kernels.build import library
from repro_torch.kernels.partition_hist import (HIST_BRANCHES, hist_branch,
                                                partition_hist)
from repro_torch.kernels.tiled_probe import (tiled_probe, tiled_probe3,
                                             tables_fit_shared)
from repro_torch.kernels.zone_map import (ONE_BLOCK_KEYS, RANGE_BRANCHES,
                                          key_range, range_branch)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions")
    return torch.device("cuda")


def on(dev, a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("n,nd", [(0, 4), (31, 8), (100_003, 128),
                                  (3_000_000, 8), (50_000, 20000),
                                  (1_000_003, 1), (1_000_003, 9),
                                  (1_000_003, 16),
                                  (1_000_003, 17), (1_000_003, 12288),
                                  (1_000_003, 12289), (1_000_003, 20000)])
def test_hist_equals_plain(cuda, n, nd):
    d = on(cuda, np.random.default_rng(n).integers(-1, nd + 2, n).astype(
        np.int32))
    before = ops.launch_counts()["partition_hist"]
    assert torch.equal(partition_hist(d, nd=nd), ref.partition_hist_ref(d, nd))
    assert ops.launch_counts()["partition_hist"] == before + (n > 0)


# Every branch of the kernel (registers nd <= 8, shared <= 12288, global
# beyond), with and without the mask, on views that start 0-3 elements
# past an aligned base (dest and mask independently) and lengths that are
# not a multiple of 4.
@pytest.mark.parametrize("nd", [1, 8, 9, 16, 17, 12288, 12289, 20000])
def test_hist_masked_views_equal_plain(cuda, nd):
    rng = np.random.default_rng(nd)
    d = on(cuda, rng.integers(-1, nd + 2, 200_011).astype(np.int32))
    v = on(cuda, rng.random(200_011) < 0.7)
    branch = hist_branch(nd)
    before = partition_hist.branch_launches[branch]
    calls = 0
    for d0, v0, n in ((0, 0, 200_000), (1, 1, 199_999), (3, 0, 100_001),
                      (2, 3, 150_002), (1, 2, 7), (3, 3, 2)):
        dv, vv = d[d0:d0 + n], v[v0:v0 + n]
        assert torch.equal(partition_hist(dv, nd=nd, valid=vv),
                           ref.partition_hist_ref(dv, nd, vv)), (d0, v0, n)
        assert torch.equal(partition_hist(dv, nd=nd),
                           ref.partition_hist_ref(dv, nd)), (d0, v0, n)
        calls += 2
    assert partition_hist.branch_launches[branch] == before + calls


@pytest.mark.parametrize("nd", [8, 17, 20000])
def test_hist_all_invalid_and_one_bin(cuda, nd):
    n = 1_000_001
    d = torch.full((n,), nd - 1, dtype=torch.int32, device=cuda)
    none = torch.zeros(n, dtype=torch.bool, device=cuda)
    assert int(partition_hist(d, nd=nd, valid=none).sum()) == 0
    assert int(partition_hist(torch.full_like(d, -1), nd=nd).sum()) == 0
    got = partition_hist(d, nd=nd)
    assert int(got[nd - 1]) == n and int(got.sum()) == n


# Long per-thread runs, all in one bin: the packed 8-bit lanes must flush
# to their 32-bit totals before they overflow.
@pytest.mark.parametrize("n", [2 ** 31 // 64, 2 ** 28 + 3])
def test_hist_packed_counters_flush(cuda, n):
    for bin_ in (0, 7):
        d = torch.full((n,), bin_, dtype=torch.int32, device=cuda)
        got = partition_hist(d, nd=8)
        assert int(got[bin_]) == n and int(got.sum()) == n
        del d
    d = torch.randint(-1, 9, (n,), dtype=torch.int32, device=cuda)
    v = torch.rand(n, device=cuda) < 0.9
    assert torch.equal(partition_hist(d, nd=8, valid=v),
                       ref.partition_hist_ref(d, 8, v))


# Calls in flight on two streams at once, each with its own accumulator.
@pytest.mark.parametrize("nd", [8, 17, 20000])
def test_hist_two_streams_at_once(cuda, nd):
    rng = np.random.default_rng(nd + 1)
    inputs = [on(cuda, rng.integers(-1, nd + 1, 4_000_000).astype(np.int32))
              for _ in range(2)]
    want = [ref.partition_hist_ref(d, nd) for d in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(20):
        for i, (s, d) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(s):
                got[i].append(partition_hist(d, nd=nd))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(g, want[i]) for g in got[i])


# The kernel launches the branch the wrapper passes it, and refuses the
# register branch for more bins than its packed words hold.
def test_hist_register_branch_refuses_more_than_8_bins(cuda):
    d = torch.zeros(1000, dtype=torch.int32, device=cuda)
    ws = torch.zeros(10, dtype=torch.int32, device=cuda)
    out = torch.empty(9, dtype=torch.int32, device=cuda)
    err = library().repro_partition_hist(
        d.data_ptr(), None, d.numel(), 9, HIST_BRANCHES.index("registers"),
        ws.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert err != 0


def _chip_smoke():
    """``chip_smoke.py``'s edge-case generators (it imports no JAX)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def table_branch(*ns):
    return "shared" if tables_fit_shared(*ns) else "device"


# "random": keys from a narrow range (duplicates, hits and misses); the
# other kinds are chip_smoke.py's first-match table edge cases: one radix
# bucket's hash32 residue, all-equal builds, the int32 ends and sentinels.
# nb = 100,000 takes the tables in device memory.
@pytest.mark.parametrize("bsz,na,nb,kind", [
    (1, 1, 1, "random"), (5, 300, 700, "random"), (2, 1000, 5000, "random"),
    (64, 960, 129, "random"), (256, 2048, 129, "one residue"),
    (64, 960, 129, "all equal"), (3, 5000, 4700, "extremes"),
    (2, 20_000, 100_000, "one residue"), (2, 20_000, 100_000, "all equal"),
    (2, 20_000, 100_000, "extremes")])
def test_probe_equals_plain(cuda, bsz, na, nb, kind):
    rng = np.random.default_rng(na + nb)
    if kind == "random":
        a = rng.integers(-1, nb // 2 + 2, (bsz, na)).astype(np.int32)
        b = rng.integers(-2, nb // 2 + 2, (bsz, nb)).astype(np.int32)
    else:
        a, b = _chip_smoke().probe_edge_keys(rng, bsz, na, nb, BUCKET_SEED,
                                             64, kind)
    a, b = on(cuda, a), on(cuda, b)
    branch = table_branch(nb)
    before = tiled_probe.table_launches[branch]
    assert torch.equal(tiled_probe(a, b), ref.tiled_probe_ref(a, b))
    assert tiled_probe.table_launches[branch] == before + 1


@pytest.mark.parametrize("bsz,na,nb,nc,kind", [
    (1, 1, 1, 1, "random"), (1, 255, 0, 7, "random"),
    (8, 257, 1, 0, "random"), (8, 256, 700, 5, "random"),
    (3, 70_000, 4700, 1300, "random"),
    (8, 20_000, 8768, 2368, "one residue"),
    (8, 20_000, 8768, 2368, "all equal"),
    (8, 20_000, 8768, 2368, "extremes"),
    (4, 10_000, 60_000, 30_000, "one residue"),
    (4, 10_000, 60_000, 30_000, "all equal"),
    (4, 10_000, 60_000, 30_000, "extremes")])
def test_probe3_equals_plain(cuda, bsz, na, nb, nc, kind):
    rng = np.random.default_rng(na + nb + nc)
    if kind == "random":
        hi = max(nb, nc) // 2 + 2
        keys = [rng.integers(-2, hi, shape).astype(np.int32)
                for shape in ((bsz, na), (bsz, na), (bsz, nb), (bsz, nc))]
        for k in keys:  # the sentinels and the ends of the int32 range
            k.reshape(-1)[:4] = [-1, -2, -(2 ** 31), 2 ** 31 - 1][:k.size]
    else:  # keys of one cube partition: one hash32 residue on every side
        cases = _chip_smoke()
        a1, b = cases.probe_edge_keys(rng, bsz, na, nb, SHUFFLE_SEED, 8,
                                      kind)
        a2, c = cases.probe_edge_keys(rng, bsz, na, nc, SHUFFLE_SEED, 8,
                                      kind)
        keys = [a1, a2, b, c]
    a1, a2, b, c = (on(cuda, k) for k in keys)
    branch = table_branch(nb, nc)
    before = (ops.launch_counts()["tiled_probe3"],
              tiled_probe3.table_launches[branch])
    got = tiled_probe3(a1, a2, b, c)
    want = ref.tiled_probe3_ref(a1, a2, b, c)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (ops.launch_counts()["tiled_probe3"],
            tiled_probe3.table_launches[branch]) == (before[0] + 1,
                                                     before[1] + 1)


@pytest.mark.parametrize("logn", range(0, 13))
def test_bitonic_sorts(cuda, logn):
    n = 1 << logn
    k = on(cuda, np.random.default_rng(logn).integers(-50, 50, (3, n)).astype(
        np.int32))
    v = torch.arange(n, dtype=torch.int32, device=cuda).repeat(3, 1)
    gk, gv = bitonic_sort_tile(k, v)
    assert torch.equal(gk, ref.bitonic_sort_ref(k, v)[0])
    assert torch.equal(torch.gather(k, 1, gv.long()), gk)
    # Keys and values exactly as the reference's network leaves them, ties
    # included (v holds repeated column ids).
    wk, wv = ref.bitonic_network_ref(k, v)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)


# The exact network at B = 1, 7 and 133, with distinct values, on ties,
# all-equal keys, the int32 ends and the whole range.
@pytest.mark.parametrize("logn", [0, 1, 2, 3, 5, 8, 9, 10, 11, 12])
@pytest.mark.parametrize("bsz", [1, 7, 133])
def test_bitonic_equals_the_reference_network(cuda, logn, bsz):
    n = 1 << logn
    rng = np.random.default_rng(100 * logn + bsz)
    cs = _chip_smoke()
    v = on(cuda, rng.permutation(bsz * n).reshape(bsz, n).astype(np.int32))
    before = ops.launch_counts()["bitonic_sort_tile"]
    for kind in cs.SORT_EDGE_KINDS:
        k = on(cuda, cs.sort_edge_keys(rng, bsz, n, kind))
        gk, gv = bitonic_sort_tile(k, v)
        wk, wv = ref.bitonic_network_ref(k, v)
        assert torch.equal(gk, wk) and torch.equal(gv, wv), kind
    assert ops.launch_counts()["bitonic_sort_tile"] == before + len(
        cs.SORT_EDGE_KINDS)


# Rows of views that start 1-3 elements past an aligned base: the kernel's
# scalar loads and stores.
@pytest.mark.parametrize("n", [8, 2048, 4096])
def test_bitonic_on_views_equals_the_reference_network(cuda, n):
    rng = np.random.default_rng(n)
    keys = on(cuda, rng.integers(-2, 3, 7 * n + 3).astype(np.int32))
    vals = on(cuda, rng.permutation(7 * n + 3).astype(np.int32))
    for k0, v0 in ((1, 0), (0, 2), (3, 1)):
        k, v = keys[k0:k0 + 7 * n].view(7, n), vals[v0:v0 + 7 * n].view(7, n)
        gk, gv = bitonic_sort_tile(k, v)
        wk, wv = ref.bitonic_network_ref(k, v)
        assert torch.equal(gk, wk) and torch.equal(gv, wv), (k0, v0)


def test_main_path_on_the_card_equals_the_cpu(cuda):
    from repro_torch.sql import (Executor, all_queries, default_strategies,
                                 generate)
    on_card = generate(0.1, 4, 42)
    on_cpu = generate(0.1, 4, 42, device="cpu")
    ops.reset_launch_counts()
    for name, plan in all_queries().items():
        for s in default_strategies():
            got = Executor(on_card, s).execute(plan)
            want = Executor(on_cpu, s).execute(plan)
            assert got.methods() == want.methods(), (name, s.name)
            assert got.network_bytes == want.network_bytes, (name, s.name)
            assert rows_close(rows_as_set(got.table.to_numpy()),
                              rows_as_set(want.table.to_numpy())), name
    counts = ops.launch_counts()
    for kernel in ("partition_hist", "tiled_probe", "bitonic_sort_tile"):
        assert counts[kernel] > 0, kernel


def filter_keys(n, seed, shape=None):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-(2 ** 31), 2 ** 31 - 1, n, dtype=np.int64)
    keys = keys.astype(np.int32)
    keys[:min(n, 4)] = [0, -1, -(2 ** 31), 2 ** 31 - 1][:min(n, 4)]
    valid = rng.random(n) < 0.5
    if shape:
        return keys.reshape(shape), valid.reshape(shape)
    return keys, valid


@pytest.mark.parametrize("n,shape", [(0, None), (1, None), (31, None),
                                     (100_003, None), (3_000_000, (8, -1))])
@pytest.mark.parametrize("m_bits,k", [(32, 1), (256, 7), (65536, 8),
                                      (1 << 20, 8), (1 << 21, 8),
                                      (1 << 22, 3)])
def test_bloom_pair_equals_plain(cuda, n, shape, m_bits, k):
    keys, valid = filter_keys(n, n + m_bits, shape)
    kc, vc = on(cuda, keys), on(cuda, valid)
    words = bloom_build(kc, vc, m_bits=m_bits, k=k)
    want = ref.bloom_build_ref(kc.reshape(-1), vc.reshape(-1), m_bits, k)
    assert torch.equal(words, want)
    keep = bloom_probe(kc, words, k=k)
    assert keep.shape == kc.shape
    assert torch.equal(keep.reshape(-1),
                       ref.bloom_probe_ref(kc.reshape(-1), words, k))
    assert bool(keep[vc].all())


# Both filter branches (shared memory up to 2^20 bits, device memory
# above), k = 1..8, keys that all pass (the build's own), that all fail
# (the empty filter), and views 0-3 keys past an aligned base.
@pytest.mark.parametrize("m_bits", [1 << 16, 1 << 20, 1 << 21, 1 << 22])
def test_bloom_probe_branches_and_edges(cuda, m_bits):
    rng = np.random.default_rng(m_bits)
    keys = on(cuda, rng.integers(-(2 ** 31), 2 ** 31 - 1, 300_007,
                                 dtype=np.int64).astype(np.int32))
    branch = "shared" if filter_fits_shared(m_bits) else "device"
    before = bloom_probe.filter_launches[branch]
    calls = 0
    empty = torch.zeros(m_bits // 32, dtype=torch.int32, device=cuda)
    for k in range(1, 9):
        words = bloom_build(keys[:20_000], m_bits=m_bits, k=k)
        for off in range(4):
            kv = keys[off:]
            assert torch.equal(bloom_probe(kv, words, k=k),
                               ref.bloom_probe_ref(kv, words, k)), (k, off)
            assert bool(bloom_probe(kv[:20_000 - off], words, k=k).all())
            assert not bool(bloom_probe(kv, empty, k=k).any())
            calls += 3
    assert bloom_probe.filter_launches[branch] == before + calls


# Every build branch (one cluster up to ONE_CLUSTER_KEYS keys, blocks beyond,
# device memory above 2^20 bits) at its edges, counted by branch.
@pytest.mark.parametrize("n", [1, 31, ONE_CLUSTER_KEYS, ONE_CLUSTER_KEYS + 1,
                               100_003, 4_194_304])
@pytest.mark.parametrize("m_bits", [32, 1 << 16, 1 << 20, 1 << 21, 1 << 22])
def test_bloom_build_branches_equal_plain(cuda, n, m_bits):
    keys, valid = (on(cuda, a) for a in filter_keys(n, n ^ m_bits))
    branch = build_branch(n, m_bits)
    before = bloom_build.branch_launches[branch]
    for k in (1, 7, 8):
        assert torch.equal(bloom_build(keys, valid, m_bits=m_bits, k=k),
                           ref.bloom_build_ref(keys, valid, m_bits, k)), k
    none = torch.zeros_like(valid)
    assert not bool(bloom_build(keys, none, m_bits=m_bits, k=8).any())
    assert bloom_build.branch_launches[branch] == before + 4


# Keys and mask on views off a 16-byte boundary, in every branch.
@pytest.mark.parametrize("n,m_bits", [(ONE_CLUSTER_KEYS, 1 << 16),
                                      (100_003, 1 << 16),
                                      (100_003, 1 << 21)])
def test_bloom_build_on_views_equals_plain(cuda, n, m_bits):
    keys, valid = (on(cuda, a) for a in filter_keys(n + 3, n))
    for k0, v0 in ((1, 0), (0, 3), (2, 1), (3, 3)):
        kv, vv = keys[k0:k0 + n], valid[v0:v0 + n]
        assert torch.equal(bloom_build(kv, vv, m_bits=m_bits, k=8),
                           ref.bloom_build_ref(kv, vv, m_bits, 8)), (k0, v0)


# Calls in flight on two streams at once, each ORing into its own stream's
# accumulator; and builds interleaved with histograms on one stream, which
# share the stream's workspace.
@pytest.mark.parametrize("m_bits", [1 << 16, 1 << 21])
def test_bloom_build_two_streams_and_beside_the_histogram(cuda, m_bits):
    inputs = [tuple(on(cuda, a) for a in filter_keys(100_003, 5 + i))
              for i in range(2)]
    want = [ref.bloom_build_ref(k, v, m_bits, 8) for k, v in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(20):
        for i, (s, (k, v)) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(s):
                got[i].append(bloom_build(k, v, m_bits=m_bits, k=8))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(g, want[i]) for g in got[i])
    d = on(cuda, np.random.default_rng(m_bits).integers(
        -1, 20_001, 1_000_003).astype(np.int32))
    hist_want = ref.partition_hist_ref(d, 20_000)
    k, v = inputs[0]
    for _ in range(10):
        assert torch.equal(partition_hist(d, nd=20_000), hist_want)
        assert torch.equal(bloom_build(k, v, m_bits=m_bits, k=8), want[0])


@pytest.mark.parametrize("n", [0, 1, 31, 1000, 100_003, 3_000_000])
@pytest.mark.parametrize("pattern", ["all", "none", "random"])
def test_key_range_equals_plain(cuda, n, pattern):
    keys, valid = filter_keys(n, n)
    if pattern != "random":
        valid[:] = pattern == "all"
    kc, vc = on(cuda, keys), on(cuda, valid)
    assert torch.equal(key_range(kc, vc), ref.key_range_ref(kc, vc))


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, ONE_BLOCK_KEYS - 1,
                               ONE_BLOCK_KEYS, ONE_BLOCK_KEYS + 1, 100_003,
                               1 << 24])
def test_key_range_branches_equal_plain(cuda, n):
    """Each branch bit for bit: every key valid, none, half; one valid key
    at either int32 end; the launch counted by its branch."""
    keys, valid = filter_keys(n, n + 7)
    kc = on(cuda, keys)
    before = dict(key_range.branch_launches)
    for v in (np.ones(n, bool), np.zeros(n, bool), valid):
        vc = on(cuda, v)
        assert torch.equal(key_range(kc, vc), ref.key_range_ref(kc, vc))
    for end in (-(2 ** 31), 2 ** 31 - 1):
        if not n:
            continue
        k = keys.copy()
        k[n // 2] = end
        only = np.zeros(n, bool)
        only[n // 2] = True
        kc1, vc1 = on(cuda, k), on(cuda, only)
        assert key_range(kc1, vc1).tolist() == [end, end]
    took = {b: key_range.branch_launches[b] - before[b]
            for b in RANGE_BRANCHES}
    assert took[range_branch(n)] == (5 if n else 3) and sum(
        took.values()) == took[range_branch(n)]


@pytest.mark.parametrize("n", [33, ONE_BLOCK_KEYS + 1, 100_003])
def test_key_range_on_views_equals_plain(cuda, n):
    keys, valid = filter_keys(n + 3, n)
    kc, vc = on(cuda, keys), on(cuda, valid)
    for k0, v0 in ((1, 0), (0, 3), (2, 1), (3, 3)):
        kv, vv = kc[k0:k0 + n], vc[v0:v0 + n]
        assert torch.equal(key_range(kv, vv), ref.key_range_ref(kv, vv))


def test_key_range_two_streams_and_beside_hist_and_build(cuda):
    """The grid branch folds into its stream's accumulator: calls in
    flight on two streams at once, and calls interleaved with the
    histogram's and the bloom build's on one stream."""
    n = 4 * ONE_BLOCK_KEYS + 5
    inputs = [(on(cuda, np.random.default_rng(i).integers(
        -1000 * (i + 1), 1000 * (i + 1), n).astype(np.int32)),
        torch.ones(n, dtype=torch.bool, device=cuda)) for i in range(2)]
    want = [ref.key_range_ref(k, v) for k, v in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(20):
        for i, (s, (k, v)) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(s):
                got[i].append(key_range(k, v))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(g, want[i]) for g in got[i])
    keys, valid = (on(cuda, a) for a in filter_keys(n, 3))
    d = on(cuda, np.random.default_rng(4).integers(
        -1, 20_001, 1_000_003).astype(np.int32))
    hist_want = ref.partition_hist_ref(d, 20_000)
    words_want = ref.bloom_build_ref(keys, valid, 1 << 21, 8)
    range_want = ref.key_range_ref(keys, valid)
    for _ in range(10):
        assert torch.equal(key_range(keys, valid), range_want)
        assert torch.equal(partition_hist(d, nd=20_000), hist_want)
        assert torch.equal(key_range(keys, valid), range_want)
        assert torch.equal(bloom_build(keys, valid, m_bits=1 << 21, k=8),
                           words_want)


def test_text_suite_on_the_card_equals_the_cpu(cuda):
    """q16-q18 and q24-q34, parsed from SQL text, under the four default
    strategies: the card's runs equal the CPU's."""
    from repro_torch.sql import (Executor, default_strategies, generate,
                                 skewed_queries, text_queries)
    on_card = generate(0.1, 4, 42)
    on_cpu = generate(0.1, 4, 42, device="cpu")
    ops.reset_launch_counts()
    for name, plan in {**skewed_queries(), **text_queries()}.items():
        for s in default_strategies():
            got = Executor(on_card, s).execute(plan)
            want = Executor(on_cpu, s).execute(plan)
            assert got.methods() == want.methods(), (name, s.name)
            assert got.network_bytes == want.network_bytes, (name, s.name)
            assert rows_close(rows_as_set(got.table.to_numpy()),
                              rows_as_set(want.table.to_numpy())), name
    counts = ops.launch_counts()
    for kernel in ("partition_hist", "tiled_probe", "bitonic_sort_tile"):
        assert counts[kernel] > 0, kernel


def test_filtered_path_on_the_card_equals_the_cpu(cuda):
    from repro_torch.sql import (Executor, FilteredStrategy,
                                 default_strategies, filtered_queries,
                                 generate)
    on_card = generate(0.1, 4, 42)
    on_cpu = generate(0.1, 4, 42, device="cpu")
    ops.reset_launch_counts()
    for name, plan in filtered_queries().items():
        for s in default_strategies():
            got = Executor(on_card, FilteredStrategy(s)).execute(plan)
            want = Executor(on_cpu, FilteredStrategy(s)).execute(plan)
            assert [(f.plan, f.rows_before, f.rows_after)
                    for f in got.filters] == \
                [(f.plan, f.rows_before, f.rows_after)
                 for f in want.filters], (name, s.name)
            assert got.methods() == want.methods(), (name, s.name)
            assert got.network_bytes == want.network_bytes, (name, s.name)
            assert rows_close(rows_as_set(got.table.to_numpy()),
                              rows_as_set(want.table.to_numpy())), name
    counts = ops.launch_counts()
    for kernel in ("bloom_build", "bloom_probe", "key_range"):
        assert counts[kernel] > 0, kernel


def test_reorder_and_hypercube_path_on_the_card_equals_the_cpu(cuda):
    from repro_torch.sql import (Executor, RelJoinStrategy,
                                 ReorderingStrategy, cyclic_queries, generate,
                                 misordered_queries)
    on_card = generate(0.1, 4, 42)
    on_cpu = generate(0.1, 4, 42, device="cpu")
    strat = ReorderingStrategy(RelJoinStrategy())
    ops.reset_launch_counts()
    for name, plan in {**misordered_queries(), **cyclic_queries()}.items():
        got = Executor(on_card, strat).execute(plan)
        want = Executor(on_cpu, strat).execute(plan)
        assert got.methods() == want.methods(), name
        assert got.network_bytes == want.network_bytes, name
        assert rows_close(rows_as_set(got.table.to_numpy()),
                          rows_as_set(want.table.to_numpy())), name
    # q35 and q36 take the fused branch: two links on the probe shard.
    assert ops.launch_counts()["tiled_probe3"] >= 2


@pytest.mark.parametrize("n", [4_096, 100_003, 3_000_000])
def test_hist_shared_branch_at_the_hot_bucket_width(cuda, n):
    """K1's shared branch at nd = 128, the fine buckets ``hot_fine_buckets``
    counts at p = 8, masked as it calls it, against the plain version."""
    assert hist_branch(128) == "shared"
    rng = np.random.default_rng(n)
    d = on(cuda, rng.integers(0, 128, n).astype(np.int32))
    v = on(cuda, rng.uniform(size=n) < 0.7)
    before = partition_hist.branch_launches["shared"]
    assert torch.equal(partition_hist(d, nd=128, valid=v),
                       ref.partition_hist_ref(d, 128, v))
    assert partition_hist.branch_launches["shared"] == before + 1


@pytest.mark.parametrize("z", [0.0, 1.2])
def test_skew_primitives_on_the_card_equal_the_cpu(cuda, z):
    """``hot_fine_buckets``, ``key_skew`` and the salted shuffle hash join
    (both local-join paths) on the card equal the CPU's."""
    from repro_torch.core.cost_model import JoinMethod
    from repro_torch.joins import exchange, methods
    from repro_torch.sql import generate
    card, cpu = (generate(0.1, 8, 11, skew=z),
                 generate(0.1, 8, 11, skew=z, device="cpu"))
    ss, ss_cpu = card.table("store_sales"), cpu.table("store_sales")
    hot, fine = exchange.hot_fine_buckets(ss, "ss_customer_sk", 128, 8)
    want_hot, want_fine = exchange.hot_fine_buckets(ss_cpu, "ss_customer_sk",
                                                    128, 8)
    assert torch.equal(hot.cpu(), want_hot)
    assert torch.equal(fine.cpu(), want_fine)
    assert bool(hot.any()) == (z > 0)
    for key in ("ss_customer_sk", "ss_item_sk"):
        assert exchange.key_skew(ss, key, 8) == \
            exchange.key_skew(ss_cpu, key, 8)
    want, wrep = methods.run_equi_join(
        JoinMethod.SALTED_SHUFFLE_HASH, ss_cpu, cpu.table("customer"),
        "ss_customer_sk", "c_customer_sk", salt_r=3)
    for use_kernel in (False, True):
        got, grep = methods.run_equi_join(
            JoinMethod.SALTED_SHUFFLE_HASH, ss, card.table("customer"),
            "ss_customer_sk", "c_customer_sk", use_kernel=use_kernel,
            salt_r=3)
        assert [vars(e) for e in grep.exchanges] == \
            [vars(e) for e in wrep.exchanges]
        assert grep.output_rows == wrep.output_rows
        assert rows_close(rows_as_set(got.to_numpy()),
                          rows_as_set(want.to_numpy()))


def test_skew_aware_path_on_the_card_equals_the_cpu(cuda):
    """q16-q18 under ``SkewAwareStrategy`` on the Zipf-1.2 catalog, with
    every gate armed: the card's decisions, bytes and rows equal the CPU's,
    and K1's shared branch launched."""
    from repro_torch.sql import (Executor, SkewAwareStrategy, generate,
                                 skewed_queries)
    on_card = generate(0.1, 8, 11, skew=1.2)
    on_cpu = generate(0.1, 8, 11, skew=1.2, device="cpu")
    shared = partition_hist.branch_launches["shared"]
    for name, plan in skewed_queries().items():
        got = Executor(on_card, SkewAwareStrategy(), verify=True).execute(plan)
        want = Executor(on_cpu, SkewAwareStrategy()).execute(plan)
        assert [(d.selection.method, d.selection.salt_r, d.left_stats.skew,
                 d.right_stats.skew) for d in got.decisions] == \
            [(d.selection.method, d.selection.salt_r, d.left_stats.skew,
              d.right_stats.skew) for d in want.decisions], name
        assert (got.network_bytes, got.straggler_bytes) == \
            (want.network_bytes, want.straggler_bytes), name
        assert rows_close(rows_as_set(got.table.to_numpy()),
                          rows_as_set(want.table.to_numpy())), name
    assert partition_hist.branch_launches["shared"] > shared


def test_service_batch_on_the_card_equals_the_cpu(cuda):
    """The service suite as one ``QueryService`` batch with every gate
    armed: the card's shared subtrees, decisions, bytes and rows equal the
    CPU's, and the service path's kernels launched."""
    from repro_torch.sql import QueryService, generate, service_queries
    reports, services = [], []
    for dev in (None, "cpu"):
        service = QueryService(generate(0.1, 4, 42, device=dev), verify=True)
        for name, plan in service_queries().items():
            service.submit(plan, name=name)
        if dev is None:
            ops.reset_launch_counts()
        reports.append(service.run()[0])
        services.append(service)
        if dev is None:
            counts = ops.launch_counts()
    got, want = reports
    assert [(s.sig, s.consumers) for s in got.shared] == \
        [(s.sig, s.consumers) for s in want.shared]
    assert got.total_network_bytes == want.total_network_bytes
    for name, res in want.results.items():
        assert got.results[name].methods() == res.methods(), name
        assert rows_close(rows_as_set(got.results[name].table.to_numpy()),
                          rows_as_set(res.table.to_numpy())), name
    assert services[0].stats() == services[1].stats()
    for kernel in ("partition_hist", "tiled_probe", "bloom_build",
                   "bloom_probe", "key_range"):
        assert counts[kernel] > 0, kernel


@pytest.mark.parametrize("method", ["broadcast_nl", "cartesian"])
def test_nested_loop_joins_on_the_card_equal_the_cpu(cuda, method):
    """store_sales against date_dim (odd keys masked) under a nested-loop
    method, in several chunks: the card's rows and report equal the CPU's
    and the broadcast hash join's."""
    from repro_torch.core.cost_model import JoinMethod
    from repro_torch.joins import local_join, run_equi_join
    from repro_torch.sql import generate
    runs = {}
    for dev in (None, "cpu"):
        cat = generate(3, 8, 0, device=dev)
        a, b = cat.table("store_sales"), cat.table("date_dim")
        b = b.with_valid(b.valid & (b.column("d_date_sk") % 2 == 0))
        assert a.valid.numel() > local_join.nl_chunk_rows(b.valid.numel())
        for jt in ("inner", "left_semi", "left_anti", "left_outer"):
            out, rep = run_equi_join(JoinMethod(method), a, b,
                                     "ss_sold_date_sk", "d_date_sk", jt)
            runs[(dev, jt)] = (rows_as_set(out.to_numpy()), rep)
            if jt != "left_outer":
                hash_out, _ = run_equi_join(JoinMethod.BROADCAST_HASH, a, b,
                                            "ss_sold_date_sk", "d_date_sk",
                                            jt)
                assert runs[(dev, jt)][0] == \
                    rows_as_set(hash_out.to_numpy()), (dev, jt)
    for jt in ("inner", "left_semi", "left_anti", "left_outer"):
        (got, grep), (want, wrep) = runs[(None, jt)], runs[("cpu", jt)]
        assert got == want, jt
        assert (grep.local_bytes, grep.output_rows) == \
            (wrep.local_bytes, wrep.output_rows)
        assert [e.network_bytes for e in grep.exchanges] == \
            [e.network_bytes for e in wrep.exchanges]


def _chip_smoke_by_name():
    """``chip_smoke.py`` imported under its own name, so that the rank
    processes it spawns can import its rank function."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("world,backend", [(4, "gloo"), (1, "nccl")])
def test_distributed_twins_on_the_card_equal_the_global_view(cuda, world,
                                                             backend):
    """Every twin of ``chip_smoke.py`` phase 5f at ``generate(0.3, 4, 0)``,
    every rank on the one card: rows equal the global view's at p = 4,
    payloads bit-identical, no row past a pair's capacity, and K2, K4 and
    K6 launched in every rank (``check_twin_reports`` raises otherwise)."""
    from repro_torch.sql import generate
    cs = _chip_smoke_by_name()
    inputs = cs.twin_inputs(generate(0.3, 4, 0))
    expected, _ = cs.global_twin_results(inputs, reps=1)
    if world == 1:
        inputs = cs.one_partition(inputs)
    reports = cs.run_twins(inputs, expected, world, backend, reps=1)
    assert len(reports) == world
    cs.check_twin_reports(reports, f"world {world} under {backend}")


def test_lm_smoke_configs_on_the_card_equal_the_cpu(cuda):
    """``chip_smoke.py`` phase 7a: for the six smoke configs of the DENSE,
    VLM and AUDIO families, forward is finite on the card; hidden states,
    prefill logits and every decode step's logits equal the CPU run on the
    same params (rtol 2^-5, atol 2^-4, mean 2^-6); teacher-forced decode
    reproduces forward (rtol 0.2, atol 0.25). ``require`` raises otherwise."""
    from repro_torch.kernels import ops
    cs = _chip_smoke_by_name()
    ops.reset_launch_counts()
    cs.check_lm_smoke(cuda)
    assert not any(ops.launch_counts().values())


def test_lm_family_smoke_configs_on_the_card_equal_the_cpu(cuda):
    """``chip_smoke.py`` phase 8a: the smoke configs of the MoE, hybrid and
    RWKV-6 families on the card against the CPU on the CPU's router
    choices (moe_load and moe_dropped equal, the card's own picks within
    2^-5), teacher-forced decode against forward, and router ties taken
    in expert order on both devices."""
    from repro_torch.kernels import ops
    cs = _chip_smoke_by_name()
    ops.reset_launch_counts()
    cs.check_lm_smoke(cuda, cs.LM_FAMILY_ARCHS)
    cs.check_router_ties(cuda)
    assert not any(ops.launch_counts().values())
