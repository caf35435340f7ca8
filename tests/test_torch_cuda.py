"""The port on an NVIDIA card: each CUDA kernel against its plain version,
and the main path and the runtime-filter path on the card against the same
paths on the CPU.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the JAX package, and uses no fixture of
``conftest.py``, so on a machine without JAX it runs as

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.joins.ref import rows_as_set, rows_close
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bitonic_sort import bitonic_sort_tile
from repro_torch.kernels.bloom import bloom_build, bloom_probe
from repro_torch.kernels.partition_hist import partition_hist
from repro_torch.kernels.tiled_probe import tiled_probe
from repro_torch.kernels.zone_map import key_range

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions")
    return torch.device("cuda")


def on(dev, a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("n,nd", [(0, 4), (31, 8), (100_003, 128),
                                  (3_000_000, 8), (50_000, 20000)])
def test_hist_equals_plain(cuda, n, nd):
    d = on(cuda, np.random.default_rng(n).integers(-1, nd + 2, n).astype(
        np.int32))
    before = ops.launch_counts()["partition_hist"]
    assert torch.equal(partition_hist(d, nd=nd), ref.partition_hist_ref(d, nd))
    assert ops.launch_counts()["partition_hist"] == before + (n > 0)


@pytest.mark.parametrize("bsz,na,nb", [(1, 1, 1), (5, 300, 700),
                                       (2, 1000, 5000), (64, 960, 129)])
def test_probe_equals_plain(cuda, bsz, na, nb):
    rng = np.random.default_rng(na + nb)
    a = on(cuda, rng.integers(-1, nb // 2 + 2, (bsz, na)).astype(np.int32))
    b = on(cuda, rng.integers(-2, nb // 2 + 2, (bsz, nb)).astype(np.int32))
    assert torch.equal(tiled_probe(a, b), ref.tiled_probe_ref(a, b))


@pytest.mark.parametrize("logn", range(0, 13))
def test_bitonic_sorts(cuda, logn):
    n = 1 << logn
    k = on(cuda, np.random.default_rng(logn).integers(-50, 50, (3, n)).astype(
        np.int32))
    v = torch.arange(n, dtype=torch.int32, device=cuda).repeat(3, 1)
    gk, gv = bitonic_sort_tile(k, v)
    assert torch.equal(gk, ref.bitonic_sort_ref(k, v)[0])
    assert torch.equal(torch.gather(k, 1, gv.long()), gk)


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
                                      (1 << 20, 8)])
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


@pytest.mark.parametrize("n", [0, 1, 31, 1000, 100_003, 3_000_000])
@pytest.mark.parametrize("pattern", ["all", "none", "random"])
def test_key_range_equals_plain(cuda, n, pattern):
    keys, valid = filter_keys(n, n)
    if pattern != "random":
        valid[:] = pattern == "all"
    kc, vc = on(cuda, keys), on(cuda, valid)
    assert torch.equal(key_range(kc, vc), ref.key_range_ref(kc, vc))


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
