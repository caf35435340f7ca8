"""The port on an NVIDIA card: each CUDA kernel against its plain version,
and the main path on the card against the same path on the CPU.

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
from repro_torch.kernels.partition_hist import partition_hist
from repro_torch.kernels.tiled_probe import tiled_probe

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
    assert all(n > 0 for n in ops.launch_counts().values())
