"""The bitonic sort's network (K3) and the bloom build's branches (K4), on
the CPU.

The CUDA kernels (``csrc/bitonic_sort.cu``, ``csrc/bloom.cu``) run only on a
card, where ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold them
bit for bit against the plain versions. Here:

- ``ref.bitonic_network_ref``, the plain version of the CUDA sort, equals
  the JAX package's interpret-mode ``bitonic_sort_tile`` in keys and
  values on inputs full of ties, where a stable sort would differ;
- the bloom build's branch choice (``build_branch``) at its edges, and that
  the wrapper passes the branch's code, the stream's workspace (none for
  one cluster) and counts the launch by branch;
- the per-stream workspace that the histogram and the bloom build share
  (``launch.workspace``): one per stream, grown to the larger need;
- ``chip_smoke.py``'s least work of the two kernels and its timed inputs.
"""

import contextlib
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitonic_sort import bitonic_sort_tile as j_bitonic
from repro_torch.kernels import bloom, launch, partition_hist as hist_mod, ref
from repro_torch.kernels.bloom import (BUILD_BRANCHES, ONE_CLUSTER_KEYS,
                                       bloom_build, build_branch)
from repro_torch.kernels.partition_hist import partition_hist

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_sort_bloom_tests", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# K3: the reference's network
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 64, 256, 1024])
@pytest.mark.parametrize("kind", ["few distinct", "all equal", "int32 ends"])
def test_network_ref_equals_pallas_keys_and_values(n, kind):
    rng = np.random.default_rng(n)
    k = cs.sort_edge_keys(rng, 2, n, kind)
    v = rng.permutation(2 * n).reshape(2, n).astype(np.int32)
    gk, gv = ref.bitonic_network_ref(t(k), t(v))
    for r in range(2):
        jk, jv = j_bitonic(jnp.asarray(k[r]), jnp.asarray(v[r]),
                           interpret=True)
        np.testing.assert_array_equal(gk[r].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(gv[r].numpy(), np.asarray(jv))


def test_network_ref_equals_pallas_at_the_largest_tile():
    rng = np.random.default_rng(4096)
    k = cs.sort_edge_keys(rng, 1, 4096, "few distinct")[0]
    v = rng.permutation(4096).astype(np.int32)
    gk, gv = ref.bitonic_network_ref(t(k), t(v))
    jk, jv = j_bitonic(jnp.asarray(k), jnp.asarray(v), interpret=True)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("logn", range(0, 13))
def test_network_ref_sorts_every_row_as_each_row_alone(logn):
    n = 1 << logn
    rng = np.random.default_rng(logn)
    k = t(cs.sort_edge_keys(rng, 3, n, "wide"))
    v = torch.arange(n, dtype=torch.int32).repeat(3, 1)
    gk, gv = ref.bitonic_network_ref(k, v)
    assert torch.equal(gk, torch.sort(k, dim=-1).values)
    assert torch.equal(torch.gather(k, 1, gv.long()), gk)
    for r in range(3):
        rk, rv = ref.bitonic_network_ref(k[r], v[r])
        assert torch.equal(rk, gk[r]) and torch.equal(rv, gv[r])


def test_network_tie_order_differs_from_the_stable_sort():
    """Why the card's checks compare values too: on ties the network's
    value order is not the stable sort's, and the kernel must give the
    network's."""
    k = t(np.array([[3, 1, 3, 1, 2, 2, 1, 3]], np.int32))
    v = t(np.arange(8, dtype=np.int32)[None])
    nk, nv = ref.bitonic_network_ref(k, v)
    sk, sv = ref.bitonic_sort_ref(k, v)
    assert torch.equal(nk, sk)
    assert not torch.equal(nv, sv)
    jk, jv = j_bitonic(jnp.asarray(k[0].numpy()), jnp.asarray(v[0].numpy()),
                       interpret=True)
    np.testing.assert_array_equal(nv[0].numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# K4: the build's branches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m_bits,branch", [
    (0, 1 << 16, "cluster"), (1, 32, "cluster"),
    (ONE_CLUSTER_KEYS, 1 << 16, "cluster"),
    (ONE_CLUSTER_KEYS + 1, 1 << 16, "blocks"),
    (ONE_CLUSTER_KEYS, 1 << 20, "cluster"),
    (ONE_CLUSTER_KEYS + 1, 1 << 20, "blocks"),
    (1, 1 << 21, "device"), (4_194_304, 1 << 22, "device"),
    (4_194_304, 32, "blocks")])
def test_build_branch_at_its_edges(n, m_bits, branch):
    assert build_branch(n, m_bits) == branch


def test_one_cluster_limit_covers_the_filter_paths_builds():
    """The filter path's largest build at scale 30 (12,000 keys, p = 8)
    takes the one-cluster branch."""
    assert build_branch(12_000, 65_536) == "cluster"


class FakeLibrary:
    """Records the arguments of each C entry point called, and returns 0
    (launched)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_launch(monkeypatch):
    """The wrappers' CUDA path on meta tensors: checks pass, the stream
    handle is 7, and the library records its calls."""
    lib = FakeLibrary()

    @contextlib.contextmanager
    def stream(_t):
        yield 7

    for mod in (bloom, hist_mod):
        monkeypatch.setattr(mod, "library", lambda: lib)
        monkeypatch.setattr(mod, "require_kernel_input", lambda *a: None)
        monkeypatch.setattr(mod, "cuda_stream", stream)
    monkeypatch.setattr(launch, "_workspaces", {})
    return lib


@pytest.mark.parametrize("n,m_bits", [(12_000, 1 << 16),
                                      (ONE_CLUSTER_KEYS + 1, 1 << 16),
                                      (100, 1 << 22)])
def test_build_wrapper_passes_its_branch_and_workspace(fake_launch, n,
                                                       m_bits):
    keys = torch.empty(n, dtype=torch.int32, device="meta")
    valid = torch.empty(n, dtype=torch.bool, device="meta")
    branch = build_branch(n, m_bits)
    before = dict(bloom_build.branch_launches)
    words = bloom_build(keys, valid, m_bits=m_bits, k=8)
    assert words.shape == (m_bits // 32,) and words.dtype == torch.int32
    (name, args), = fake_launch.calls
    assert name == "repro_bloom_build"
    assert args[2:7] == (n, m_bits, 8, ref.BLOOM_SEED_1, ref.BLOOM_SEED_2)
    assert args[7] == BUILD_BRANCHES.index(branch)
    if branch == "cluster":
        assert args[8] is None and not launch._workspaces
    else:
        ws, = launch._workspaces.values()
        assert ws.numel() >= m_bits // 32 + 1
    assert args[10] == 7
    assert {b: bloom_build.branch_launches[b] - before[b]
            for b in BUILD_BRANCHES} == {
                b: int(b == branch) for b in BUILD_BRANCHES}


def test_build_wrapper_launches_nothing_for_no_keys_or_no_hashes(
        fake_launch):
    empty = torch.empty(0, dtype=torch.int32, device="meta")
    bloom_build(empty, m_bits=64, k=3)
    bloom_build(torch.empty(5, dtype=torch.int32, device="meta"), m_bits=64,
                k=0)
    assert not fake_launch.calls


# ---------------------------------------------------------------------------
# The shared per-stream workspace
# ---------------------------------------------------------------------------

def test_workspace_is_one_per_stream_and_grows_to_the_larger_need(
        monkeypatch):
    monkeypatch.setattr(launch, "_workspaces", {})
    cpu = torch.device("cpu")
    ws = launch.workspace(cpu, 1, 8)
    assert ws.numel() == launch.MIN_WORKSPACE_WORDS + 1
    assert not bool(ws.any()) and ws.dtype == torch.int32
    assert launch.workspace(cpu, 1, launch.MIN_WORKSPACE_WORDS) is ws
    assert launch.workspace(cpu, 2, 8) is not ws
    grown = launch.workspace(cpu, 1, 65_536)
    assert grown.numel() == 65_537 and grown is not ws
    assert launch.workspace(cpu, 1, 20_000) is grown
    assert launch.workspace(cpu, 1, 8) is grown


def test_histogram_and_build_share_the_streams_workspace(fake_launch):
    """On one stream both kernels get the same ticket and accumulator,
    sized for whichever needs more."""
    dest = torch.empty(1000, dtype=torch.int32, device="meta")
    keys = torch.empty(ONE_CLUSTER_KEYS + 1, dtype=torch.int32, device="meta")
    partition_hist(dest, nd=20_000)
    bloom_build(keys, m_bits=1 << 16, k=8)
    bloom_build(keys, m_bits=1 << 21, k=8)
    partition_hist(dest, nd=8)
    ws, = launch._workspaces.values()
    assert ws.numel() == (1 << 21) // 32 + 1
    assert [name for name, _ in fake_launch.calls] == [
        "repro_partition_hist", "repro_bloom_build", "repro_bloom_build",
        "repro_partition_hist"]
    assert list(launch._workspaces) == [(None, 7)]


def test_cpu_tensors_count_no_build_launch():
    before = (bloom_build.launches, dict(bloom_build.branch_launches))
    keys = t(np.arange(20_000, dtype=np.int32))
    words = bloom_build(keys, m_bits=1 << 16, k=8)
    assert torch.equal(words, ref.bloom_build_ref(
        keys, torch.ones(20_000, dtype=torch.bool), 1 << 16, 8))
    assert before == (bloom_build.launches, bloom_build.branch_launches)


# ---------------------------------------------------------------------------
# chip_smoke.py: least work and timed inputs
# ---------------------------------------------------------------------------

def test_sort_least_work_counts_five_operations_a_compare_exchange():
    nbytes, n_ops = cs.sort_least_work(8, 2048)
    assert nbytes == 16 * 8 * 2048
    assert n_ops == 5 * 8 * 1024 * 66
    ms, by = cs.bound(nbytes, n_ops)
    assert by == "operations" and ms == pytest.approx(0.000161394627, rel=1e-6)
    assert cs.sort_least_work(1, 1) == (16.0, 0.0)


def test_bloom_build_least_work_at_the_filter_paths_shape():
    nbytes, n_ops = cs.bloom_build_least_work(12_000, 3_444, 1 << 16, 8)
    assert nbytes == 5 * 12_000 + 8192
    assert n_ops == 12_000 + 3_444 * (13 + 7 * 8)
    assert cs.bound(nbytes, n_ops)[1] == "bytes"


def test_timed_inputs():
    k = torch.zeros(8, 2048, dtype=torch.int32)
    shapes = {label: tuple(a.shape)
              for label, (a, _) in cs.sort_cases(k, k).items()}
    assert shapes == {"main": (8, 2048), "4x": (32, 2048),
                      "n=4096": (4, 4096), "fixed cost": (1, 2)}
    small = torch.zeros(1, 1024, dtype=torch.int32)
    assert cs.sort_cases(small, small)["n=4096"][0].shape == (1, 4096)
    keys = torch.zeros(8, 1500, dtype=torch.int32)
    valid = torch.ones(8, 1500, dtype=torch.bool)
    sizes = {label: a.numel()
             for label, (a, _) in cs.bloom_cases(keys, valid).items()}
    assert sizes == {"main": 12_000, "4x": 48_000, "n=4096": 4096,
                     "fixed cost": 32}


def test_ptxas_names_tell_instantiations_apart():
    report = (
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119bitonic_sort_kernelILi8ELi3ELb1EEEvPKiS2_iPiS3_'"
        " for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 0 barriers\n")
    (name, usage), = cs.ptxas_usage(report)
    assert name == "bitonic_sort_kernel<8,3,1>"
    assert "40 registers" in usage and "0 bytes spill stores" in usage
