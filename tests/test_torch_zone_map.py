"""key_range's one-launch design (K6), on the CPU.

The CUDA kernel (``csrc/zone_map.cu``) runs only on a card, where
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it bit for bit
against the plain version. Here:

- the branch choice (``range_branch``) at its edges;
- the grid branch's accumulator, through a plain-torch model of it: the
  encodings ``INT32_MAX - lo`` and ``hi ^ 0x80000000`` as unsigned words
  are zero at the identities, order as the values do, fold by max and
  decode back, at ``INT32_MIN`` and ``INT32_MAX`` too;
- the wrapper's C call on meta tensors: the branch's code, the stream's
  workspace (none for one block), a launch on empty input with no host
  fill, and the launch counted by branch; the workspace shared with the
  histogram and the bloom build on one stream.
"""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import (bloom, launch, partition_hist as hist_mod,
                                 ref, zone_map)
from repro_torch.kernels.zone_map import (ONE_BLOCK_KEYS, RANGE_BRANCHES,
                                          key_range, range_branch)

INT32_MAX, INT32_MIN = 2 ** 31 - 1, -(2 ** 31)


@pytest.mark.parametrize("n,branch", [
    (0, "block"), (1, "block"), (360, "block"), (ONE_BLOCK_KEYS, "block"),
    (ONE_BLOCK_KEYS + 1, "blocks"), (100_003, "blocks"), (1 << 24, "blocks")])
def test_range_branch_at_its_edges(n, branch):
    assert range_branch(n) == branch


def test_filter_paths_builds_take_one_block():
    """The filter path's largest zone-map build at scale 30 (8 x 45 keys)
    takes the one-block branch, and the limit is a whole number of the
    block's 1,024 threads."""
    assert range_branch(8 * 45) == "block"
    assert ONE_BLOCK_KEYS % 1024 == 0


# ---------------------------------------------------------------------------
# The grid branch's accumulator, modelled in int64 torch arithmetic
# ---------------------------------------------------------------------------

U32 = 1 << 32


def encode(lo, hi):
    """The accumulator's two unsigned words for a block's [lo, hi]."""
    return (INT32_MAX - lo) % U32, (hi % U32) ^ 0x80000000


def decode(w_lo, w_hi):
    lo = (INT32_MAX - w_lo) % U32
    hi = (w_hi ^ 0x80000000) % U32
    signed = lambda w: w - U32 if w >= 1 << 31 else w  # noqa: E731
    return signed(lo), signed(hi)


def grid_model(keys: torch.Tensor, valid: torch.Tensor, blocks: int):
    """key_range as the grid branch computes it: each block's [min, max]
    of its grid-stride share, encoded and folded into a zero accumulator by
    max (a block with no valid key adds nothing), then decoded."""
    k = keys.to(torch.int64)
    acc = [0, 0]
    idx = torch.arange(k.numel())
    for b in range(blocks):
        mine = valid & (idx % blocks == b)
        if not bool(mine.any()):
            continue
        lo, hi = int(k[mine].min()), int(k[mine].max())
        w = encode(lo, hi)
        acc = [max(acc[0], w[0]), max(acc[1], w[1])]
    return torch.tensor(decode(*acc), dtype=torch.int32)


def test_encodings_are_zero_at_the_identities():
    assert encode(INT32_MAX, INT32_MIN) == (0, 0)
    assert decode(0, 0) == (INT32_MAX, INT32_MIN)


@pytest.mark.parametrize("x", [INT32_MIN, INT32_MIN + 1, -1, 0, 1,
                               INT32_MAX - 1, INT32_MAX])
def test_encodings_decode_and_stay_in_one_word(x):
    w_lo, w_hi = encode(x, x)
    assert 0 <= w_lo < U32 and 0 <= w_hi < U32
    assert decode(w_lo, w_hi) == (x, x)


def test_encodings_order_as_the_values():
    xs = [INT32_MIN, INT32_MIN + 1, -7, -1, 0, 1, 7, INT32_MAX - 1, INT32_MAX]
    lo_words = [encode(x, 0)[0] for x in xs]
    hi_words = [encode(0, x)[1] for x in xs]
    assert lo_words == sorted(lo_words, reverse=True)  # a smaller lo wins
    assert hi_words == sorted(hi_words)                # a larger hi wins
    assert encode(INT32_MIN, INT32_MAX) == (U32 - 1, U32 - 1)


@pytest.mark.parametrize("case", ["random", "none valid", "only INT32_MIN",
                                  "only INT32_MAX", "both ends", "one key"])
@pytest.mark.parametrize("blocks", [1, 3, 8])
def test_grid_model_equals_plain_version(case, blocks):
    rng = np.random.default_rng(blocks)
    n = 1 if case == "one key" else 1000
    keys = torch.from_numpy(rng.integers(INT32_MIN, INT32_MAX, n,
                                         dtype=np.int64).astype(np.int32))
    valid = torch.from_numpy(rng.random(n) < 0.5)
    if case == "none valid":
        valid[:] = False
    elif case.startswith("only"):
        at = int(rng.integers(0, n))
        keys[at] = INT32_MIN if case.endswith("MIN") else INT32_MAX
        valid[:] = False
        valid[at] = True
    elif case == "both ends":
        keys[3], keys[500] = INT32_MIN, INT32_MAX
        valid[:] = True
    assert torch.equal(grid_model(keys, valid, blocks),
                       ref.key_range_ref(keys, valid))


# ---------------------------------------------------------------------------
# The wrapper's C call, on meta tensors
# ---------------------------------------------------------------------------

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

    for mod in (zone_map, bloom, hist_mod):
        monkeypatch.setattr(mod, "library", lambda: lib)
        monkeypatch.setattr(mod, "require_kernel_input", lambda *a: None)
        monkeypatch.setattr(mod, "cuda_stream", stream)
    monkeypatch.setattr(launch, "_workspaces", {})
    return lib


@pytest.mark.parametrize("n", [0, 1, 360, ONE_BLOCK_KEYS, ONE_BLOCK_KEYS + 1,
                               100_003])
def test_wrapper_passes_its_branch_and_workspace(fake_launch, n):
    keys = torch.empty(n, dtype=torch.int32, device="meta")
    valid = torch.empty(n, dtype=torch.bool, device="meta")
    branch = range_branch(n)
    before = (key_range.launches, dict(key_range.branch_launches))
    out = key_range(keys, valid)
    assert out.shape == (2,) and out.dtype == torch.int32
    (name, args), = fake_launch.calls
    assert name == "repro_key_range"
    assert args[2] == n and args[3] == RANGE_BRANCHES.index(branch)
    if n == 0:
        assert args[0] is None and args[1] is None
    if branch == "block":
        assert args[4] is None and not launch._workspaces
    else:
        ws, = launch._workspaces.values()
        assert ws.numel() >= 3
    assert args[6] == 7
    assert key_range.launches == before[0] + 1
    assert {b: key_range.branch_launches[b] - before[1][b]
            for b in RANGE_BRANCHES} == {
                b: int(b == branch) for b in RANGE_BRANCHES}


def test_empty_input_is_one_launch_and_no_host_fill(fake_launch,
                                                    monkeypatch):
    """On empty input the kernel writes the empty interval: the wrapper
    launches it and writes nothing into the output itself."""
    def refuse(*_a, **_k):
        raise AssertionError("host write into the output")

    monkeypatch.setattr(torch.Tensor, "__setitem__", refuse)
    key_range(torch.empty(0, dtype=torch.int32, device="meta"))
    assert [name for name, _ in fake_launch.calls] == ["repro_key_range"]


def test_histogram_build_and_range_share_the_streams_workspace(fake_launch):
    dest = torch.empty(1000, dtype=torch.int32, device="meta")
    keys = torch.empty(100_003, dtype=torch.int32, device="meta")
    key_range(keys)
    hist_mod.partition_hist(dest, nd=20_000)
    bloom.bloom_build(keys, m_bits=1 << 21, k=8)
    key_range(keys)
    ws, = launch._workspaces.values()
    assert ws.numel() == (1 << 21) // 32 + 1
    assert [name for name, _ in fake_launch.calls] == [
        "repro_key_range", "repro_partition_hist", "repro_bloom_build",
        "repro_key_range"]
    assert list(launch._workspaces) == [(None, 7)]


def test_cpu_tensors_count_no_launch():
    before = (key_range.launches, dict(key_range.branch_launches))
    keys = torch.arange(-50_000, 50_000, dtype=torch.int32)
    got = key_range(keys, keys % 3 == 0)
    assert got.tolist() == [-49_998, 49_998]
    assert before == (key_range.launches, key_range.branch_launches)
