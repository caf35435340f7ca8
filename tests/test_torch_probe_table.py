"""The two probe kernels' first-match tables, on the CPU.

The CUDA kernels (``csrc/tiled_probe.cu``, ``csrc/tiled_probe3.cu``) build
an open-addressing table of each build row; they run only on a card, where
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold them against the
plain versions. Here:

- the plain versions, which are both the CPU path and the kernels' oracle,
  equal the JAX package's interpret-mode ``tiled_probe`` and
  ``tiled_probe3`` exactly on the inputs that are hard for a table: every
  key of a row sharing one ``hash32`` residue (as in one radix bucket or
  one cube partition), all-equal builds, and the int32 ends and the
  sentinels. The inputs come from ``chip_smoke.py``'s edge sweep;
- the wrapper's sizing: table capacity and the shared-memory choice, with
  their boundaries;
- the restated bound of both kernels (each key read once, each output
  written once) at the largest inputs the card's paths gave them.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tiled_probe import tiled_probe as j_probe
from repro.kernels.tiled_probe import tiled_probe3 as j_probe3
from repro_torch.joins.slots import BUCKET_SEED, SHUFFLE_SEED, hash32
from repro_torch.kernels import tiled_probe as tp
from repro_torch.kernels.tiled_probe import tiled_probe, tiled_probe3

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tests", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# (a) plain versions against the reference kernels on adversarial inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", cs.PROBE_EDGE_KINDS)
def test_probe_plain_equals_reference_on_table_edge_cases(kind):
    rng = np.random.default_rng(len(kind))
    a, b = cs.probe_edge_keys(rng, 2, 300, 129, BUCKET_SEED, 64, kind)
    live = b[b != -2]
    residues = np.unique(hash32(t(live), BUCKET_SEED).numpy() % 64)
    if kind != "extremes":  # the ends and sentinels break the residue
        assert residues.tolist() == [0]
    got = tiled_probe(t(a), t(b)).numpy()
    for r in range(2):
        want = np.asarray(j_probe(jnp.asarray(a[r]), jnp.asarray(b[r]),
                                  interpret=True))
        np.testing.assert_array_equal(got[r], want)
    assert (got >= 0).any() and (got == -1).any()


@pytest.mark.parametrize("kind", cs.PROBE_EDGE_KINDS)
def test_probe3_plain_equals_reference_on_table_edge_cases(kind):
    rng = np.random.default_rng(10 + len(kind))
    a1, b = cs.probe_edge_keys(rng, 2, 300, 200, SHUFFLE_SEED, 8, kind)
    a2, c = cs.probe_edge_keys(rng, 2, 300, 70, SHUFFLE_SEED, 8, kind)
    g1, g2 = (o.numpy() for o in tiled_probe3(t(a1), t(a2), t(b), t(c)))
    for r in range(2):
        w1, w2 = (np.asarray(o) for o in j_probe3(
            jnp.asarray(a1[r]), jnp.asarray(a2[r]), jnp.asarray(b[r]),
            jnp.asarray(c[r]), interpret=True))
        np.testing.assert_array_equal(g1[r], w1)
        np.testing.assert_array_equal(g2[r], w2)


def test_edge_keys_hold_what_they_promise():
    rng = np.random.default_rng(3)
    a, b = cs.probe_edge_keys(rng, 1, 400, 50, SHUFFLE_SEED, 8, "all equal")
    assert len(np.unique(b)) == 1 and (a[0] == b[0, 0]).sum() > 0
    a, b = cs.probe_edge_keys(rng, 1, 400, 50, SHUFFLE_SEED, 8, "extremes")
    for end in (-(2 ** 31), 2 ** 31 - 1, -1, -2):
        assert end in b and end in a
    keys = cs.residue_keys(rng, 1000, BUCKET_SEED, 64)
    assert len(np.unique(keys)) == 1000
    assert (hash32(t(keys), BUCKET_SEED) % 64 == 0).all()
    assert (keys < 0).any() and (keys > 0).any()


# ---------------------------------------------------------------------------
# (b) the wrapper's sizing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,cap", [(0, 1), (1, 2), (2, 4), (3, 8), (129, 256),
                                   (170, 256), (171, 512), (1304, 2048),
                                   (2368, 4096), (4672, 8192), (8768, 16384),
                                   (10922, 16384), (10923, 32768),
                                   (100_000, 262_144)])
def test_table_capacity(n, cap):
    assert tp.table_capacity(n) == cap


def test_table_capacity_is_the_least_power_of_two_over_one_and_a_half_n():
    for n in range(1, 3000):
        cap = tp.table_capacity(n)
        assert cap & (cap - 1) == 0
        assert 2 * cap >= 3 * n > cap  # load <= 2/3, and no smaller pow2


@pytest.mark.parametrize("ns,fits", [
    ((129,), True),             # the hash join's bucket rows: 2 KB
    ((4672, 1304), True),       # the cube's first attempt: 80 KB
    ((8768, 2368), True),       # the cube's retried shape: 160 KB
    ((10922,), True),           # 16384 slots, the largest single table
    ((10923,), False),          # 32768 slots, 256 KB
    ((10922, 5461), True),      # 24576 slots, 192 KB
    ((10922, 5462), False),     # 32768 slots
    ((60_000, 30_000), False),
    ((100_000,), False),
    ((0, 7), True),
])
def test_tables_fit_shared(ns, fits):
    assert tp.tables_fit_shared(*ns) is fits
    need = 8 * sum(tp.table_capacity(n) for n in ns)
    assert (need <= 232_448) is fits


def test_device_tables_only_where_shared_memory_is_too_small():
    like = torch.zeros(1, dtype=torch.int32)
    assert tp._device_tables(256, (129,), like) is None
    assert tp._device_tables(8, (8768, 2368), like) is None
    tables = tp._device_tables(2, (100_000,), like)
    assert tables.dtype == torch.int64 and tables.numel() == 2 * 262_144
    tables = tp._device_tables(3, (60_000, 30_000), like)
    assert tables.numel() == 3 * (131_072 + 65_536)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = (tiled_probe.launches, dict(tiled_probe.table_launches),
              tiled_probe3.launches, dict(tiled_probe3.table_launches))
    a = t(np.array([[5, -1, 7]], np.int32))
    assert tiled_probe(a, t(np.array([[7, 5, 5]], np.int32))).tolist() == [
        [1, -1, 0]]
    tiled_probe3(a, a, a, a)
    assert before == (tiled_probe.launches, tiled_probe.table_launches,
                      tiled_probe3.launches, tiled_probe3.table_launches)


# ---------------------------------------------------------------------------
# (c) the restated bound at the paths' largest inputs
# ---------------------------------------------------------------------------

def test_probe_bound_at_the_main_path_shape():
    a = torch.empty((256, 132_104), dtype=torch.int32)
    b = torch.empty((256, 129), dtype=torch.int32)
    nbytes, ops = cs.probe_least_work([a], [b])
    assert nbytes == 4 * (2 * 256 * 132_104 + 256 * 129) == 270_681_088
    assert ops == 2 * (256 * 132_104 + 256 * 129)
    ms, by = cs.bound(nbytes, ops)
    assert by == "bytes" and ms == pytest.approx(0.0808003, rel=1e-5)


def test_probe3_bound_at_the_reorder_path_shape():
    a1, a2 = (torch.empty((8, 1_506_992), dtype=torch.int32)
              for _ in range(2))
    b = torch.empty((8, 8768), dtype=torch.int32)
    c = torch.empty((8, 2368), dtype=torch.int32)
    nbytes, ops = cs.probe_least_work([a1, a2], [b, c])
    assert nbytes == 4 * (4 * 8 * 1_506_992 + 8 * 11_136) == 193_251_328
    assert ops == 2 * (2 * 8 * 1_506_992 + 8 * 11_136)
    ms, by = cs.bound(nbytes, ops)
    assert by == "bytes" and ms == pytest.approx(0.0576870, rel=1e-5)


def test_dense_compares_count_the_scan_the_tables_replace():
    first = torch.tensor([[0, 4, -1, -1]])
    assert cs.dense_compares(first, 10) == 1 + 5 + 10 + 10
