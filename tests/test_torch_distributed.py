"""The port's distributed twins (``repro_torch.joins.distributed``) on gloo
at world sizes 1, 4 and 8, against the JAX package, on the CPU.

One ``torch.multiprocessing`` spawn per world size runs every case in every
rank (rendezvous through a ``FileStore``, so that parallel test workers
share no port) and saves each rank's outputs; the tests read them. The
rank side lives in ``tests/helpers/dist_ranks.py``, which imports no JAX,
so that a rank starts without it. Cases:
the reference's distributed-join inputs (``tests/helpers/run_distributed.py``:
na = 1000 probe rows, nb = 64 build keys) under the three binary twins, on
the gather path and on the kernel path (the plain versions of
``tiled_probe`` and ``bitonic_sort_tile`` on the CPU); the hypercube twin on
the triangle of ``tests/test_hypercube.py`` at cube dims (1, 1), (2, 2),
(4, 1), (2, 4) and (8, 1), factor 16; and the three filter builds on the
cases of ``tests/test_distributed_filters.py`` (20% holes, partitions 3-7
all invalid, heavy duplication, permuted rows, an all-invalid build).

At world 1 every output is array-equal to the JAX twin on a 1-device mesh;
at worlds 4 and 8 the rows equal, as multisets, the JAX global view at the
same p and the numpy oracle, and the filter payloads are bit-identical to
the JAX global builds, each rank's bloom partial to ``_partial_bloom_words``
of its partition. A ``slow`` test holds the world-8 outputs array for array
against the JAX twins on 8 forced host devices, in a subprocess.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.core.psts import key_set as j_key_set
from repro.joins import distributed as jd
from repro.joins import methods as jm
from repro.joins import table as jtable
from repro.joins.ref import ref_equi_join, ref_multiway_join, rows_as_set
from repro.kernels.bloom import bloom_build as j_bloom_build
from repro.kernels.bloom import bloom_build_ref as j_bloom_build_ref
from repro.kernels.zone_map import key_range_ref as j_key_range_ref
from repro_torch.joins import distributed as td
from tests.helpers.dist_ranks import (
    CHECKS, CUBE_FACTOR, FILTER_CASES, LINKS, TRIANGLE_CAPACITY, cube_dims,
    filter_params, filter_stacked, join_columns, join_names, rank_main,
    spec_at, triangle_columns)

# ---------------------------------------------------------------------------
# Inputs: the rank side's (``tests/helpers/dist_ranks.py``), and the JAX
# package's stacked tables.
# ---------------------------------------------------------------------------

def jax_stacked(cols, p, capacity=None):
    return jtable.partition_round_robin(jtable.from_numpy(cols, capacity), p)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(world)``: every rank's outputs at ``world``, from one spawn
    per world size (a rank's exception fails the spawn)."""
    runs = {}

    def get(world):
        if world not in runs:
            d = tmp_path_factory.mktemp(f"world{world}")
            mp.start_processes(rank_main, args=(world, str(d / "store"),
                                                str(d)),
                               nprocs=world, start_method="spawn")
            runs[world] = [torch.load(d / f"rank{r}.pt", weights_only=True)
                           for r in range(world)]
        return runs[world]
    return get


def port_rows(outs, name):
    """The valid rows of every rank's output of ``name``, as a multiset."""
    cols = {}
    for o in outs:
        v = o[name]["valid"][0].numpy()
        for n, c in o[name]["cols"].items():
            cols.setdefault(n, []).append(c[0].numpy()[v])
    return rows_as_set({n: np.concatenate(c) for n, c in cols.items()})


# ---------------------------------------------------------------------------
# The JAX side.
# ---------------------------------------------------------------------------

@functools.cache
def jax_twin(base, world):
    """The JAX twin of a join case on a ``world``-device mesh, as numpy."""
    if base.startswith("cube_"):
        dims = cube_dims(base)
        mesh = jd.make_cube_mesh(dims)
        tabs = tuple(jd.place_cube(jax_stacked(c, world, TRIANGLE_CAPACITY),
                                   mesh) for c in triangle_columns())
        out = jd.dist_hypercube_join(tabs, spec_at(jm.HypercubeLink,
                                                   jm.HypercubeSpec, dims),
                                     mesh, capacity_factor=CUBE_FACTOR)
    else:
        mesh = jd.make_join_mesh(world)
        A, B = (jd.place(jax_stacked(c, world), mesh) for c in join_columns())
        fn = getattr(jd, f"dist_{base}_join")
        out = fn(A, B, "k", "k", mesh)
    return ({n: np.asarray(c) for n, c in out.columns.items()},
            np.asarray(out.valid))


@functools.cache
def jax_global_rows(base, world):
    """Rows of the JAX global view at p = ``world`` and of the numpy
    oracle, each as a multiset."""
    if base.startswith("cube_"):
        cols = triangle_columns()
        tabs = [jax_stacked(c, world, TRIANGLE_CAPACITY) for c in cols]
        spec = spec_at(jm.HypercubeLink, jm.HypercubeSpec, cube_dims(base))
        out, _ = jm.hypercube_multiway_join(tabs, spec,
                                            capacity_factor=CUBE_FACTOR)
        oracle = ref_multiway_join(cols, LINKS, CHECKS)
    else:
        a, b = join_columns()
        fn = getattr(jm, f"{base}_join")
        out, _ = fn(jax_stacked(a, world), jax_stacked(b, world), "k", "k")
        oracle = ref_equi_join(a, b, "k", "k")
    return rows_as_set(out.to_numpy()), rows_as_set(oracle)


def jax_filter_twin(case):
    """The JAX filter twins on a 1-device mesh."""
    keys, valid = filter_stacked(case, 1)
    mesh = jd.make_join_mesh(1)
    t = jd.place(jtable.Table({"k": jnp.asarray(keys)}, jnp.asarray(valid)),
                 mesh)
    m, k = filter_params(case, 1)
    ks, n = jd.dist_key_set_build(t, "k", mesh)
    return (np.asarray(jd.dist_bloom_build(t, "k", mesh, m_bits=m, k=k)),
            np.asarray(jd.dist_zone_map_build(t, "k", mesh)),
            np.asarray(ks), int(n))


def words_u32(t):
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# World 1: array-equal to the JAX twins on a 1-device mesh.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", join_names(1))
def test_world1_join_twins_equal_jax_twins(ranks, name):
    (out,) = ranks(1)
    want_cols, want_valid = jax_twin(name.removesuffix("_kernel"), 1)
    got = out[name]
    assert sorted(got["cols"]) == sorted(want_cols)
    np.testing.assert_array_equal(got["valid"].numpy(), want_valid)
    for n, c in want_cols.items():
        np.testing.assert_array_equal(got["cols"][n].numpy(), c, n)


@pytest.mark.parametrize("case", FILTER_CASES[1])
def test_world1_filter_twins_equal_jax_twins(ranks, case):
    (out,) = ranks(1)
    words, zone, ks, n = jax_filter_twin(case)
    got = out[case]
    np.testing.assert_array_equal(words_u32(got["words"]), words)
    np.testing.assert_array_equal(got["zone"].numpy(), zone)
    np.testing.assert_array_equal(got["keys"].numpy(), ks)
    assert int(got["n"]) == n


# ---------------------------------------------------------------------------
# Worlds 4 and 8: rows equal the JAX global view and the oracle; filter
# payloads equal the JAX global builds.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,name", [(w, n) for w in (4, 8)
                                        for n in join_names(w)])
def test_rows_equal_jax_global_view_and_oracle(ranks, world, name):
    got = port_rows(ranks(world), name)
    glob, oracle = jax_global_rows(name.removesuffix("_kernel"), world)
    assert got == glob
    assert got == oracle
    assert got  # the cases match rows


@pytest.mark.parametrize("world,name", [(w, n) for w in (1, 4, 8)
                                        for n in join_names(w)
                                        if n.endswith("_kernel")])
def test_kernel_path_equals_gather_path(ranks, world, name):
    """Both local-join paths give every rank the same output, slot for
    slot."""
    for out in ranks(world):
        kern, gath = out[name], out[name.removesuffix("_kernel")]
        assert torch.equal(kern["valid"], gath["valid"])
        for n, c in gath["cols"].items():
            assert torch.equal(kern["cols"][n], c), n


@pytest.mark.parametrize("world,case", [(w, c) for w in (4, 8)
                                        for c in FILTER_CASES[w]])
def test_filter_builds_equal_jax_global_builds(ranks, world, case):
    outs = ranks(world)
    keys, valid = filter_stacked(case, world)
    m, k = filter_params(case, world)
    words = np.asarray(j_bloom_build(keys, valid, m_bits=m, k=k))
    np.testing.assert_array_equal(
        words, j_bloom_build_ref(keys, valid, m_bits=m, k=k))
    zone = j_key_range_ref(keys, valid)
    ks, n = j_key_set(jnp.asarray(keys), jnp.asarray(valid))
    for r, out in enumerate(outs):
        got = out[case]
        np.testing.assert_array_equal(words_u32(got["words"]), words)
        np.testing.assert_array_equal(
            words_u32(got["partial"]),
            np.asarray(jd._partial_bloom_words(jnp.asarray(keys[r]),
                                               jnp.asarray(valid[r]), m, k)))
        np.testing.assert_array_equal(got["zone"].numpy(), zone)
        np.testing.assert_array_equal(got["keys"].numpy(), np.asarray(ks))
        assert int(got["n"]) == int(n)
    if case == "all_invalid":
        assert zone[0] > zone[1] and int(n) == 0 and not words.any()


@pytest.mark.parametrize("world", [1, 4, 8])
def test_mesh_refuses_another_world_size(ranks, world):
    for out in ranks(world):
        assert f"a mesh of {world + 1} ranks" in out["mesh_size_refused"]


def test_make_join_mesh_needs_a_card_or_cpu(monkeypatch):
    """Without a card and without device="cpu" the mesh raises before it
    looks for a process group; with the CPU named, it needs the caller's
    process group and starts none of its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.make_join_mesh(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.make_cube_mesh((1, 1))
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process group"):
        td.make_join_mesh(1, device="cpu")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# World 8 against the JAX twins on 8 forced host devices (slow tier).
# ---------------------------------------------------------------------------

def save_jax_twins_on_8_devices(path):
    """The JAX twins of every world-8 join case on 8 host devices
    (XLA_FLAGS must force them before JAX starts)."""
    assert jax.device_count() == 8, jax.devices()
    arrays = {}
    for name in join_names(8):
        if name.endswith("_kernel"):
            continue
        cols, valid = jax_twin(name, 8)
        arrays[f"{name}/valid"] = valid
        arrays.update({f"{name}/{n}": c for n, c in cols.items()})
    np.savez(path, **arrays)


@pytest.mark.slow
def test_world8_array_equal_jax_twins_on_8_devices(ranks, tmp_path):
    path = tmp_path / "jax_twins.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    proc = subprocess.run([sys.executable, __file__, str(path)],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = np.load(path)
    outs = ranks(8)
    for name in join_names(8):
        if name.endswith("_kernel"):
            continue
        for r, out in enumerate(outs):
            np.testing.assert_array_equal(out[name]["valid"][0].numpy(),
                                          want[f"{name}/valid"][r])
            for n, c in out[name]["cols"].items():
                np.testing.assert_array_equal(c[0].numpy(),
                                              want[f"{name}/{n}"][r], n)


if __name__ == "__main__":
    save_jax_twins_on_8_devices(sys.argv[1])
