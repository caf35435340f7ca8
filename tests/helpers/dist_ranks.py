"""The rank side of ``tests/test_torch_distributed.py``: its inputs, drawn
from seeds with numpy, and every case one rank of a gloo world runs. A
module of its own that imports no JAX, so that a spawned rank starts
without it."""

import zlib
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.cost_model import bloom_params
from repro_torch.joins import distributed as td
from repro_torch.joins import table as ttable
from repro_torch.joins.methods import HypercubeLink, HypercubeSpec

CUBE_DIMS = {1: ((1, 1),), 4: ((2, 2), (4, 1)), 8: ((2, 4), (8, 1))}
CUBE_FACTOR = 16.0
JOINS = ("shuffle_hash", "shuffle_sort", "broadcast_hash")
FILTER_CASES = {1: ("holes", "duplicated", "permuted", "all_invalid"),
                4: ("holes", "dead_partitions", "duplicated", "permuted",
                    "all_invalid"),
                8: ("holes", "dead_partitions", "duplicated", "permuted",
                    "all_invalid")}
#: Where the reference's case kills partitions (its 8-device case, 3..7).
DEAD_FROM = 3
LINKS = ((1, "rb", "sb"), (2, "ra", "ta"))
AXIS_KEYS = (((0, "ra"), (1, "rb")), ((1, "sb"),), ((0, "ta"),))
CHECKS = (("s_c", "t_c"),)
TRIANGLE_CAPACITY = 192


def join_names(world):
    """Every join case a rank runs at ``world``: the binary twins and the
    cube at each of the world's dims, each on both local-join paths."""
    names = list(JOINS)
    names += [f"cube_{a}x{b}" for a, b in CUBE_DIMS[world]]
    return names + [f"{n}_kernel" for n in names]


def cube_dims(name):
    a, b = name.split("_")[1].split("x")
    return int(a), int(b)


# ---------------------------------------------------------------------------
# Inputs (numpy, from seeds), as each package's stacked tables.
# ---------------------------------------------------------------------------

def join_columns():
    """The reference's 8-device run: 1000 probe rows against 64 unique
    keys, half of the probe keys without a match."""
    rng = np.random.default_rng(7)
    nb, na = 64, 1000
    b = {"k": rng.permutation(nb).astype(np.int32),
         "payload": rng.integers(0, 99, nb).astype(np.int32)}
    a = {"k": rng.integers(0, nb * 2, na).astype(np.int32),
         "v": rng.uniform(0, 1, na).astype(np.float32)}
    return a, b


def triangle_columns():
    """``tests/test_hypercube.py``'s triangle: r(ra, rb, v) probes s on rb
    and t on ra, closed on s_c = t_c."""
    rng = np.random.default_rng(zlib.crc32(b"hc-dist"))
    r = {"ra": rng.integers(0, 20, 160).astype(np.int32),
         "rb": rng.integers(0, 24, 160).astype(np.int32),
         "v": np.arange(160, dtype=np.int32)}
    s = {"sb": np.arange(24, dtype=np.int32),
         "s_c": rng.integers(0, 4, 24).astype(np.int32)}
    t = {"ta": np.arange(20, dtype=np.int32),
         "t_c": rng.integers(0, 4, 20).astype(np.int32)}
    return r, s, t


def filter_columns(case):
    """(keys, valid) of a filter case of
    ``tests/test_distributed_filters.py``, in its own draw order."""
    if case in ("holes", "dead_partitions"):
        n, hole = (1000, 0.2) if case == "holes" else (64, 0.0)
        rng = np.random.default_rng(3)
        keys = rng.integers(-(1 << 28), 1 << 28, n).astype(np.int32)
        rng.integers(0, 99, n)  # the reference's payload column
        return keys, rng.random(n) >= hole
    seed, n, hole, permute = {"duplicated": (5, 1000, 0.3, False),
                              "permuted": (9, 1000, 0.0, True),
                              "all_invalid": (5, 64, 0.3, False)}[case]
    rng = np.random.default_rng(seed)
    keys = np.resize(rng.integers(-(1 << 20), 1 << 20, n // 3), n
                     ).astype(np.int32)
    if permute:
        keys = rng.permutation(keys)
    valid = rng.random(n) >= hole
    return keys, valid & (case != "all_invalid")


def filter_stacked(case, p):
    """(keys, valid) of the case as stacked (p, per) numpy arrays, laid
    out as ``partition_round_robin`` lays them, dead partitions masked."""
    keys, valid = filter_columns(case)
    per = -(-keys.size // p)
    pad = per * p - keys.size
    keys = np.pad(keys, (0, pad)).reshape(p, per)
    valid = np.pad(valid, (0, pad)).reshape(p, per)
    if case == "dead_partitions":
        valid[DEAD_FROM:] = False
    return keys, valid


def filter_params(case, p):
    keys, valid = filter_stacked(case, p)
    return bloom_params(len(np.unique(keys[valid])))


def port_stacked(cols, p, capacity=None):
    return ttable.partition_round_robin(
        ttable.from_numpy(cols, capacity, device="cpu"), p)


def spec_at(pkg_link, pkg_spec, dims):
    return pkg_spec(dims=dims, axis_keys=AXIS_KEYS,
                    links=tuple(pkg_link(*lk) for lk in LINKS),
                    checks=CHECKS)


# ---------------------------------------------------------------------------
# The rank processes.
# ---------------------------------------------------------------------------

def run_cases(world):
    """Every case on this rank; returns its outputs as CPU tensors."""
    out = {}
    mesh = td.make_join_mesh(world, device="cpu")
    try:
        td.make_join_mesh(world + 1, device="cpu")
    except ValueError as e:
        out["mesh_size_refused"] = str(e)
    a, b = join_columns()
    A, B = (td.place(port_stacked(c, world), mesh) for c in (a, b))
    twins = {"shuffle_hash": td.dist_shuffle_hash_join,
             "shuffle_sort": td.dist_shuffle_sort_join}
    for name in join_names(world):
        base, uk = name.removesuffix("_kernel"), name.endswith("_kernel")
        if base in twins:
            res = twins[base](A, B, "k", "k", mesh, use_kernel=uk)
        elif base == "broadcast_hash":
            res = td.dist_broadcast_hash_join(A, B, "k", "k", mesh,
                                              use_kernel=uk)
        else:
            dims = cube_dims(base)
            cube = td.make_cube_mesh(dims, device="cpu")
            tabs = tuple(td.place_cube(port_stacked(
                c, world, TRIANGLE_CAPACITY), cube)
                for c in triangle_columns())
            res = td.dist_hypercube_join(
                tabs, spec_at(HypercubeLink, HypercubeSpec, dims), cube,
                capacity_factor=CUBE_FACTOR, use_kernel=uk)
        out[name] = {"cols": res.columns, "valid": res.valid}
    for case in FILTER_CASES[world]:
        keys, valid = filter_stacked(case, world)
        t = td.place(ttable.Table({"k": torch.from_numpy(keys)},
                                  torch.from_numpy(valid)), mesh)
        m, k = filter_params(case, world)
        ks, n = td.dist_key_set_build(t, "k", mesh)
        out[case] = {
            "words": td.dist_bloom_build(t, "k", mesh, m_bits=m, k=k),
            "partial": td._partial_bloom_words(t.column("k"), t.valid, m, k),
            "zone": td.dist_zone_map_build(t, "k", mesh),
            "keys": ks, "n": n}
    return out


def rank_main(rank, world, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        torch.save(run_cases(world), Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
