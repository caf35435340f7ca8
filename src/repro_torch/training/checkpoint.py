"""Atomic checkpoints, in the JAX package's on-disk layout, so that a
checkpoint written by either package restores in the other.

Layout:  <dir>/step_<N:08d>/arr_<i>.npy  + manifest.json (step, the number
of arrays, the tree's structure as JAX prints it, and ``extra``). The
leaves are numbered in ``jax.tree_util``'s order (``tree.tree_leaves``:
dict keys sorted at every level). Writes go to a temporary directory that
is renamed into place, so a killed writer never leaves a half-checkpoint
that ``latest_step`` would pick up. Arrays are stored whole, whatever mesh
wrote them: saving a sharded tree (``mesh=`` and its ``specs``) gathers
each leaf whole and rank 0 writes it, and ``restore(..., shardings=)``
keeps each rank's block, so a checkpoint written on one mesh loads on any
other and on none.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import zlib
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models import sharding as sh
from .tree import tree_leaves, tree_unflatten, treedef_str


def save(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None,
         *, mesh=None, specs: Any = None, digests: list | None = None
         ) -> str:
    """Atomically persist a tree of tensors. Returns the checkpoint path.
    With a mesh every rank calls it with its blocks and ``specs``: each
    leaf is gathered whole, rank 0 writes, and all return once it has.
    ``digests``, a list, receives each array's ``digest`` (on the rank
    that writes)."""
    leaves = tree_leaves(tree)
    if mesh is not None:
        # one leaf whole at a time: every rank joins its gather, rank 0
        # writes it
        whole = (sh.unshard(t.detach(), s, mesh)
                 for t, s in zip(leaves, tree_leaves(specs)))
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
        if mesh.rank == 0:
            path = _write(ckpt_dir, step, tree, len(leaves), whole, extra,
                          digests)
        else:
            for _ in whole:
                pass
        dist.barrier()
        return path
    return _write(ckpt_dir, step, tree, len(leaves), leaves, extra, digests)


def digest(arr: np.ndarray) -> str:
    """The CRC-32 of an array's bytes (C order) with its dtype and shape:
    what a bit-for-bit comparison of two checkpoints' arrays reads."""
    arr = np.ascontiguousarray(arr)
    return (f"{zlib.crc32(memoryview(arr).cast('B')):08x} {arr.dtype} "
            f"{arr.shape}")


def _write(ckpt_dir, step, tree, n, leaves, extra, digests=None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        for i, leaf in enumerate(leaves):
            arr = leaf.detach().cpu().numpy()
            np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
            if digests is not None:
                digests.append(digest(arr))
        manifest = {
            "step": step,
            "n_arrays": n,
            "treedef": treedef_str(tree),
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any,
            shardings: Any = None) -> Tuple[Any, dict]:
    """Restore into the structure of ``like``: each leaf with the dtype
    and on the device of ``like``'s leaf. ``shardings``, a congruent tree
    of ``models.sharding.NamedSharding`` for the current mesh, keeps each
    rank's block of the whole array (``like``'s leaves are blocks then).
    Returns (tree, extra)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = tree_leaves(like)
    if manifest["n_arrays"] != len(leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_arrays']} arrays, model needs "
            f"{len(leaves)} — architecture mismatch")
    shard_leaves = (tree_leaves(shardings) if shardings is not None
                    else [None] * len(leaves))
    out = []
    for i, (leaf, ns) in enumerate(zip(leaves, shard_leaves)):
        arr = np.load(os.path.join(path, f"arr_{i}.npy"))
        want = (tuple(leaf.shape) if ns is None else
                sh.global_shape(leaf.shape, ns.spec, ns.mesh))
        if tuple(arr.shape) != want:
            raise ValueError(f"arr_{i}: shape {arr.shape} != {want}")
        t = torch.from_numpy(np.array(arr, order="C"))
        if ns is not None:
            t = sh.shard(t, ns.spec, ns.mesh)
        out.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return tree_unflatten(like, out), manifest["extra"]
