"""Atomic checkpoints, in the JAX package's on-disk layout, so that a
checkpoint written by either package restores in the other.

Layout:  <dir>/step_<N:08d>/arr_<i>.npy  + manifest.json (step, the number
of arrays, the tree's structure as JAX prints it, and ``extra``). The
leaves are numbered in ``jax.tree_util``'s order (``tree.tree_leaves``:
dict keys sorted at every level). Writes go to a temporary directory that
is renamed into place, so a killed writer never leaves a half-checkpoint
that ``latest_step`` would pick up. Arrays are stored whole; a device mesh
to re-shard onto is not ported yet (``ROADMAP.md`` queue 1, item 5).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .tree import tree_leaves, tree_unflatten, treedef_str


def save(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None
         ) -> str:
    """Atomically persist a tree of tensors. Returns the checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = tree_leaves(tree)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        for i, leaf in enumerate(leaves):
            np.save(os.path.join(tmp, f"arr_{i}.npy"),
                    leaf.detach().cpu().numpy())
        manifest = {
            "step": step,
            "n_arrays": len(leaves),
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
    and on the device of ``like``'s leaf. Returns (tree, extra)."""
    if shardings is not None:
        raise NotImplementedError(
            "restoring onto shardings needs a device mesh, which is not "
            "ported yet (ROADMAP.md queue 1, item 5, LM slice 4); pass "
            "shardings=None")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = tree_leaves(like)
    if manifest["n_arrays"] != len(leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_arrays']} arrays, model needs "
            f"{len(leaves)} — architecture mismatch")
    out = []
    for i, leaf in enumerate(leaves):
        arr = np.load(os.path.join(path, f"arr_{i}.npy"))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"arr_{i}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        out.append(torch.from_numpy(np.array(arr, order="C")).to(
            device=leaf.device, dtype=leaf.dtype))
    return tree_unflatten(like, out), manifest["extra"]
