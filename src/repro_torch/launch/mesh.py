"""Mesh builders over the process group the caller started.

Functions, not module constants: importing this module touches no process
group. ``make_production_mesh`` is the reference's 16x16 pod or 2x16x16
pair of pods, which needs a world of 256 or 512 ranks; ``make_host_mesh``
lays a small (data, model) mesh over the current world (tests, examples,
ranks sharing one card).
"""

from __future__ import annotations

import torch.distributed as dist

from ..models.sharding import Mesh


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16x16 single pod (256 ranks) or 2x16x16 two pods (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    if _world() != need:
        raise ValueError(
            f"the production mesh {'x'.join(map(str, shape))} needs a world "
            f"of {need} ranks; this one has {_world()}")
    return Mesh(tuple(zip(axes, shape)), device=device)


def mesh_axes(mesh: Mesh) -> tuple:
    """((name, size), ...) in mesh order: the planner's mesh description."""
    return tuple((n, mesh.shape[n]) for n in mesh.axis_names)


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A (data, model) mesh over the current world, which must hold
    ``data * model`` ranks."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    return Mesh((("data", data), ("model", model)), device=device)
