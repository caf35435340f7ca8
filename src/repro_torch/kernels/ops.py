"""Public wrappers around the kernels, with the reference's shape dispatch.

Callers use these (or the kernel modules' own wrappers), never the C entry
points. Each kernel wrapper counts its launches; ``launch_counts`` and
``reset_launch_counts`` read and clear those counts.
"""

from __future__ import annotations

import torch

from .bitonic_sort import MAX_TILE, bitonic_sort_tile
from .bloom import bloom_build, bloom_probe
from .partition_hist import partition_hist
from .tiled_probe import tiled_probe, tiled_probe3
from .zone_map import key_range

KERNELS = {"partition_hist": partition_hist, "tiled_probe": tiled_probe,
           "bitonic_sort_tile": bitonic_sort_tile, "bloom_build": bloom_build,
           "bloom_probe": bloom_probe, "key_range": key_range,
           "tiled_probe3": tiled_probe3}


def probe(a_keys: torch.Tensor, b_keys: torch.Tensor) -> torch.Tensor:
    """First-match index of each probe key in its row's build keys (-1 if
    none)."""
    return tiled_probe(a_keys, b_keys)


def probe3(a1_keys: torch.Tensor, a2_keys: torch.Tensor,
           b_keys: torch.Tensor, c_keys: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused two-build first-match probe (the hypercube's three-way local
    join), every partition in one call."""
    return tiled_probe3(a1_keys, a2_keys, b_keys, c_keys)


def hist(dest: torch.Tensor, nd: int,
         valid: torch.Tensor | None = None) -> torch.Tensor:
    """Partition-destination histogram (skew/capacity statistics) of the
    rows whose ``valid`` is True (every row where it is None)."""
    return partition_hist(dest, nd=nd, valid=valid)


def sort_pairs(keys: torch.Tensor, values: torch.Tensor):
    """Ascending sort of each row of int32 (key, value) pairs.

    Uses the bitonic tile kernel for power-of-two rows up to MAX_TILE, as
    the reference does; other lengths take a stable sort, as the reference
    falls back to ``argsort`` there.
    """
    n = keys.shape[-1]
    if n and not (n & (n - 1)) and n <= MAX_TILE:
        return bitonic_sort_tile(keys, values)
    order = torch.argsort(keys, dim=-1, stable=True)
    return (torch.gather(keys, -1, order), torch.gather(values, -1, order))


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
