"""bitonic_sort_tile — batched tile sort of the sort join.

Sorts each row of int32 (key, value) pairs ascending by key; the row length
is a power of two <= ``MAX_TILE``. On a CUDA tensor it launches
``csrc/bitonic_sort.cu`` (one block per row, the tile in shared memory; not
stable); on a CPU tensor it runs the plain version in ``ref.py`` (stable).
Both give the same sorted keys, and values that address the same keys.
"""

from __future__ import annotations

import torch

from . import ref
from .build import check, library
from .launch import cuda_stream, require_kernel_input

MAX_TILE = 4096


def bitonic_sort_tile(keys: torch.Tensor, values: torch.Tensor):
    """Sort (B, n) or (n,) int32 (key, value) pairs by key, n a power of two
    <= MAX_TILE. Returns (sorted_keys, permuted_values)."""
    n = keys.shape[-1]
    if n & (n - 1) or n > MAX_TILE:
        raise ValueError(f"tile size must be a power of two <= {MAX_TILE}, "
                         f"got {n}")
    if keys.dtype != torch.int32 or values.dtype != torch.int32:
        raise TypeError("bitonic_sort_tile expects int32 keys and values")
    if keys.shape != values.shape or keys.dim() not in (1, 2):
        raise ValueError("bitonic_sort_tile expects keys and values of one "
                         "1-D or 2-D shape")
    if keys.dim() == 1:
        k, v = bitonic_sort_tile(keys[None], values[None])
        return k[0], v[0]
    if keys.device.type == "cpu" and values.device.type == "cpu":
        return ref.bitonic_sort_ref(keys, values)
    require_kernel_input("bitonic_sort_tile", keys, values)
    keys_out = torch.empty_like(keys)
    vals_out = torch.empty_like(values)
    if keys.shape[0] == 0 or n == 0:
        return keys_out, vals_out
    with cuda_stream(keys) as stream:
        err = library().repro_bitonic_sort(
            keys.data_ptr(), values.data_ptr(), keys.shape[0], n,
            keys_out.data_ptr(), vals_out.data_ptr(), stream)
    check(err, "bitonic_sort_tile")
    bitonic_sort_tile.launches += 1
    return keys_out, vals_out


bitonic_sort_tile.launches = 0  # type: ignore[attr-defined]
