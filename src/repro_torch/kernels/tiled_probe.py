"""tiled_probe — batched first-match probe of the hash-family joins.

out[r, i] = min{j : b_keys[r, j] == a_keys[r, i]}, else -1. Callers encode
invalid rows with distinct negative sentinels (probe -1, build -2) so they
never match. One call covers every (partition, radix bucket) pair of a hash
join: on a CUDA tensor it launches ``csrc/tiled_probe.cu`` once; on a CPU
tensor it runs the plain version in ``ref.py``.
"""

from __future__ import annotations

import torch

from . import ref
from .build import check, library
from .launch import cuda_stream, require_kernel_input

#: Probe slots per block in the CUDA kernel; the grid's second axis counts
#: probe tiles and holds at most 65535 of them.
PROBE_TILE = 256
MAX_PROBE_TILES = 65535


def tiled_probe(a_keys: torch.Tensor, b_keys: torch.Tensor) -> torch.Tensor:
    """First-match probe: a_keys (B, na), b_keys (B, nb) -> int32 (B, na).

    1-D inputs are one batch row and give a 1-D result."""
    if a_keys.dtype != torch.int32 or b_keys.dtype != torch.int32:
        raise TypeError("tiled_probe expects int32 keys")
    if a_keys.dim() != b_keys.dim() or a_keys.dim() not in (1, 2):
        raise ValueError("tiled_probe expects two 1-D or two 2-D key tensors")
    if a_keys.dim() == 1:
        return tiled_probe(a_keys[None], b_keys[None])[0]
    bsz, na = a_keys.shape
    if b_keys.shape[0] != bsz:
        raise ValueError(f"batch mismatch: {bsz} probe rows, "
                         f"{b_keys.shape[0]} build rows")
    if a_keys.device.type == "cpu" and b_keys.device.type == "cpu":
        return ref.tiled_probe_ref(a_keys, b_keys)
    require_kernel_input("tiled_probe", a_keys, b_keys)
    nb = b_keys.shape[1]
    if -(-na // PROBE_TILE) > MAX_PROBE_TILES:
        raise ValueError(f"tiled_probe: {na} probe slots per row exceed "
                         f"{PROBE_TILE * MAX_PROBE_TILES}")
    out = torch.full((bsz, na), -1, dtype=torch.int32, device=a_keys.device)
    if bsz == 0 or na == 0 or nb == 0:
        return out
    with cuda_stream(a_keys) as stream:
        err = library().repro_tiled_probe(
            a_keys.data_ptr(), b_keys.data_ptr(), bsz, na, nb,
            out.data_ptr(), stream)
    check(err, "tiled_probe")
    tiled_probe.launches += 1
    return out


tiled_probe.launches = 0  # type: ignore[attr-defined]
