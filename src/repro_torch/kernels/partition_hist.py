"""partition_hist — histogram of shuffle/radix destinations.

counts[k] = #{i : dest[i] == k}; rows with dest < 0 are not counted. Used on
every shuffle to measure the hottest destination's load (the straggler
bytes). On a CUDA tensor it launches ``csrc/partition_hist.cu``; on a CPU
tensor it runs the plain version in ``ref.py``.
"""

from __future__ import annotations

import torch

from . import ref
from .build import check, library
from .launch import cuda_stream, require_kernel_input


def partition_hist(dest: torch.Tensor, *, nd: int) -> torch.Tensor:
    """counts[k] = #{i : dest[i] == k} as int32 (nd,); dest < 0 ignored."""
    if dest.dtype != torch.int32:
        raise TypeError("partition_hist expects int32 destinations")
    if dest.dim() != 1:
        raise ValueError(f"partition_hist expects a 1-D tensor, got shape "
                         f"{tuple(dest.shape)}")
    if dest.device.type == "cpu":
        return ref.partition_hist_ref(dest, nd)
    require_kernel_input("partition_hist", dest)
    out = torch.zeros(max(nd, 0), dtype=torch.int32, device=dest.device)
    if dest.numel() == 0 or nd <= 0:
        return out
    with cuda_stream(dest) as stream:
        err = library().repro_partition_hist(
            dest.data_ptr(), dest.numel(), nd, out.data_ptr(), stream)
    check(err, "partition_hist")
    partition_hist.launches += 1
    return out


partition_hist.launches = 0  # type: ignore[attr-defined]
