"""partition_hist — histogram of shuffle/radix destinations.

counts[k] = #{i : dest[i] == k}; rows with dest < 0 or dest >= nd are not
counted, nor, where ``valid`` is given, rows whose mask is False. Used on
every shuffle to measure the hottest destination's load (the straggler
bytes). On a CUDA tensor it launches ``csrc/partition_hist.cu`` once; on a
CPU tensor it runs the plain version in ``ref.py``.

The kernel has three branches, chosen here by ``nd`` alone
(``hist_branch``), passed to the kernel by code, which launches exactly
that one, and counted in ``partition_hist.branch_launches``: per-thread
packed counters in registers for nd <= 8, per-block bins in shared memory
for nd <= 12,288, and atomics into device memory beyond. Every block adds
its counts into an accumulator that the last block to finish moves into
the output and leaves zero, so a call is one launch with no fill. The
accumulator and its ticket live in the workspace kept per CUDA stream
(``launch.workspace``, shared with ``bloom_build``): calls in flight on
two streams never share one.
"""

from __future__ import annotations

import torch

from . import ref
from .build import check, library
from .launch import cuda_stream, require_kernel_input, workspace

#: Largest nd counted in registers (two words of four 8-bit lanes; the
#: kernel refuses more) and in shared memory (48 KB of int bins).
MAX_REGISTER_BINS = 8
MAX_SHARED_BINS = 12_288
#: The kernel's branch codes, by position.
HIST_BRANCHES = ("registers", "shared", "global")


def hist_branch(nd: int) -> str:
    """The kernel branch that counts ``nd`` bins."""
    if nd <= MAX_REGISTER_BINS:
        return "registers"
    return "shared" if nd <= MAX_SHARED_BINS else "global"


def partition_hist(dest: torch.Tensor, *, nd: int,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """counts[k] = #{i : dest[i] == k and valid[i]} as int32 (nd,); dest < 0
    or >= nd ignored; ``valid`` (bool, dest's shape) None counts every row.
    """
    if dest.dtype != torch.int32:
        raise TypeError("partition_hist expects int32 destinations")
    if dest.dim() != 1:
        raise ValueError(f"partition_hist expects a 1-D tensor, got shape "
                         f"{tuple(dest.shape)}")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != dest.shape):
        raise ValueError("partition_hist expects a bool mask of dest's shape")
    if dest.device.type == "cpu" and (valid is None
                                      or valid.device.type == "cpu"):
        return ref.partition_hist_ref(dest, nd, valid)
    require_kernel_input("partition_hist", dest,
                         *(() if valid is None else (valid,)))
    if dest.numel() == 0 or nd <= 0:
        return torch.zeros(max(nd, 0), dtype=torch.int32, device=dest.device)
    out = torch.empty(nd, dtype=torch.int32, device=dest.device)
    branch = hist_branch(nd)
    with cuda_stream(dest) as stream:
        ws = workspace(dest.device, stream, nd)
        err = library().repro_partition_hist(
            dest.data_ptr(), None if valid is None else valid.data_ptr(),
            dest.numel(), nd, HIST_BRANCHES.index(branch), ws.data_ptr(),
            out.data_ptr(), stream)
    check(err, "partition_hist")
    partition_hist.launches += 1
    partition_hist.branch_launches[branch] += 1
    return out


partition_hist.launches = 0  # type: ignore[attr-defined]
#: Launches by kernel branch (``hist_branch``).
partition_hist.branch_launches = dict.fromkeys(  # type: ignore[attr-defined]
    HIST_BRANCHES, 0)
