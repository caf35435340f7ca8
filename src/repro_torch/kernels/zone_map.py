"""key_range / range_probe — the zone-map runtime filter over join keys.

A zone map folds the build side's surviving join keys into one ``[min,
max]`` interval (8 bytes on the wire); the probe side keeps the rows whose
key falls inside it. For band-shaped key sets — a range predicate on the key
itself, such as a date window on ``d_date_sk`` — it is exact.

``key_range`` is the build reduce: on a CUDA tensor it launches
``csrc/zone_map.cu``; on a CPU tensor it runs the plain version in
``ref.py``. An empty or all-invalid build gives the empty interval
``[INT32_MAX, INT32_MIN]``, whose probe rejects every row. ``range_probe``
and ``merge_ranges`` are plain tensor code, as in the reference.

The reduce is bound by bytes, but at the filter path's inputs (a few
hundred keys) by the cost of a launch: the kernel this replaces was two
device activities a call (a one-thread kernel setting the empty interval,
then the reduce), and two host fills on empty input. Now a call is one
launch with no fill, empty input included, in one of two branches chosen
here from the number of keys (``range_branch``), passed to the kernel as a
code and counted in ``key_range.branch_launches``: up to
``ONE_BLOCK_KEYS`` keys one block reduces them and writes both words;
beyond, the blocks of a grid fold into the per-stream workspace's
accumulator (``launch.workspace``, shared with ``partition_hist`` and
``bloom_build``) as ``INT32_MAX - lo`` and ``hi ^ 0x80000000``, which are
zero at the identities, and the last block decodes them into the output.
"""

from __future__ import annotations

import torch

from . import ref
from .build import check, library
from .launch import (cuda_stream, flat_keys, flat_valid, require_kernel_input,
                     workspace)

#: Keys up to which one block reduces them all, with no workspace and no
#: global atomic: the filter path's builds (8 x 45 keys at scale 30) take
#: this branch. The largest n at which one block measured no slower than
#: the grid on an H100 (``tools/time_sort_bloom.py --range-sweep``;
#: PERF.md): at 16,384 keys the grid is faster.
ONE_BLOCK_KEYS = 12_288
#: The kernel's branch codes, by position.
RANGE_BRANCHES = ("block", "blocks")


def range_branch(n: int) -> str:
    """The kernel branch that reduces ``n`` keys."""
    return "block" if n <= ONE_BLOCK_KEYS else "blocks"


def key_range(keys: torch.Tensor, valid: torch.Tensor | None = None
              ) -> torch.Tensor:
    """[min, max] of the valid entries of ``keys`` (any shape, integer
    dtype, read as int32) as an int32 ``(2,)`` tensor."""
    flat = flat_keys(keys)
    v = flat_valid(valid, flat)
    if flat.device.type == "cpu" and v.device.type == "cpu":
        return ref.key_range_ref(flat, v)
    require_kernel_input("key_range", flat, v)
    out = torch.empty(2, dtype=torch.int32, device=flat.device)
    n = flat.numel()
    branch = range_branch(n)
    with cuda_stream(flat) as stream:
        ws = (None if branch == "block"
              else workspace(flat.device, stream, 2).data_ptr())
        err = library().repro_key_range(
            flat.data_ptr() if n else None, v.data_ptr() if n else None, n,
            RANGE_BRANCHES.index(branch), ws, out.data_ptr(), stream)
    check(err, "key_range")
    key_range.launches += 1
    key_range.branch_launches[branch] += 1
    return out


def merge_ranges(parts: torch.Tensor) -> torch.Tensor:
    """Merge stacked ``(k, 2)`` partial intervals into one ``(2,)`` zone
    map: min of the mins, max of the maxes (any merge order gives the same
    interval; the empty interval is the identity)."""
    return torch.stack([parts[:, 0].amin(), parts[:, 1].amax()])


def range_probe(keys: torch.Tensor, lo_hi: torch.Tensor) -> torch.Tensor:
    """Keep-mask of ``keys`` against a ``key_range`` interval: True iff
    lo <= key <= hi."""
    k = keys.to(torch.int32)
    return (k >= lo_hi[0]) & (k <= lo_hi[1])


key_range.launches = 0  # type: ignore[attr-defined]
#: Launches by kernel branch (``range_branch``).
key_range.branch_launches = dict.fromkeys(  # type: ignore[attr-defined]
    RANGE_BRANCHES, 0)
