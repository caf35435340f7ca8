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
"""

from __future__ import annotations

import torch

from . import ref
from .build import check, library
from .launch import cuda_stream, flat_keys, flat_valid, require_kernel_input


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
    if not flat.numel():
        out[0], out[1] = ref.INT32_MAX, ref.INT32_MIN
        return out
    with cuda_stream(flat) as stream:
        err = library().repro_key_range(
            flat.data_ptr(), v.data_ptr(), flat.numel(), out.data_ptr(),
            stream)
    check(err, "key_range")
    key_range.launches += 1
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
