"""move_rows — every column of a table gathered through one index map.

The row movement of the exchange's all-to-all (``joins/exchange.py``),
``compact_partitions`` (``joins/table.py``) and the joins' payload merge
(``joins/methods.py``, ``joins/distributed.py``). ``idx`` holds source
row indices, -1 where a slot holds no row; its shape picks the layout:

- ``(S, M)`` or ``(M,)``: ``out[s, m] = col[s, max(idx[s, m], 0)]``, or
  ``col[max(idx[s, m], 0)]`` for a 1-D column (a replica every row reads);
- ``(S, D, pc)``: the all-to-all, written in the received layout
  ``(D, S * pc)``: ``out[d, s * pc + j] = col[s, max(idx[s, d, j], 0)]``.

``valid`` (``idx >= 0``) comes back in the outputs' layout; ``zero_fill``
writes 0 where ``idx < 0`` (a left outer join's unmatched rows). On CUDA
tensors a call launches ``csrc/move_rows.cu`` once per element width
present (1, 4 or 8 bytes; up to ``MAX_COLS`` columns a launch) on the
current stream, reading the index in place, int32 or int64; on CPU tensors
it runs the plain version in ``ref.py``. Every output is a tensor of its
own (``torch.empty``), as the per-column gathers this replaces gave, so
lifetimes and peak memory are theirs. Each call is one ``rj.move`` span.
"""

from __future__ import annotations

import ctypes

import torch

from .. import obs
from . import ref
from .build import check, library
from .launch import cuda_stream

#: Columns one launch carries (``csrc/move_rows.cu``'s kMaxCols).
MAX_COLS = 64
#: Element widths, in bytes, the kernel moves.
WIDTHS = (1, 4, 8)


def move_rows(columns: dict, idx: torch.Tensor, *, zero_fill: bool = False
              ) -> tuple[dict, torch.Tensor]:
    """``(columns, valid)``: each of ``columns`` gathered through ``idx``
    in the layout its shape picks (module docstring)."""
    with obs.span(obs.MOVE):
        if idx.device.type == "cpu":
            return ref.move_rows_ref(columns, idx, zero_fill)
        if idx.device.type != "cuda":
            raise ValueError(f"move_rows: index on {idx.device}, expected "
                             "cuda (CPU tensors take the plain version)")
        return _launch(columns, idx, zero_fill)


def _source(name: str, c: torch.Tensor, rows: int, idx_dim: int):
    """``c`` with unit stride along its rows, and its row stride in
    elements (0 for a replica)."""
    if c.dim() == 1:
        c = c if c.stride(0) == 1 else c.contiguous()
        row_stride = 0
    elif c.dim() == 2 and idx_dim >= 2 and c.shape[0] == rows:
        c = c if c.stride(1) == 1 else c.contiguous()
        row_stride = c.stride(0)
    else:
        raise ValueError(f"move_rows: column {name!r} of shape "
                         f"{tuple(c.shape)} does not fit an index of "
                         f"{rows} rows and {idx_dim} dims")
    if c.shape[-1] == 0:
        raise ValueError(f"move_rows: column {name!r} has no rows to read")
    if c.element_size() not in WIDTHS:
        raise TypeError(f"move_rows: column {name!r} is {c.dtype}; the "
                        f"kernel moves elements of {WIDTHS} bytes")
    return c, row_stride


def _launch(columns: dict, idx: torch.Tensor, zero_fill: bool):
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"move_rows: index is {idx.dtype}, expected int32 "
                        "or int64")
    if idx.dim() == 3:
        s, d, pc = idx.shape
        shape: tuple = (d, s * pc)
    elif idx.dim() in (1, 2):
        s, d, pc = (1, 1, idx.shape[0]) if idx.dim() == 1 else (
            idx.shape[0], 1, idx.shape[1])
        shape = tuple(idx.shape)
    else:
        raise ValueError(f"move_rows: index of shape {tuple(idx.shape)}")
    dev = idx.device
    total = s * d * pc
    if total >= 1 << 31:
        raise ValueError(f"move_rows: {total} slots, the kernel takes "
                         "fewer than 2^31")
    valid = torch.empty(shape, dtype=torch.bool, device=dev)
    out = {n: torch.empty(shape, dtype=c.dtype, device=dev)
           for n, c in columns.items()}
    if total == 0:
        return out, valid
    # Each index row's d * pc entries contiguous; rows any stride apart.
    if idx.stride(-1) != 1 or (idx.dim() == 3 and idx.stride(1) != pc):
        idx = idx.contiguous()
    idx_row = idx.stride(0) if idx.dim() > 1 else 0
    groups: dict = {}  # width -> (source pointers, row strides, outputs)
    for name, c in columns.items():
        if c.device != dev:
            raise ValueError(f"move_rows: column {name!r} on {c.device}, "
                             f"index on {dev}")
        c, row_stride = _source(name, c, s, idx.dim())
        src, strides, dst = groups.setdefault(c.element_size(),
                                              ([], [], []))
        src.append(c.data_ptr())
        strides.append(row_stride)
        dst.append(out[name].data_ptr())
    lib = library()
    valid_ptr = valid.data_ptr()
    with cuda_stream(idx) as stream:
        for width, (src, strides, dst) in (groups or {1: ([], [], [])}
                                           ).items():
            n = len(src)
            src_arr = (ctypes.c_void_p * n)(*src)
            stride_arr = (ctypes.c_longlong * n)(*strides)
            dst_arr = (ctypes.c_void_p * n)(*dst)
            err = lib.repro_move_rows(
                idx.data_ptr(), idx.element_size(), idx_row, s, d, pc, width,
                n, ctypes.addressof(src_arr), ctypes.addressof(stride_arr),
                ctypes.addressof(dst_arr), int(zero_fill), valid_ptr, stream)
            check(err, "move_rows")
            valid_ptr = None  # the first launch writes it
            move_rows.launches += max(1, -(-n // MAX_COLS))
    return out, valid


move_rows.launches = 0  # type: ignore[attr-defined]
