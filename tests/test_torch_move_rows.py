"""The row mover (``repro_torch.kernels.move_rows``) on the CPU.

The plain version against the per-column semantics it replaced, slot by
slot in numpy loops: a gather through an ``(S, M)`` index, a replica
column, the all-to-all's received layout; int32, float32, bool and int64
columns; with and without zero fill; on an empty index and an index of -1
only. Then the kernel path's plumbing (pointers, row strides of strided
views, element widths, launches, the received layout) on CPU tensors,
through a stand-in library that computes ``csrc/move_rows.cu``'s C entry
point in numpy, against the plain version bit for bit.
"""

import contextlib
import ctypes
import zlib

import numpy as np
import pytest
import torch

from repro_torch.joins.slots import gather_rows, pair_capacity, slot_scatter
from repro_torch.kernels import move_rows as mr
from repro_torch.kernels import ops, ref

DTYPES = {"int32": torch.int32, "float32": torch.float32, "bool": torch.bool,
          "int64": torch.int64}


def _column(rng, shape, dtype):
    if dtype == torch.bool:
        return torch.from_numpy(rng.random(shape) < 0.5)
    if dtype == torch.float32:
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, shape)
                            ).to(dtype)


def _index(rng, shape, n_rows, case):
    if case == "empty":
        return torch.zeros(shape, dtype=torch.int32)
    i = rng.integers(0, n_rows, shape)
    i[rng.random(shape) < (1.0 if case == "all_invalid" else 0.3)] = -1
    return torch.from_numpy(i.astype(np.int32))


def _slot_by_slot(col, idx, mode, zero_fill):
    """The per-column gather, and in the exchange its transpose, one slot
    at a time."""
    c, i = col.numpy(), idx.numpy()
    zero = np.zeros((), c.dtype)
    if mode == "all_to_all":
        s_n, d_n, pc = i.shape
        out = np.empty((d_n, s_n * pc), c.dtype)
        for s in range(s_n):
            for d in range(d_n):
                for j in range(pc):
                    k = i[s, d, j]
                    out[d, s * pc + j] = (zero if zero_fill and k < 0
                                          else c[s, max(k, 0)])
        return out
    out = np.empty(i.shape, c.dtype)
    for s, m in np.ndindex(*i.shape):
        k = i[s, m]
        row = c if mode == "replica" else c[s]
        out[s, m] = zero if zero_fill and k < 0 else row[max(k, 0)]
    return out


@pytest.mark.parametrize("case", ["random", "empty", "all_invalid"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("zero_fill", [False, True])
@pytest.mark.parametrize("mode", ["rows", "replica", "all_to_all"])
def test_plain_mover_is_the_per_column_gather(mode, zero_fill, dtype, case):
    rng = np.random.default_rng(zlib.crc32(f"{mode} {dtype} {case}".encode()))
    s, n = 3, 11
    slots = 0 if case == "empty" else 7
    if mode == "all_to_all":
        col, idx = (_column(rng, (s, n), DTYPES[dtype]),
                    _index(rng, (s, 4, slots), n, case))
    elif mode == "replica":
        col, idx = (_column(rng, (n,), DTYPES[dtype]),
                    _index(rng, (s, slots), n, case))
    else:
        col, idx = (_column(rng, (s, n), DTYPES[dtype]),
                    _index(rng, (s, slots), n, case))
    cols, valid = mr.move_rows({"x": col}, idx, zero_fill=zero_fill)
    want = _slot_by_slot(col, idx, mode, zero_fill)
    got = cols["x"].numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    live = (idx >= 0).numpy()
    if mode == "all_to_all":
        live = live.transpose(1, 0, 2).reshape(want.shape)
    np.testing.assert_array_equal(valid.numpy(), live)


class _Library:
    """``repro_move_rows`` computed in numpy on the memory behind the
    pointers, as ``csrc/move_rows.cu`` states it."""

    def __init__(self):
        self.calls = []

    def repro_move_rows(self, idx, idx_bytes, idx_row, s_n, d_n, pc, width,
                        ncols, src, stride, dst, zero_fill, valid, stream):
        self.calls.append((width, ncols, valid is not None))
        index_t = {4: ctypes.c_int32, 8: ctypes.c_int64}[idx_bytes]
        elem_t = {1: ctypes.c_uint8, 4: ctypes.c_uint32,
                  8: ctypes.c_uint64}[width]
        srcs = (ctypes.c_void_p * ncols).from_address(src)
        strides = (ctypes.c_longlong * ncols).from_address(stride)
        dsts = (ctypes.c_void_p * ncols).from_address(dst)
        total = s_n * d_n * pc
        per_src = d_n * pc
        ix = np.ctypeslib.as_array(
            (index_t * ((s_n - 1) * idx_row + per_src)).from_address(idx))
        t = np.arange(total)
        s, r = t // per_src, t % per_src
        d, j = r // pc, r % pc
        i = ix[s * idx_row + r].astype(np.int64)
        live, at = i >= 0, np.maximum(i, 0)
        to = d * s_n * pc + s * pc + j
        if valid is not None:
            np.ctypeslib.as_array(
                (ctypes.c_uint8 * total).from_address(valid))[to] = live
        for k in range(ncols):
            need = (s_n - 1) * strides[k] + int(at.max()) + 1
            col = np.ctypeslib.as_array((elem_t * need).from_address(srcs[k]))
            v = col[s * strides[k] + at]
            if zero_fill:
                v = np.where(live, v, 0)
            np.ctypeslib.as_array(
                (elem_t * total).from_address(dsts[k]))[to] = v
        return 0


def _plumbing_case(name):
    """(columns, idx, zero_fill) for the stand-in library."""
    rng = np.random.default_rng(len(name))
    p, cap = 4, 301
    if name == "exchange":
        valid = torch.from_numpy(rng.random((p, cap)) < 0.9)
        dest = torch.from_numpy(rng.integers(0, p, (p, cap)).astype(
            np.int32))
        idx = slot_scatter(dest, valid, p, pair_capacity(cap, p)).idx
        assert not idx.is_contiguous()  # read in place, rows apart
        cols = {f"c{k}": _column(rng, (p, cap), t) for k, t in
                enumerate(DTYPES.values())}
        return cols, idx, False
    if name == "compaction":
        invalid = torch.from_numpy(rng.random((p, cap)) < 0.5).to(
            torch.uint8)
        idx = torch.argsort(invalid, dim=1, stable=True)[:, :128]
        return {"a": _column(rng, (p, cap), torch.int32),
                "b": _column(rng, (p, cap), torch.float32)}, idx, False
    if name == "replica_outer":
        return ({"a": _column(rng, (50,), torch.int32),
                 "m": _column(rng, (50,), torch.bool)},
                _index(rng, (p, cap), 50, "random"), True)
    if name == "many_columns":
        return ({f"c{k}": _column(rng, (p, cap), torch.float32)
                 for k in range(mr.MAX_COLS + 6)},
                _index(rng, (p, cap), cap, "random"), True)
    if name == "strided_column":
        wide = _column(rng, (p, 2 * cap), torch.int32)
        return ({"rows": wide[:, :cap],
                 "cols": wide.t().contiguous().t()[:, :cap]},
                _index(rng, (p, 40), cap, "random"), False)
    if name == "one_dim":
        return ({"a": _column(rng, (9,), torch.int64)},
                _index(rng, (33,), 9, "random"), False)
    if name == "no_columns":
        return {}, _index(rng, (p, 2, 5), cap, "random"), False
    if name == "empty":
        return ({"a": _column(rng, (p, cap), torch.int32)},
                _index(rng, (p, p, 0), cap, "random"), False)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["exchange", "compaction", "replica_outer",
                                  "many_columns", "strided_column",
                                  "one_dim", "no_columns", "empty"])
def test_kernel_path_plumbing(monkeypatch, name):
    columns, idx, zero_fill = _plumbing_case(name)
    lib = _Library()
    monkeypatch.setattr(mr, "library", lambda: lib)
    monkeypatch.setattr(mr, "cuda_stream",
                        lambda t: contextlib.nullcontext(0))
    before = mr.move_rows.launches
    got, got_valid = mr._launch(columns, idx, zero_fill)
    want, want_valid = ref.move_rows_ref(columns, idx, zero_fill)
    assert torch.equal(got_valid, want_valid)
    assert list(got) == list(want)
    for n, w in want.items():
        assert got[n].dtype == w.dtype and got[n].shape == w.shape, n
        assert torch.equal(got[n].view(torch.uint8), w.view(torch.uint8)), n
    widths = {}
    for c in columns.values():
        widths[c.element_size()] = widths.get(c.element_size(), 0) + 1
    if idx.numel() == 0:
        assert lib.calls == []
    else:
        # One call per width, the valid mask written by the first.
        assert [(w, k) for w, k, _ in lib.calls] == (
            list(widths.items()) or [(1, 0)])
        assert [v for *_, v in lib.calls] == [True] + [False] * (
            len(lib.calls) - 1)
    launches = sum(-(-k // mr.MAX_COLS) for k in widths.values()) or 1
    assert mr.move_rows.launches - before == (launches if idx.numel() else 0)


def test_kernel_path_refuses_what_it_cannot_move(monkeypatch):
    monkeypatch.setattr(mr, "library", _Library)
    monkeypatch.setattr(mr, "cuda_stream",
                        lambda t: contextlib.nullcontext(0))
    idx = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(TypeError):
        mr._launch({"h": torch.zeros(2, 4, dtype=torch.float16)}, idx, False)
    with pytest.raises(TypeError):
        mr._launch({"a": torch.zeros(2, 4)}, idx.to(torch.int16), False)
    with pytest.raises(ValueError):
        mr._launch({"a": torch.zeros(3, 4)}, idx, False)
    with pytest.raises(ValueError):
        mr._launch({"a": torch.zeros(2, 0)}, idx, False)


def test_gather_rows_keeps_the_index_shape_and_counts_no_launch():
    rng = np.random.default_rng(5)
    cols = {"a": _column(rng, (2, 9), torch.int32)}
    idx = _index(rng, (2, 3, 4), 9, "random")
    ops.reset_launch_counts()
    got, valid = gather_rows(cols, idx, zero_fill=True)
    assert got["a"].shape == valid.shape == idx.shape
    want = _slot_by_slot(cols["a"], idx.reshape(2, 12), "rows", True)
    np.testing.assert_array_equal(got["a"].reshape(2, 12).numpy(), want)
    assert ops.launch_counts()["move_rows"] == 0
