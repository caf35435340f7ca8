"""Slotted scatter — the fixed-shape primitive behind shuffle and radix
bucketing.

Given per-row destination ids, place each valid row into a fixed-capacity
slot array ``(nd, cap)`` of *source row indices* (-1 = empty). Rows beyond a
destination's capacity are dropped and counted as overflow — the engine's
skew signal.

Every function takes a leading batch axis (one row per partition) where the
JAX reference vmaps over partitions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.move_rows import move_rows

# Distinct multiplicative mix seeds: shuffle destinations and radix buckets
# must be decorrelated or post-shuffle partitions would collapse into a few
# buckets (murmur3 finalizer constants).
SHUFFLE_SEED = 0x9E3779B1
BUCKET_SEED = 0x85EBCA6B

_MASK32 = 0xFFFFFFFF


def pair_capacity(cap: int, nd: int, factor: float = 2.0) -> int:
    """Slot capacity per (source, destination) pair.

    Mean occupancy is cap/nd; the binomial tail needs ~sqrt slack for small
    partitions, on top of the user's skew ``factor`` (paper §3.7 maps skew
    handling to capacity sizing).
    """
    mean = cap / nd
    return max(8, int(mean * factor + 4.0 * mean ** 0.5 + 8))


def hash32(keys: torch.Tensor, seed: int) -> torch.Tensor:
    """Murmur-style avalanche of int32 keys -> uint32 hashes, held in int64.

    Bit-equal to the uint32 arithmetic of the reference: every product is
    cut back to 32 bits, so the shifts see the same bits. int64 keeps ``>>``
    and ``%`` available on every device."""
    h = keys.to(torch.int64) & _MASK32
    h = (h * seed) & _MASK32
    h = h ^ (h >> 15)
    h = (h * 0xC2B2AE35) & _MASK32
    h = h ^ (h >> 13)
    return h


class SlotScatter(NamedTuple):
    idx: torch.Tensor       # (B, nd, cap) int32 source row index, -1 = empty
    overflow: torch.Tensor  # (B,) int64 number of dropped valid rows


def group_by_dest(dest: torch.Tensor, valid: torch.Tensor, nd: int):
    """Stable grouping of each batch row's entries by destination.

    Returns ``(order, d_sorted, pos, counts)``: ``(B, n)`` the source index
    of each sorted entry, its destination (``nd`` for invalid rows, which
    sort last) and its position within its destination's group; ``(B, nd)``
    the number of valid entries per destination."""
    bsz, n = dest.shape
    d = torch.where(valid, dest, nd).to(torch.int32)  # invalid -> virtual bin
    order = torch.argsort(d, dim=1, stable=True)       # rows grouped by dest
    d_sorted = torch.gather(d, 1, order)
    bins = torch.arange(nd + 1, dtype=torch.int32, device=d.device)
    starts = torch.searchsorted(d_sorted,
                                bins.expand(bsz, nd + 1).contiguous())
    pos = (torch.arange(n, device=d.device)
           - torch.gather(starts, 1, d_sorted.to(torch.int64)))
    return order, d_sorted.to(torch.int64), pos, starts.diff(dim=1)


def slot_scatter(dest: torch.Tensor, valid: torch.Tensor, nd: int, cap: int
                 ) -> SlotScatter:
    """Group each batch row's entries by destination into fixed slots.

    dest: (B, n) integer in [0, nd); valid: (B, n) bool.
    """
    bsz = dest.shape[0]
    order, d_sorted, pos, _ = group_by_dest(dest, valid, nd)
    live = d_sorted < nd
    keep = live & (pos < cap)
    # Dropped rows land in one spare trailing slot, sliced off below.
    flat = torch.where(keep, d_sorted * cap + pos, nd * cap)
    out = torch.full((bsz, nd * cap + 1), -1, dtype=torch.int32,
                     device=dest.device)
    out.scatter_(1, flat, order.to(torch.int32))
    overflow = (live & (pos >= cap)).sum(dim=1)
    return SlotScatter(out[:, :nd * cap].reshape(bsz, nd, cap), overflow)


def gather_rows(columns: dict, idx: torch.Tensor, zero_fill: bool = False):
    """Gather rows by (possibly -1) source indices; returns (columns, valid).

    A 1-D column is indexed by ``idx`` of any shape (a shared replica); a
    column ``(B, n)`` is indexed per batch row by ``idx`` of shape
    ``(B, ...)``. Every output has ``idx``'s shape; ``zero_fill`` gives 0
    where ``idx`` is -1 (row 0 otherwise). One ``move_rows`` call."""
    flat = idx.reshape(idx.shape[0], -1) if idx.dim() > 2 else idx
    cols, valid = move_rows(columns, flat, zero_fill=zero_fill)
    if flat is idx:
        return cols, valid
    return ({n: c.reshape(idx.shape) for n, c in cols.items()},
            valid.reshape(idx.shape))
