"""Plain PyTorch versions of every kernel: the CPU path of each wrapper and
the oracle each CUDA kernel is held against on the card.

They take the kernels' batched shapes (a leading batch axis where the
kernel has one) and repeat the kernels' arithmetic; they are no yardstick
of speed.
"""

from __future__ import annotations

import torch

INT32_MAX = torch.iinfo(torch.int32).max

#: Elements of the (rows, probe slots, nb) equality block the probe oracles
#: build at once; larger inputs are cut into chunks of batch rows and, where
#: one row alone is larger, of probe slots.
_PROBE_BLOCK = 1 << 24


def partition_hist_ref(dest: torch.Tensor, nd: int,
                       valid: torch.Tensor | None = None) -> torch.Tensor:
    """counts[k] = #{i : dest[i] == k} as int32 (nd,); dest < 0 or >= nd
    ignored, and rows whose ``valid`` is False where it is given."""
    keep = (dest >= 0) & (dest < nd)
    if valid is not None:
        keep &= valid
    d = dest[keep].to(torch.int64)
    out = torch.zeros(nd, dtype=torch.int32, device=dest.device)
    return out.index_add_(0, d, torch.ones_like(d, dtype=torch.int32))


def tiled_probe_ref(a_keys: torch.Tensor, b_keys: torch.Tensor
                    ) -> torch.Tensor:
    """out[r, i] = first j with b_keys[r, j] == a_keys[r, i], else -1.

    a_keys: (B, na), b_keys: (B, nb), both int32 -> int32 (B, na)."""
    bsz, na = a_keys.shape
    nb = b_keys.shape[1]
    out = torch.full((bsz, na), -1, dtype=torch.int32, device=a_keys.device)
    if na == 0 or nb == 0:
        return out
    col = torch.arange(nb, dtype=torch.int32, device=a_keys.device)
    rows = max(1, _PROBE_BLOCK // (na * nb))
    slots = na if rows > 1 else max(1, _PROBE_BLOCK // nb)
    for r0 in range(0, bsz, rows):
        b = b_keys[r0:r0 + rows, None, :]
        for i0 in range(0, na, slots):
            eq = a_keys[r0:r0 + rows, i0:i0 + slots, None] == b
            first = torch.where(eq, col, INT32_MAX).amin(dim=2)
            out[r0:r0 + rows, i0:i0 + slots] = torch.where(
                first == INT32_MAX, -1, first)
    return out


def tiled_probe3_ref(a1_keys: torch.Tensor, a2_keys: torch.Tensor,
                     b_keys: torch.Tensor, c_keys: torch.Tensor):
    """The fused three-way probe: ``out1[r, i]`` is the first j < nb with
    ``b_keys[r, j] == a1_keys[r, i]``, ``out2[r, i]`` the first k < nc with
    ``c_keys[r, k] == a2_keys[r, i]``, else -1.

    a1_keys, a2_keys: (B, na), b_keys: (B, nb), c_keys: (B, nc), all int32
    -> two int32 (B, na)."""
    return tiled_probe_ref(a1_keys, b_keys), tiled_probe_ref(a2_keys, c_keys)


def bitonic_sort_ref(keys: torch.Tensor, values: torch.Tensor):
    """Stable ascending sort of each row's (key, value) pairs by key."""
    order = torch.argsort(keys, dim=-1, stable=True)
    return (torch.gather(keys, -1, order), torch.gather(values, -1, order))


def bitonic_network_ref(keys: torch.Tensor, values: torch.Tensor):
    """The reference's bitonic network over each row of (..., n) pairs, n a
    power of two: for k = 2, 4, .., n and j = k/2, .., 1, the pair (i,
    i | j) with bit j of i clear is swapped, keys and values, iff it is
    strictly out of order, ascending iff (i & k) == 0. Ties come out as the
    CUDA kernel leaves them; it is not stable. Only the tests and the
    card's checks use it: the CPU path is ``bitonic_sort_ref``."""
    *lead, n = keys.shape
    rows = keys.reshape(-1, n)
    vals = values.reshape(-1, n)
    index = torch.arange(n, device=keys.device)
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            shape = (rows.shape[0], n // (2 * j), 2, j)
            kr, vr = rows.reshape(shape), vals.reshape(shape)
            lo_k, hi_k, lo_v, hi_v = kr[:, :, 0], kr[:, :, 1], vr[:, :, 0], \
                vr[:, :, 1]
            ascending = (index.reshape(n // (2 * j), 2, j)[:, 0] & k) == 0
            swap = torch.where(ascending, lo_k > hi_k, lo_k < hi_k)
            rows = torch.stack([torch.where(swap, hi_k, lo_k),
                                torch.where(swap, lo_k, hi_k)], dim=2)
            vals = torch.stack([torch.where(swap, hi_v, lo_v),
                                torch.where(swap, lo_v, hi_v)], dim=2)
            rows, vals = rows.reshape(-1, n), vals.reshape(-1, n)
            j //= 2
        k *= 2
    return rows.reshape(*lead, n), vals.reshape(*lead, n)


# ---------------------------------------------------------------------------
# Runtime-filter kernels: bloom pair and zone-map min/max
# ---------------------------------------------------------------------------

#: Decorrelated murmur-style mix seeds of the bloom filter's two base
#: hashes (the reference's ``kernels/bloom.py`` values); the CUDA kernels
#: get them from the wrappers.
BLOOM_SEED_1 = 0x165667B1
BLOOM_SEED_2 = 0xD6E8FEB8

#: The empty zone map [INT32_MAX, INT32_MIN]: lo > hi, matches nothing.
INT32_MIN = torch.iinfo(torch.int32).min

_MASK32 = 0xFFFFFFFF


def bloom_positions(keys: torch.Tensor, i: int, m_bits: int) -> torch.Tensor:
    """Bit position (int64) of hash ``i`` of each int32 key: double hashing
    ``(h1 + i*h2) & (m_bits-1)``, h2 forced odd, in 32-bit arithmetic."""
    # Imported here: ``joins`` imports the kernel wrappers, which import
    # this module.
    from ..joins.slots import hash32
    h1 = hash32(keys, BLOOM_SEED_1)
    h2 = hash32(keys, BLOOM_SEED_2) | 1
    return ((h1 + ((i * h2) & _MASK32)) & _MASK32) & (m_bits - 1)


def bloom_build_ref(keys: torch.Tensor, valid: torch.Tensor, m_bits: int,
                    k: int) -> torch.Tensor:
    """Bloom filter of the valid entries of flat int32 ``keys``: int32
    ``(m_bits/32,)`` words holding the reference's uint32 bit patterns."""
    live = keys[valid]
    bitmap = torch.zeros(m_bits, dtype=torch.bool, device=keys.device)
    for i in range(k):
        bitmap[bloom_positions(live, i, m_bits)] = True
    shifts = torch.arange(32, dtype=torch.int64, device=keys.device)
    words = (bitmap.view(-1, 32).to(torch.int64) << shifts).sum(dim=1)
    return _as_int32_bits(words)


def bloom_probe_ref(keys: torch.Tensor, words: torch.Tensor, k: int
                    ) -> torch.Tensor:
    """True where every one of the k bits of a flat int32 key is set."""
    m_bits = words.numel() * 32
    w = words.to(torch.int64) & _MASK32
    keep = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    for i in range(k):
        pos = bloom_positions(keys, i, m_bits)
        keep &= ((w[pos >> 5] >> (pos & 31)) & 1).bool()
    return keep


def key_range_ref(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """int32 ``(2,)`` [min, max] of the valid entries of flat int32 keys;
    the empty interval [INT32_MAX, INT32_MIN] when none is valid."""
    out = torch.tensor([INT32_MAX, INT32_MIN], dtype=torch.int32,
                       device=keys.device)
    if keys.numel() == 0:
        return out
    lo = torch.where(valid, keys, INT32_MAX).amin()
    hi = torch.where(valid, keys, INT32_MIN).amax()
    return torch.stack([lo, hi]).to(torch.int32)


def _as_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same 32-bit
    patterns."""
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def move_rows_ref(columns: dict, idx: torch.Tensor, zero_fill: bool = False):
    """Every column gathered through one index map (-1 = no row); returns
    ``(columns, valid)`` with ``valid = idx >= 0``.

    A 1-D column is a replica, indexed by ``idx`` of any shape; a column
    ``(S, n)`` is indexed per row by ``idx`` of shape ``(S, ...)``. A
    negative index reads row 0, or gives 0 where ``zero_fill``. An index
    ``(S, D, pc)`` is an all-to-all: every output, ``valid`` too, comes
    back in the received layout ``(D, S * pc)``, slot ``(s, d, j)`` at
    ``[d, s * pc + j]``."""
    safe = idx.clamp(min=0).to(torch.int64)
    valid = idx >= 0
    cols = {}
    for name, c in columns.items():
        if c.dim() == 1:
            g = c[safe]
        else:
            g = torch.gather(c, 1, safe.reshape(c.shape[0], -1)).reshape(
                idx.shape)
        if zero_fill:
            g = torch.where(valid, g, torch.zeros_like(g))
        cols[name] = g
    if idx.dim() == 3:
        s, d, pc = idx.shape
        cols = {n: g.transpose(0, 1).reshape(d, s * pc)
                for n, g in cols.items()}
        valid = valid.transpose(0, 1).reshape(d, s * pc)
    return cols, valid
