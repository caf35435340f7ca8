"""Local join phase (paper §2.1.2), for all partitions at once.

Each local join resolves, for every probe row of A, the matching build row
of B (PK build side: unique keys, FK->PK star joins), returning
``(match_idx, found)``. The distributed methods gather B's payload columns
through ``match_idx`` afterwards.

Probe inputs are ``(P, na)``: one row per partition. Build inputs are
``(P, nb)`` (co-partitioned) or ``(nb,)`` (one replica every partition
reads, after a broadcast).

The *hash* join is a radix hash join — bucket both sides by a multiplicative
hash, then match keys within each bucket (the ``tiled_probe`` kernel, one
launch for every partition and bucket; a gather path with identical
semantics stays available). The *sort* join sorts the build side (the
``bitonic_sort_tile`` kernel, or a stable sort) and merges by binary search.
The *nested-loop* join evaluates an arbitrary row predicate on every
(probe row, build row) pair, in chunks of probe rows that bound the pair
matrix's memory.

Invalid-row sentinels: probe side -1, build side -2 (never equal).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import obs
from ..kernels import ops as kops
from ..kernels import ref as kref
from .slots import BUCKET_SEED, group_by_dest, hash32, slot_scatter

A_SENTINEL = -1
B_SENTINEL = -2
INT32_MAX = torch.iinfo(torch.int32).max
#: Most (probe row, build row) pairs one nested-loop chunk evaluates: its
#: predicate's boolean matrices stay near 64 MB each.
NL_MAX_PAIRS = 1 << 26


class LocalJoinResult(NamedTuple):
    match_idx: torch.Tensor  # (P, na) int32 row index into B, -1 = none
    found: torch.Tensor      # (P, na) bool


def _sanitize(keys: torch.Tensor, valid: torch.Tensor, sentinel: int
              ) -> torch.Tensor:
    return torch.where(valid, keys, sentinel).to(torch.int32)


def _take_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[r, clamp(idx[r, ...], 0)] per batch row r."""
    safe = idx.clamp(min=0).to(torch.int64)
    flat = torch.gather(values, 1, safe.reshape(values.shape[0], -1))
    return flat.reshape(idx.shape)


# ---------------------------------------------------------------------------
# Hash join (radix-bucketed tiled match).
# ---------------------------------------------------------------------------

def _bucket_of(keys: torch.Tensor, nb: int) -> torch.Tensor:
    return (hash32(keys, BUCKET_SEED) % nb).to(torch.int32)


def hash_join(a_keys: torch.Tensor, a_valid: torch.Tensor,
              b_keys: torch.Tensor, b_valid: torch.Tensor,
              *, n_buckets: int | None = None,
              bucket_cap_factor: float = 4.0,
              use_kernel: bool = False) -> LocalJoinResult:
    """Radix hash join of every partition. Build side keys must be unique.

    Build: scatter B rows into ``nb`` hash buckets of fixed capacity
    (C'_build ~ |B|). Probe: each A row inspects only its bucket's keys
    (C_probe ~ |A| + fanout*|B|). With ``use_kernel`` A is laid out by
    bucket in probe tiles too, and one ``tiled_probe`` launch matches every
    tile against its bucket's build keys; otherwise each probe row gathers
    its bucket's tile and compares — identical semantics.

    As in the reference, build rows past a bucket's capacity are dropped
    without a check (``slot_scatter``'s overflow is not read). Probe rows
    are never dropped (see ``_probe_tiles``).
    """
    bsz, na = a_keys.shape
    b_cap = b_keys.shape[-1]
    ak = _sanitize(a_keys, a_valid, A_SENTINEL)
    bk = _sanitize(b_keys, b_valid, B_SENTINEL)
    shared = bk.dim() == 1
    if shared:  # one replica for every partition
        bk, b_valid = bk[None], b_valid[None]

    nb = n_buckets or max(1, min(1 << (max(b_cap, 1) - 1).bit_length(),
                                 max(8, b_cap // 32)))
    b_slot_cap = max(8, int(-(-b_cap * bucket_cap_factor) // nb))

    # Build: bucket B (the "hash map" is the slotted (nb, cap) layout).
    scat_b = slot_scatter(_bucket_of(bk, nb), b_valid, nb, b_slot_cap)
    bk_bucketed = torch.where(scat_b.idx >= 0, _take_rows(bk, scat_b.idx),
                              B_SENTINEL)  # (P or 1, nb, cap_b)
    ab = _bucket_of(ak, nb)

    if not use_kernel:
        # Probe: gather each A row's bucket tile and match within it.
        rows = 0 if shared else torch.arange(bsz, device=ak.device)[:, None]
        cand_keys = bk_bucketed[rows, ab]          # (P, na, cap_b)
        cand_rows = scat_b.idx[rows, ab]           # (P, na, cap_b)
        hit = cand_keys == ak[..., None]
        slot = torch.argmax(hit.to(torch.uint8), dim=2, keepdim=True)
        found = hit.any(dim=2)
        idx = torch.gather(cand_rows, 2, slot)[..., 0]
        found = found & (idx >= 0) & a_valid
        return LocalJoinResult(torch.where(found, idx, -1).to(torch.int32),
                               found)

    # Kernel path: bucket A as well, one dense tile match per probe tile.
    a_slot_cap = max(8, int(-(-na * bucket_cap_factor) // nb))
    a_rows, tile_bucket = _probe_tiles(ab, a_valid, nb, a_slot_cap)
    part = tile_bucket // nb                               # (T,)
    a_tiles = torch.where(a_rows >= 0,
                          ak[part[:, None], a_rows.clamp(min=0)], A_SENTINEL)
    b_tile = tile_bucket % nb if shared else tile_bucket
    slot_in_bucket = kops.probe(
        a_tiles, bk_bucketed.reshape(-1, b_slot_cap)[b_tile])  # (T, cap_a)
    # Resolve to B row ids and scatter back to A's original row order.
    b_rows = torch.gather(scat_b.idx.reshape(-1, b_slot_cap)[b_tile], 1,
                          slot_in_bucket.clamp(min=0).to(torch.int64))
    b_rows = torch.where(slot_in_bucket >= 0, b_rows, -1)  # (T, cap_a)
    # Empty slots land in one spare trailing element, sliced off below.
    target = torch.where(a_rows >= 0, part[:, None] * na + a_rows, bsz * na)
    out = torch.full((bsz * na + 1,), -1, dtype=torch.int32, device=ak.device)
    out.scatter_(0, target.reshape(-1), b_rows.reshape(-1))
    out = out[:-1].reshape(bsz, na)
    found = (out >= 0) & a_valid
    return LocalJoinResult(torch.where(found, out, -1), found)


def _probe_tiles(ab: torch.Tensor, a_valid: torch.Tensor, nb: int,
                 tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Lay the probe rows out by bucket in tiles of ``tile`` slots.

    The reference gives every (partition, bucket) pair one tile and drops
    the probe rows past its capacity, so they come out unmatched. Here a
    bucket of ``c`` rows takes ``ceil(c / tile)`` tiles, each probed against
    the bucket's build keys: no row is dropped, and a bucket that fits in
    one tile is laid out as in the reference. Returns ``(rows, buckets)``:
    ``rows`` (T, tile) holds each slot's row index in its partition (-1
    empty), ``buckets`` (T,) each tile's ``partition * nb + bucket``.
    """
    bsz, na = ab.shape
    order, d_sorted, pos, counts = group_by_dest(ab, a_valid, nb)
    n_tiles = ((counts + tile - 1) // tile).reshape(-1)  # (P*nb,)
    first_tile = torch.cumsum(n_tiles, 0) - n_tiles
    with obs.sync("tiles"):
        total = int(n_tiles.sum())
    bucket = (torch.arange(bsz, device=ab.device)[:, None] * nb
              + d_sorted.clamp(max=nb - 1))
    tile_id = first_tile[bucket] + torch.div(pos, tile, rounding_mode="floor")
    # Invalid rows (sorted to the end as bin nb) go to a spare slot.
    flat = torch.where(d_sorted < nb, tile_id * tile + pos % tile,
                       total * tile)
    rows = torch.full((total * tile + 1,), -1, dtype=torch.int32,
                      device=ab.device)
    rows.scatter_(0, flat.reshape(-1), order.to(torch.int32).reshape(-1))
    with obs.sync("tile_buckets"):
        # Without ``output_size`` the output's length is read back.
        buckets = torch.repeat_interleave(
            torch.arange(bsz * nb, device=ab.device), n_tiles)
    return rows[:-1].reshape(total, tile), buckets


# ---------------------------------------------------------------------------
# Sort join (sort the build side, merge by binary search).
# ---------------------------------------------------------------------------

def sort_join(a_keys: torch.Tensor, a_valid: torch.Tensor,
              b_keys: torch.Tensor, b_valid: torch.Tensor,
              *, use_kernel_sort: bool = False) -> LocalJoinResult:
    """Sort-merge join of every co-partition (all inputs ``(P, n)``). Build
    side keys must be unique.

    The build side is sorted by key (C_sort ~ |B| log b/p); each probe row
    binary-searches the sorted run (C_merge ~ |A|+|B|). Output rows remain
    addressed in A's original order.
    """
    ak = _sanitize(a_keys, a_valid, INT32_MAX)  # invalid last
    bk = _sanitize(b_keys, b_valid, INT32_MAX)
    bsz, nb = bk.shape

    rows_b = torch.arange(nb, dtype=torch.int32, device=bk.device)
    rows_b = rows_b.expand(bsz, nb).contiguous()
    if use_kernel_sort:
        bk_sorted, b_perm = kops.sort_pairs(bk, rows_b)
    else:
        bk_sorted, b_perm = kref.bitonic_sort_ref(bk, rows_b)

    pos = torch.searchsorted(bk_sorted, ak).clamp(max=nb - 1)
    found = (torch.gather(bk_sorted, 1, pos) == ak) & a_valid
    idx = torch.gather(b_perm, 1, pos)
    found = found & _take_rows(b_valid, idx)
    return LocalJoinResult(torch.where(found, idx, -1).to(torch.int32), found)


# ---------------------------------------------------------------------------
# Nested loop (arbitrary predicate; O(na * nb)).
# ---------------------------------------------------------------------------

def nl_chunk_rows(nb: int, max_pairs: int = NL_MAX_PAIRS) -> int:
    """Probe rows per nested-loop chunk against ``nb`` build rows."""
    return max(1, max_pairs // max(nb, 1))


def nested_loop_join(a_cols: dict, a_valid: torch.Tensor,
                     b_cols: dict, b_valid: torch.Tensor,
                     predicate: Callable[[dict, dict], torch.Tensor],
                     *, max_pairs: int = NL_MAX_PAIRS) -> LocalJoinResult:
    """First-match nested loop with an arbitrary row predicate.

    A's columns are ``(P, na)``, B's ``(nb,)``: one replica every
    partition reads. ``predicate`` receives A columns shaped (n, 1) and B
    columns shaped (1, nb) and returns an (n, nb) boolean matrix. The
    reference evaluates every partition's whole (na, nb) matrix at once;
    here A's rows, all partitions flattened, are taken ``nl_chunk_rows``
    at a time, so no matrix holds more than ``max_pairs`` entries. Each
    probe row keeps its first matching build row: ``torch.argmax``
    returns the first maximal index, as ``jnp.argmax`` does, and takes no
    bool input, hence the ``uint8``.
    """
    shape = a_valid.shape
    av = a_valid.reshape(-1)
    flat = {n: c.reshape(-1) for n, c in a_cols.items()}
    b_b = {n: c[None, :] for n, c in b_cols.items()}
    nb = b_valid.shape[0]
    idx = torch.full((av.numel(),), -1, dtype=torch.int32,
                     device=av.device)
    found = torch.zeros(av.numel(), dtype=torch.bool, device=av.device)
    if nb:
        step = nl_chunk_rows(nb, max_pairs)
        for s in range(0, av.numel(), step):
            a_b = {n: c[s:s + step, None] for n, c in flat.items()}
            hit = (predicate(a_b, b_b) & av[s:s + step, None]
                   & b_valid[None, :])
            f = hit.any(dim=1)
            first = torch.argmax(hit.to(torch.uint8), dim=1)
            idx[s:s + step] = torch.where(f, first, -1).to(torch.int32)
            found[s:s + step] = f
    return LocalJoinResult(idx.reshape(shape), found.reshape(shape))
