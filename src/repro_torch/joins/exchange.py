"""Data-exchange phase: broadcast, shuffle and salted shuffle (paper §2.1.1
plus the skew-aware extension).

Global-view implementations on stacked ``(p, cap)`` tables: the all-to-all
is an axis transpose and the replication a concatenation of partitions.

Every exchange returns an ``ExchangeReport`` whose byte counts are *measured*
(from live rows), so benchmarks can compare the paper's modeled workloads
(Eqs. 1, 5) against ground truth. ``straggler_bytes`` — the load of the
hottest destination partition, counted with the ``partition_hist`` kernel —
is the skew signal: under Zipf keys it, not the mean, bounds wall-clock.

The hypercube exchange replicates rows along the cube axes a relation does
not own. The salted shuffle spreads hot probe keys over several
destinations and replicates their build rows; ``key_skew`` measures the
straggler factor a plain shuffle would have.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import obs
from ..kernels.partition_hist import partition_hist
from .slots import (_MASK32, SHUFFLE_SEED, gather_rows, hash32,
                    pair_capacity, slot_scatter)
from .table import Table, concat_partitions

#: Decorrelated from SHUFFLE_SEED/BUCKET_SEED: salt hashing must not undo
#: the destination hash (murmur3 finalizer constant).
SALT_SEED = 0x27D4EB2F

#: Hot-key detection granularity: nf = HOT_FINE_MULT * p fine hash buckets.
HOT_FINE_MULT = 16

#: A fine bucket is *hot* when its probe mass alone exceeds this share of a
#: partition's fair share (total/p) — routing it unsalted would measurably
#: tilt one partition.
HOT_PARTITION_SHARE = 0.25


@dataclasses.dataclass
class ExchangeReport:
    """Measured workload of one exchange (host-side ints/floats)."""

    kind: str   # "broadcast" | "shuffle" | "salted_shuffle" | "hypercube"
    network_bytes: float       # bytes that crossed partition boundaries
    local_bytes: float         # bytes that stayed partition-local
    overflow_rows: int = 0     # rows dropped by capacity (skew signal)
    elided: bool = False       # exchange skipped (already co-partitioned)
    straggler_bytes: float = 0.0  # bytes landing on the hottest partition


def _dest_partition(key: torch.Tensor, p: int) -> torch.Tensor:
    return (hash32(key, SHUFFLE_SEED) % p).to(torch.int32)


def _flat_hist(ids: torch.Tensor, valid: torch.Tensor, nd: int
               ) -> torch.Tensor:
    """``partition_hist`` of a ``(p, cap)`` id array under its row mask."""
    return partition_hist(ids.reshape(-1).contiguous(), nd=nd,
                          valid=valid.reshape(-1).contiguous())


def _fine_bucket(key: torch.Tensor, nf: int) -> torch.Tensor:
    """Fine hash bucket of a key. With nf a multiple of p, h % nf refines
    h % p exactly: every fine bucket maps wholly into one partition."""
    return (hash32(key, SHUFFLE_SEED) % nf).to(torch.int32)


def _salted_dest(key: torch.Tensor, salt: torch.Tensor, p: int
                 ) -> torch.Tensor:
    """Destination of a (key, salt) pair. Deterministic in both, and salt 0
    reproduces the plain shuffle destination, so cold (unsalted) rows land
    exactly where ``shuffle`` would send them. The two uint32 hashes add
    with the wrap of uint32 arithmetic before ``% p``."""
    h = (hash32(key, SHUFFLE_SEED) + hash32(salt, SALT_SEED)) & _MASK32
    return (h % p).to(torch.int32)


def broadcast(table: Table) -> tuple[Table, ExchangeReport]:
    """Broadcast exchange: every task receives a full replica of ``table``.

    Global view: returns the concatenated unstacked table, which every
    partition's local join reads as its replica. Network workload is Eq. 1's
    (p-1)|B|: each of p tasks fetches the (p-1)/p it doesn't hold. Broadcast
    is skew-invariant: every partition ends up with identical load, so the
    straggler equals the replica size.
    """
    if not table.stacked:
        raise ValueError("broadcast expects a stacked table")
    with obs.span(obs.EXCHANGE, "broadcast"):
        p = table.num_partitions
        full = concat_partitions(table)
        rows = full.count()
        bytes_all = rows * full.row_bytes
        report = ExchangeReport("broadcast",
                                network_bytes=(p - 1) * bytes_all,
                                local_bytes=bytes_all,
                                straggler_bytes=float(bytes_all))
        return full, report


def _exchange_by_dest(table: Table, dest: torch.Tensor, pair_cap: int,
                      partitioned_by: str | None, kind: str = "shuffle"
                      ) -> tuple[Table, ExchangeReport]:
    """Slotted all-to-all by explicit per-row destinations.

    Each source partition packs rows into per-destination slots of fixed
    capacity; the (p_src, p_dst, cap) buffer is exchanged (global view: a
    transpose) and flattened to (p_dst, p_src*cap). Network workload is
    *measured*: bytes of rows whose destination differs from their source;
    the straggler is the hottest destination's landed bytes (partition_hist
    of the destination ids).
    """
    with obs.span(obs.EXCHANGE, kind):
        p = table.num_partitions
        # (p_src, p_dst, pc)
        scat = slot_scatter(dest, table.valid, p, pair_cap)

        send_cols, send_valid = gather_rows(table.columns, scat.idx)
        # all_to_all == axis transpose in the global view.
        recv_cols = {n: c.transpose(0, 1).reshape(p, p * pair_cap)
                     for n, c in send_cols.items()}
        recv_valid = send_valid.transpose(0, 1).reshape(p, p * pair_cap)
        out = Table(recv_cols, recv_valid, partitioned_by=partitioned_by)

        # Measured workload: rows that actually crossed partitions, plus the
        # per-destination load histogram for straggler accounting.
        src_ids = torch.arange(p, dtype=torch.int32,
                               device=dest.device)[:, None]
        moved = (table.valid & (dest != src_ids)).sum()
        stayed = (table.valid & (dest == src_ids)).sum()
        loads = _flat_hist(dest, table.valid, p)
        rb = table.row_bytes
        with obs.sync("exchange"):
            network_bytes = float(moved) * rb
        with obs.sync("exchange"):
            local_bytes = float(stayed) * rb
        with obs.sync("exchange"):
            overflow_rows = int(scat.overflow.sum())
        with obs.sync("exchange"):
            straggler_bytes = float(loads.max()) * rb
        report = ExchangeReport(kind, network_bytes=network_bytes,
                                local_bytes=local_bytes,
                                overflow_rows=overflow_rows,
                                straggler_bytes=straggler_bytes)
        return out, report


def shuffle(table: Table, key: str, capacity_factor: float = 2.0
            ) -> tuple[Table, ExchangeReport]:
    """Shuffle exchange: repartition rows by hash(key) across p partitions.

    Network workload is *measured*: bytes of rows whose destination differs
    from their source (Eq. 5 models this as ((p-1)/p)(|A|+|B|)).
    """
    if not table.stacked:
        raise ValueError("shuffle expects a stacked table")
    if table.partitioned_by == key:
        # Already hash-partitioned on this key: the exchange is a no-op
        # (paper §3.7: all rows pre-placed -> C_shuffle = 0).
        return table, ExchangeReport("shuffle", 0.0, 0.0, elided=True)
    p, cap = table.num_partitions, table.capacity
    pair_cap = pair_capacity(cap, p, capacity_factor)
    dest = _dest_partition(table.column(key), p)  # (p, cap)
    return _exchange_by_dest(table, dest, pair_cap, key)


# ---------------------------------------------------------------------------
# Hypercube replication exchange (multi-way joins on cyclic join graphs).
# ---------------------------------------------------------------------------


def hypercube_shuffle(table: Table, dims: tuple[int, ...],
                      axis_keys: tuple[tuple[int, str], ...],
                      capacity_factor: float = 2.0
                      ) -> tuple[Table, ExchangeReport]:
    """Hypercube exchange: the p partitions are a cube of shape ``dims``
    (one axis per join variable, prod(dims) = p, C-order flattening) and
    ``axis_keys`` lists the (axis, key column) pairs this relation *owns*.

    Each row is hash-partitioned on its owned axes' coordinates
    (``hash(key) % dims[axis]``, the same hash both sides of a shared
    variable use) and **replicated** along every axis the relation does not
    own — one copy per combination of free-axis coordinates, a factor
    f = p / prod(owned shares). Any tuple of rows agreeing on all shared
    variables therefore meets on exactly one partition, which is what lets
    the local multi-way probe evaluate a cyclic core without binary
    intermediates. Network workload is *measured* over all f copies —
    ground truth for the modeled replication volume |R| * (p / p_i).

    Degenerate cases fall out naturally: at p = 1 (all shares 1) nothing
    moves, and a flat mesh (one axis of share p, everything else share 1)
    reproduces a plain key shuffle for the axis owner.
    """
    if not table.stacked:
        raise ValueError("hypercube_shuffle expects a stacked table")
    p = 1
    for d in dims:
        p *= d
    if p != table.num_partitions:
        raise ValueError(f"cube {dims} has {p} cells but table has "
                         f"{table.num_partitions} partitions")
    owned = {ax for ax, _ in axis_keys}
    if any(ax < 0 or ax >= len(dims) for ax in owned):
        raise ValueError(f"axis out of range for cube {dims}: {axis_keys}")
    free = [ax for ax in range(len(dims)) if ax not in owned]
    f = 1
    for ax in free:
        f *= dims[ax]
    # C-order flat index: stride of axis j is prod(dims[j+1:]).
    strides = [1] * len(dims)
    for j in range(len(dims) - 2, -1, -1):
        strides[j] = strides[j + 1] * dims[j + 1]
    cap = table.capacity
    wide_cols = {n: c.repeat(1, f) for n, c in table.columns.items()}
    wide_valid = table.valid.repeat(1, f)
    dest = torch.zeros(wide_valid.shape, dtype=torch.int32,
                       device=wide_valid.device)
    for ax, col in axis_keys:
        coord = (hash32(wide_cols[col], SHUFFLE_SEED) % dims[ax]).to(
            torch.int32)
        dest = dest + coord * strides[ax]
    # Replica r of a row takes the r-th combination of free-axis
    # coordinates (mixed radix over the free shares).
    rem = torch.arange(f, dtype=torch.int32, device=dest.device
                       ).repeat_interleave(cap)[None, :]
    for ax in free:
        dest = dest + (rem % dims[ax]) * strides[ax]
        rem = rem // dims[ax]
    wide = Table(wide_cols, wide_valid)
    pair_cap = pair_capacity(cap * f, p, capacity_factor)
    return _exchange_by_dest(wide, dest, pair_cap, None, kind="hypercube")


# ---------------------------------------------------------------------------
# Skew mitigation: salted shuffle (hot-key spreading + build replication).
# ---------------------------------------------------------------------------


def hot_fine_buckets(table: Table, key: str, nf: int, p: int,
                     hot_share: float = HOT_PARTITION_SHARE
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Hot-bucket mask of ``table``'s key column.

    Bucket mass comes from the ``partition_hist`` kernel over nf fine hash
    buckets; a bucket is hot when its mass alone exceeds ``hot_share`` of a
    partition's fair share (total/p). On uniform keys no bucket comes close
    (fine means are total/nf = total/(16p)), so nothing is salted. The
    threshold is computed in float32, as the reference computes it.

    Returns ``(hot, fine)``: the boolean (nf,) mask and the key column's own
    fine-bucket ids (so the caller need not re-hash the hot table).
    """
    fine = _fine_bucket(table.column(key), nf)
    counts = _flat_hist(fine, table.valid, nf)
    threshold = counts.sum().to(torch.float32) * hot_share / p
    return counts.to(torch.float32) > threshold, fine


def salted_shuffle(a: Table, a_key: str, b: Table, b_key: str, r: int,
                   capacity_factor: float = 2.0,
                   fine_mult: int = HOT_FINE_MULT,
                   hot_share: float = HOT_PARTITION_SHARE
                   ) -> tuple[Table, Table, ExchangeReport, ExchangeReport]:
    """Skew-mitigating co-shuffle of probe side A and build side B.

    Hot keys are detected at fine-hash-bucket granularity from A's key
    histogram. Hot probe rows get a deterministic salt in [0, r) — spreading
    each hot key over r destinations — while build rows whose key falls in a
    hot bucket are replicated once per salt value, so every destination a
    salted probe row can reach holds the matching build row. Cold rows keep
    salt 0, whose destination equals the plain shuffle destination.

    Hotness is a pure function of the key (via A's histogram) applied
    identically on both sides: a probe row is salted iff its build match is
    replicated, which is exactly the agreement the join needs.
    """
    if not (a.stacked and b.stacked):
        raise ValueError("salted_shuffle expects stacked tables")
    p = a.num_partitions
    r = max(2, int(r))
    nf = fine_mult * p
    hot, a_fine = hot_fine_buckets(a, a_key, nf, p, hot_share)

    # Probe: deterministic per-row salt for hot rows (round-robin within the
    # source partition by capacity index, offset by the partition id to
    # decorrelate sources).
    ak = a.column(a_key)
    dev = ak.device
    a_hot = hot[a_fine.to(torch.int64)]
    row = torch.arange(ak.shape[1], dtype=torch.int32, device=dev)[None, :]
    src = torch.arange(ak.shape[0], dtype=torch.int32, device=dev)[:, None]
    salt_a = torch.where(a_hot, (row + src) % r, 0).to(torch.int32)
    a_sh, ex_a = _exchange_by_dest(
        a, _salted_dest(ak, salt_a, p),
        pair_capacity(a.capacity, p, capacity_factor),
        None, kind="salted_shuffle")

    # Build: replicate along the capacity axis; replica j of a row is live
    # iff j == 0 (the plain copy) or the row's key is hot. Replicas of the
    # same key landing on one partition leave duplicate build keys there —
    # harmless for FK->PK joins (identical payload, first match wins).
    bk = b.column(b_key)
    b_hot = hot[_fine_bucket(bk, nf).to(torch.int64)]
    cap_b = b.capacity
    salt_b = torch.arange(r, dtype=torch.int32, device=dev
                          ).repeat_interleave(cap_b)[None, :]
    wide_valid = b.valid.repeat(1, r) & ((salt_b == 0) | b_hot.repeat(1, r))
    b_wide = Table({n: c.repeat(1, r) for n, c in b.columns.items()},
                   wide_valid)
    dest_b = _salted_dest(bk.repeat(1, r), salt_b.expand(wide_valid.shape),
                          p)
    b_sh, ex_b = _exchange_by_dest(
        b_wide, dest_b, pair_capacity(cap_b, p, capacity_factor),
        None, kind="salted_shuffle")
    return a_sh, b_sh, ex_a, ex_b


def key_skew(table: Table, key: str, p: int | None = None,
             floor: float = 1.1) -> float:
    """Measured straggler factor of hash-partitioning ``table`` by ``key``:
    s = max_partition_load / mean_partition_load over p destinations
    (``partition_hist`` of the would-be shuffle destinations).

    Values below ``floor`` are statistical fluctuation of uniform hashing
    and snap to 1.0, so skew-aware selection on uniform data reproduces the
    paper's Algorithm 1 decisions exactly.
    """
    p = p or table.num_partitions
    counts = _flat_hist(_dest_partition(table.column(key), p), table.valid,
                        p)
    with obs.sync("skew"):
        total = int(counts.sum())
    if total == 0:
        return 1.0
    with obs.sync("skew"):
        s = float(counts.max()) * p / total
    return s if s >= floor else 1.0
