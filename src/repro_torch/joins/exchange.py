"""Data-exchange phase: broadcast and shuffle (paper §2.1.1).

Global-view implementations on stacked ``(p, cap)`` tables: the all-to-all
is an axis transpose and the replication a concatenation of partitions.

Every exchange returns an ``ExchangeReport`` whose byte counts are *measured*
(from live rows), so benchmarks can compare the paper's modeled workloads
(Eqs. 1, 5) against ground truth. ``straggler_bytes`` — the load of the
hottest destination partition, counted with the ``partition_hist`` kernel —
is the skew signal: under Zipf keys it, not the mean, bounds wall-clock.

The salted shuffle, hot-bucket detection, ``key_skew`` and the hypercube
exchange come with the skew and hypercube slices of the port.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.partition_hist import partition_hist
from .slots import (SHUFFLE_SEED, gather_rows, hash32, pair_capacity,
                    slot_scatter)
from .table import Table, concat_partitions


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
    p = table.num_partitions
    scat = slot_scatter(dest, table.valid, p, pair_cap)  # (p_src, p_dst, pc)

    send_cols, send_valid = gather_rows(table.columns, scat.idx)
    # all_to_all == axis transpose in the global view.
    recv_cols = {n: c.transpose(0, 1).reshape(p, p * pair_cap)
                 for n, c in send_cols.items()}
    recv_valid = send_valid.transpose(0, 1).reshape(p, p * pair_cap)
    out = Table(recv_cols, recv_valid, partitioned_by=partitioned_by)

    # Measured workload: rows that actually crossed partitions, plus the
    # per-destination load histogram for straggler accounting.
    src_ids = torch.arange(p, dtype=torch.int32, device=dest.device)[:, None]
    moved = (table.valid & (dest != src_ids)).sum()
    stayed = (table.valid & (dest == src_ids)).sum()
    loads = partition_hist(
        torch.where(table.valid, dest, -1).reshape(-1), nd=p)
    rb = table.row_bytes
    report = ExchangeReport(
        kind,
        network_bytes=float(moved) * rb,
        local_bytes=float(stayed) * rb,
        overflow_rows=int(scat.overflow.sum()),
        straggler_bytes=float(loads.max()) * rb,
    )
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
