"""Columnar tables on torch tensors with fixed capacities + validity masks.

A Table has a fixed row *capacity*; the live rows are marked in ``valid``.
A *stacked* table carries a leading partition axis ``(p, cap)`` — the
engine's unit of distribution; an *unstacked* table ``(cap,)`` is a single
partition (or a broadcast replica). Every operator runs on the device its
tensors live on.

The measured (size, cardinality) of the valid rows IS the paper's adaptive
runtime statistic; ``measure()`` produces it after every exchange.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .. import obs
from ..core.stats import StatsSource, TableStats


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds its tensors on: the CUDA card unless
    the caller names another device. Without a card and without an explicit
    device this raises — nothing moves to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass
class Table:
    """Columnar table: dict of same-shape tensors + validity mask.

    ``partitioned_by`` records the hash-partitioning key when the table was
    produced by a shuffle on that key (Spark's output-partitioning property):
    a subsequent shuffle on the same key is elided (§3.7's key-dependency
    case where C_shuffle = 0).
    """

    columns: Dict[str, torch.Tensor]
    valid: torch.Tensor  # bool, shape == each column's shape
    partitioned_by: str | None = None

    # -- structure ----------------------------------------------------------

    @property
    def stacked(self) -> bool:
        return self.valid.dim() == 2

    @property
    def num_partitions(self) -> int:
        return self.valid.shape[0] if self.stacked else 1

    @property
    def capacity(self) -> int:
        return self.valid.shape[-1]

    @property
    def row_bytes(self) -> int:
        return int(sum(c.element_size() for c in self.columns.values()))

    def column(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def with_valid(self, valid: torch.Tensor) -> "Table":
        return Table(self.columns, valid, self.partitioned_by)

    def select(self, names) -> "Table":
        part = self.partitioned_by if self.partitioned_by in names else None
        return Table({n: self.columns[n] for n in names}, self.valid, part)

    # -- statistics ----------------------------------------------------------

    def count(self) -> int:
        """Number of valid rows (host sync)."""
        with obs.sync("count"):
            return int(self.valid.sum())

    def measure(self) -> TableStats:
        """Adaptive runtime statistic of this materialized dataset."""
        rows = self.count()
        return TableStats(rows * self.row_bytes, rows, StatsSource.RUNTIME)

    # -- conversion ----------------------------------------------------------

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Compacted valid rows as numpy (host-side; for tests/oracles)."""
        v = self.valid.reshape(-1).cpu().numpy()
        return {n: c.reshape(-1).cpu().numpy()[v]
                for n, c in self.columns.items()}


def from_numpy(columns: Dict[str, np.ndarray], capacity: int | None = None,
               *, device=None) -> Table:
    """Build an unstacked table on ``device``; pads to ``capacity`` with
    invalid rows. int64 columns become int32 and float64 become float32."""
    device = resolve_device(device)
    n = len(next(iter(columns.values())))
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < rows {n}")
    cols, pad = {}, cap - n
    for name, arr in columns.items():
        a = np.asarray(arr)
        if a.dtype == np.int64:
            a = a.astype(np.int32)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        cols[name] = torch.from_numpy(np.pad(a, (0, pad))).to(device)
    valid = torch.from_numpy(np.arange(cap) < n).to(device)
    return Table(cols, valid)


def partition_round_robin(table: Table, p: int) -> Table:
    """Split an unstacked table into p partitions (initial data placement,
    like HDFS blocks landing on executors): contiguous blocks of
    ceil(cap / p) rows, the last one padded with invalid rows."""
    if table.stacked:
        raise ValueError("already stacked")
    cap = table.capacity
    per = -(-cap // p)
    pad = per * p - cap
    cols = {n: _pad_zeros(c, pad).reshape(p, per)
            for n, c in table.columns.items()}
    valid = _pad_zeros(table.valid, pad).reshape(p, per)
    return Table(cols, valid)


def _pad_zeros(c: torch.Tensor, pad: int) -> torch.Tensor:
    """Append ``pad`` zeros (False for bool) to a 1-D tensor."""
    return torch.cat([c, c.new_zeros(pad)])


def compact_partitions(table: Table, capacity: int | None = None,
                       slack: float = 1.1) -> Table:
    """Pack valid rows to the front of each partition and shrink capacity.

    Keeps post-join tables from growing unboundedly across a join chain
    (Spark analog: AQE's post-stage partition coalescing). Host-syncs the
    max per-partition live count, like any stage materialization. The
    capacity is rounded up to a power of two, so downstream stages see a
    small set of distinct shapes; the stable sort keeps live rows in their
    original order.
    """
    if not table.stacked:
        raise ValueError("compact expects a stacked table")
    with obs.span(obs.COMPACT):
        with obs.sync("compact"):
            need = int(table.valid.sum(dim=1).max())
        cap = capacity or max(
            8, 1 << (max(int(need * slack), 1) - 1).bit_length())
        cap = min(cap, table.capacity)

        invalid = (~table.valid).to(torch.uint8)
        order = torch.argsort(invalid, dim=1, stable=True)[:, :cap]
        cols = {n: torch.gather(c, 1, order)
                for n, c in table.columns.items()}
        valid = torch.gather(table.valid, 1, order)
        return Table(cols, valid, table.partitioned_by)


def concat_partitions(table: Table) -> Table:
    """Flatten a stacked table into a single logical partition view."""
    if not table.stacked:
        return table
    cols = {n: c.reshape(-1) for n, c in table.columns.items()}
    return Table(cols, table.valid.reshape(-1))
