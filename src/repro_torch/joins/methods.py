"""The distributed equi-join methods (paper §2.1, §3) — global-view
executables on stacked tables.

Each method = exchange phase + local join phase, mirroring the cost model's
decomposition. All methods produce the same logical result for FK->PK
equi-joins: the probe table's rows (original partition layout) extended with
the matched build-side payload columns, and a per-method JoinReport with
*measured* phase workloads for cost-model validation.

Join types: inner, left_outer, left_semi, left_anti (probe side preserved;
the engine puts the larger table on the probe side as §3.1.4 prescribes).

The nested-loop and cartesian methods, the salted shuffle hash join and the
hypercube multi-way join come with later slices of the port.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.cost_model import JoinMethod
from .exchange import broadcast, shuffle
from .local_join import LocalJoinResult, hash_join, sort_join
from .slots import gather_rows
from .table import Table


@dataclasses.dataclass
class JoinReport:
    method: JoinMethod
    exchanges: list          # ExchangeReport per exchanged input
    local_bytes: float       # measured local-join phase workload (bytes)
    output_rows: int


def _merge_payload(a: Table, b_cols: dict, idx: torch.Tensor,
                   found: torch.Tensor, join_type: str, b_key: str) -> Table:
    """Attach matched B payload to the probe table A, all partitions at
    once. ``b_cols`` are ``(P, nb)`` per partition or ``(nb,)`` replicas."""
    cols = dict(a.columns)
    if join_type == "left_semi":
        return Table(cols, a.valid & found)
    if join_type == "left_anti":
        return Table(cols, a.valid & ~found)
    gathered, _ = gather_rows(b_cols, idx)
    for name, col in gathered.items():
        out_name = name if name not in cols else f"{name}_r"
        if join_type == "left_outer":
            col = torch.where(found, col, torch.zeros_like(col))
        cols[out_name] = col
    if join_type == "inner":
        valid = a.valid & found
    elif join_type == "left_outer":
        valid = a.valid
        cols[f"{b_key}_matched"] = found
    else:
        raise ValueError(f"unsupported join type {join_type}")
    return Table(cols, valid)


def _finish(a: Table, b_cols: dict, res: LocalJoinResult, join_type: str,
            b_key: str) -> Table:
    return _merge_payload(a, b_cols, res.match_idx, res.found, join_type,
                          b_key)


def _local_bytes(a: Table, b_rows: int, b_row_bytes: int, p: int,
                 build_replicated: bool) -> float:
    """Measured compute workload: build (p|B| or |B|) + probe (|A| + |B|)."""
    a_bytes = a.count() * a.row_bytes
    b_bytes = b_rows * b_row_bytes
    build = (p if build_replicated else 1) * b_bytes
    return float(build + a_bytes + b_bytes)


# ---------------------------------------------------------------------------


def broadcast_hash_join(a: Table, b: Table, a_key: str, b_key: str,
                        join_type: str = "inner",
                        use_kernel: bool = False) -> tuple[Table, JoinReport]:
    """Broadcast B to every partition; radix-hash probe A's partitions."""
    p = a.num_partitions
    b_full, ex = broadcast(b)
    res = hash_join(a.column(a_key), a.valid, b_full.column(b_key),
                    b_full.valid, use_kernel=use_kernel)
    out = _finish(a, b_full.columns, res, join_type, b_key)
    out.partitioned_by = a.partitioned_by
    rep = JoinReport(JoinMethod.BROADCAST_HASH, [ex],
                     _local_bytes(a, b_full.count(), b_full.row_bytes, p,
                                  build_replicated=True),
                     out.count())
    return out, rep


def shuffle_hash_join(a: Table, b: Table, a_key: str, b_key: str,
                      join_type: str = "inner",
                      capacity_factor: float = 2.0,
                      use_kernel: bool = False) -> tuple[Table, JoinReport]:
    """Shuffle both sides by key; radix-hash join each co-partition."""
    p = a.num_partitions
    a_sh, ex_a = shuffle(a, a_key, capacity_factor)
    b_sh, ex_b = shuffle(b, b_key, capacity_factor)
    res = hash_join(a_sh.column(a_key), a_sh.valid, b_sh.column(b_key),
                    b_sh.valid, use_kernel=use_kernel)
    out = _finish(a_sh, b_sh.columns, res, join_type, b_key)
    out.partitioned_by = a_key
    rep = JoinReport(JoinMethod.SHUFFLE_HASH, [ex_a, ex_b],
                     _local_bytes(a_sh, b_sh.count(), b_sh.row_bytes, p,
                                  build_replicated=False),
                     out.count())
    return out, rep


def shuffle_sort_join(a: Table, b: Table, a_key: str, b_key: str,
                      join_type: str = "inner",
                      capacity_factor: float = 2.0,
                      use_kernel: bool = False) -> tuple[Table, JoinReport]:
    """Shuffle both sides by key; sort-merge join each co-partition."""
    a_sh, ex_a = shuffle(a, a_key, capacity_factor)
    b_sh, ex_b = shuffle(b, b_key, capacity_factor)
    res = sort_join(a_sh.column(a_key), a_sh.valid, b_sh.column(b_key),
                    b_sh.valid, use_kernel_sort=use_kernel)
    out = _finish(a_sh, b_sh.columns, res, join_type, b_key)
    out.partitioned_by = a_key
    # Sort join's measured compute adds the n log n sort passes; we report
    # the touched bytes (sort reads+writes both sides ~log passes).
    a_rows, b_rows = a_sh.count(), b_sh.count()
    pa = max(a_rows / a_sh.num_partitions, 1.0)
    pb = max(b_rows / b_sh.num_partitions, 1.0)
    sort_bytes = (a_rows * a_sh.row_bytes * math.log2(max(pa, 1.0) + 1)
                  + b_rows * b_sh.row_bytes * math.log2(max(pb, 1.0) + 1))
    merge_bytes = a_rows * a_sh.row_bytes + b_rows * b_sh.row_bytes
    rep = JoinReport(JoinMethod.SHUFFLE_SORT, [ex_a, ex_b],
                     float(sort_bytes + merge_bytes), out.count())
    return out, rep


# ---------------------------------------------------------------------------


def run_equi_join(method: JoinMethod, a: Table, b: Table, a_key: str,
                  b_key: str, join_type: str = "inner",
                  use_kernel: bool = False,
                  capacity_factor: float = 2.0,
                  salt_r: int = 2) -> tuple[Table, JoinReport]:
    """Dispatch an equi-join to the selected physical method."""
    if method is JoinMethod.BROADCAST_HASH:
        return broadcast_hash_join(a, b, a_key, b_key, join_type, use_kernel)
    if method is JoinMethod.SHUFFLE_HASH:
        return shuffle_hash_join(a, b, a_key, b_key, join_type,
                                 capacity_factor, use_kernel)
    if method is JoinMethod.SHUFFLE_SORT:
        return shuffle_sort_join(a, b, a_key, b_key, join_type,
                                 capacity_factor, use_kernel)
    if method in (JoinMethod.BROADCAST_NL, JoinMethod.CARTESIAN):
        raise NotImplementedError(f"{method.value} comes with the "
                                  "nested-loop slice of the port")
    if method is JoinMethod.SALTED_SHUFFLE_HASH:
        raise NotImplementedError(f"{method.value} (salt_r={salt_r}) comes "
                                  "with the skew slice of the port")
    raise ValueError(f"unknown method {method}")
