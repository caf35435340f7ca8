"""Group-by aggregation — the other exchange-bounded operation (paper §1:
"every join or group-by-like operation" updates runtime statistics).

Distributed plan: shuffle rows by group key (same exchange as the shuffle
joins), then aggregate each co-partition locally: sort by key, mark segment
heads, segment-reduce with scatter. Fixed shapes throughout; output rows are
the segment heads (cardinality = #groups, the runtime statistic of the
stage). Float sums on a CUDA tensor are atomic, so their order, and their
last bits, vary from run to run.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .. import obs
from .exchange import ExchangeReport, shuffle
from .table import Table

AGG_OPS = ("sum", "count", "min", "max", "mean")
INT32_MAX = torch.iinfo(torch.int32).max


def _fill(v: torch.Tensor, lowest: bool) -> float | int:
    """The identity of max (``lowest``) or min for ``v``'s dtype."""
    if v.dtype.is_floating_point:
        return -float("inf") if lowest else float("inf")
    info = torch.iinfo(v.dtype)
    return info.min if lowest else info.max


def _local_group_agg(key: torch.Tensor, valid: torch.Tensor,
                     cols: Dict[str, torch.Tensor],
                     aggs: Sequence[Tuple[str, str]]):
    """Aggregate every partition by key, all ``(P, n)``. Returns
    (out_cols, out_valid)."""
    k = torch.where(valid, key, INT32_MAX).to(torch.int32)
    order = torch.argsort(k, dim=1, stable=True)
    ks = torch.gather(k, 1, order)
    head = torch.ones_like(ks, dtype=torch.bool)
    head[:, 1:] = ks[:, 1:] != ks[:, :-1]
    seg = torch.cumsum(head, dim=1) - 1                # group id per row
    out_valid = head & (ks != INT32_MAX)

    out_cols = {"_group_key": torch.where(out_valid, ks, 0)}
    live = ks != INT32_MAX
    for col, op in aggs:
        v = torch.gather(cols[col], 1, order)
        if op == "count":
            data = live.to(torch.int32)
            seg_out = torch.zeros_like(data).scatter_add_(1, seg, data)
        elif op in ("sum", "mean"):
            data = torch.where(live, v, 0)
            seg_out = torch.zeros_like(data).scatter_add_(1, seg, data)
            if op == "mean":
                ones = live.to(v.dtype)
                cnt = torch.zeros_like(ones).scatter_add_(1, seg, ones)
                seg_out = seg_out / cnt.clamp(min=1)
        elif op in ("min", "max"):
            data = torch.where(live, v, _fill(v, lowest=op == "max"))
            seg_out = torch.full_like(data, _fill(v, lowest=op == "max"))
            seg_out.scatter_reduce_(1, seg, data, "a" + op,
                                    include_self=False)
        else:
            raise ValueError(f"unknown agg op {op}")
        # Each row reads its group's aggregate; only head rows stay valid.
        out_cols[f"{op}_{col}"] = torch.gather(seg_out, 1, seg)
    return out_cols, out_valid


def group_aggregate(table: Table, key: str,
                    aggs: Sequence[Tuple[str, str]],
                    capacity_factor: float = 2.0
                    ) -> tuple[Table, ExchangeReport]:
    """Distributed group-by: shuffle by key + local segment aggregation."""
    if not table.stacked:
        raise ValueError("group_aggregate expects a stacked table")
    with obs.span(obs.AGGREGATE):
        shuffled, report = shuffle(table, key, capacity_factor)
        out_cols, out_valid = _local_group_agg(
            shuffled.column(key), shuffled.valid, shuffled.columns,
            tuple(aggs))
        out_cols[key] = out_cols.pop("_group_key")
        # Output is hash-partitioned by the group key: downstream shuffles
        # on the same key are elided (§3.7 key-dependency).
        return Table(out_cols, out_valid, partitioned_by=key), report


def global_aggregate(table: Table, aggs: Sequence[Tuple[str, str]]
                     ) -> Dict[str, float]:
    """Whole-table scalar aggregates (query result tails)."""
    out = {}
    v = table.valid
    for col, op in aggs:
        c = table.column(col)
        if op == "count":
            out[f"count_{col}"] = float(v.sum())
        elif op == "sum":
            out[f"sum_{col}"] = float(torch.where(v, c, 0).sum())
        elif op == "mean":
            s = float(torch.where(v, c, 0).sum())
            n = float(v.sum())
            out[f"mean_{col}"] = s / max(n, 1.0)
        elif op == "min":
            out[f"min_{col}"] = float(torch.where(v, c, float("inf")).min())
        elif op == "max":
            out[f"max_{col}"] = float(torch.where(v, c, -float("inf")).max())
    return out
