"""Performance Sensitivity To Selections (PSTS) — paper §5.4, Table 5 —
plus the distinct-key machinery the exact semi-join reducer builds on.

PSTS = %TimeDiff / %JoinDiff with a baseline strategy (AQE in the paper):

    %JoinDiff = (# joins where the strategy and the baseline select different
                 methods) / (total # joins) * 100
    %TimeDiff = (baseline total time - strategy total time)
                / baseline total time * 100

``key_set`` folds a (possibly duplicated, partially invalid) key column into
a sorted membership structure, ``distinct_count`` sizes it, and
``semi_join_mask`` is the exact probe — the zero-false-positive reducer the
runtime-filter planner weighs against bloom filters and zone maps. No TPU
kernel sits behind them: they are ``torch.sort`` and ``torch.searchsorted``.
``key_set`` is a pure function of the key *set* (order- and
duplication-invariant), so a filter built from it does not depend on where
the rows lie.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .cost_model import JoinMethod

#: Sentinel that pads the sorted key set to its fixed capacity. INT32_MAX
#: sorts to the tail; a real key equal to it would look like padding, so
#: ``key_set`` tracks the live count and ``semi_join_mask`` consults only
#: the live prefix.
KEY_SET_SENTINEL = 2 ** 31 - 1


def key_set(keys: torch.Tensor, valid: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted distinct-key membership structure of the valid entries.

    Returns ``(sorted_keys, n_distinct)``: an int32 tensor of the input's
    flattened shape — distinct live keys sorted ascending, then sentinel
    padding — and the count of distinct live keys as a 0-d int64 tensor on
    the keys' device (no host sync)."""
    flat = keys.reshape(-1).to(torch.int32)
    v = (torch.ones(flat.shape, dtype=torch.bool, device=flat.device)
         if valid is None else valid.reshape(-1).to(torch.bool))
    if flat.shape[0] == 0:
        return flat, torch.zeros((), dtype=torch.int64, device=flat.device)
    # Invalid rows sort to the tail as sentinels; duplicate live keys are
    # then sentinel-ed too (first occurrence wins) and re-sorted away.
    # Positions < n_valid hold exactly the sorted live keys, so masking the
    # duplicate test to that prefix keeps a live key equal to the sentinel.
    s = torch.sort(torch.where(v, flat, KEY_SET_SENTINEL)).values
    n_valid = v.sum()
    live = torch.arange(s.shape[0], device=s.device) < n_valid
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=s.device),
                     s[1:] == s[:-1]]) & live
    distinct = torch.sort(torch.where(dup, KEY_SET_SENTINEL, s)).values
    return distinct, n_valid - dup.sum()


def distinct_count(keys: torch.Tensor, valid: torch.Tensor | None = None
                   ) -> int:
    """Number of distinct valid keys (host sync)."""
    _, n = key_set(keys, valid)
    return int(n)


def semi_join_mask(probe_keys: torch.Tensor, sorted_keys: torch.Tensor,
                   n: torch.Tensor | int | None = None) -> torch.Tensor:
    """Exact membership mask of ``probe_keys`` against a ``key_set``: a
    binary search per probe key, no false positives or negatives. ``n``
    bounds the live prefix; keys landing in the sentinel padding are
    rejected. Same shape as ``probe_keys``."""
    flat = probe_keys.reshape(-1).to(torch.int32)
    if sorted_keys.shape[0] == 0:
        return torch.zeros(probe_keys.shape, dtype=torch.bool,
                           device=probe_keys.device)
    idx = torch.searchsorted(sorted_keys, flat)
    idx = idx.clamp(0, sorted_keys.shape[0] - 1)
    found = sorted_keys[idx]
    hit = found == flat
    if n is not None:
        hit = hit & (idx < n)
    else:
        hit = hit & (found != KEY_SET_SENTINEL)
    return hit.reshape(probe_keys.shape)


def _is_shuffle(m: JoinMethod) -> bool:
    # Paper §5.4 treats shuffle sort and shuffle hash as the same method when
    # counting selection differences (their performance is near-identical).
    return m in (JoinMethod.SHUFFLE_SORT, JoinMethod.SHUFFLE_HASH,
                 JoinMethod.SALTED_SHUFFLE_HASH, JoinMethod.CARTESIAN)


def selections_differ(m1: JoinMethod, m2: JoinMethod) -> bool:
    """Broadcast-vs-shuffle is the difference that matters (paper §5.4)."""
    return _is_shuffle(m1) != _is_shuffle(m2)


@dataclasses.dataclass(frozen=True)
class PSTSReport:
    n_join_diff: int
    n_joins: int
    cost_diff: float
    time_diff: float
    pct_join_diff: float
    pct_time_diff: float
    psts: float

    def cost_diff_per_join(self) -> float:
        return self.cost_diff / self.n_join_diff if self.n_join_diff else 0.0

    def time_diff_per_join(self) -> float:
        return self.time_diff / self.n_join_diff if self.n_join_diff else 0.0


def compute_psts(strategy_methods: Sequence[JoinMethod],
                 baseline_methods: Sequence[JoinMethod],
                 strategy_time: float, baseline_time: float,
                 strategy_costs: Sequence[float] = (),
                 baseline_costs: Sequence[float] = ()) -> PSTSReport:
    """Compute the Table-5 statistics for one benchmark run."""
    if len(strategy_methods) != len(baseline_methods):
        raise ValueError("selection sequences must align join-for-join")
    n = len(strategy_methods)
    diffs = [i for i in range(n)
             if selections_differ(strategy_methods[i], baseline_methods[i])]
    cost_diff = 0.0
    if strategy_costs and baseline_costs:
        cost_diff = sum(baseline_costs[i] - strategy_costs[i] for i in diffs)
    time_diff = baseline_time - strategy_time
    pct_join = 100.0 * len(diffs) / n if n else 0.0
    pct_time = 100.0 * time_diff / baseline_time if baseline_time else 0.0
    psts = pct_time / pct_join if pct_join else 0.0
    return PSTSReport(len(diffs), n, cost_diff, time_diff, pct_join, pct_time,
                      psts)
