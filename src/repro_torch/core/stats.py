"""Dataset statistics used by the RelJoin cost model (paper §2.3).

The cost model needs exactly two statistics per dataset: *size* in bytes and
*cardinality* in rows (paper §4.1 Step 1: "the required statistics are the
size and cardinality of the output dataset"). Statistics are either

  * ``ESTIMATED`` — statically analyzed along the logical plan, or
  * ``RUNTIME``   — measured at a data-exchange boundary (adaptive runtime
    statistics, §2.3/§4.1), which supersede estimates.

A *watermark* (default 100 GB, §4.4) caps the size a statistic may take while
still being considered valid; lazily-initialized "very large number" defaults
from sources without stats are thereby rejected and the optimizer falls back
to the platform's original absolute-size strategy for that join.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Dict, Iterable, Sequence, Tuple

#: Paper §4.4: default watermark = 100 GB.
DEFAULT_WATERMARK_BYTES: float = 100 * 1024 ** 3

#: Spark initializes unknown sizes to a huge default (Long.MaxValue-ish).
UNKNOWN_SIZE: float = float(2 ** 63 - 1)


class StatsSource(enum.Enum):
    ESTIMATED = "estimated"
    RUNTIME = "runtime"


@dataclasses.dataclass(frozen=True)
class TableStats:
    """(size, cardinality) of one dataset plus provenance.

    ``skew`` is the *join-key partition skew factor* s =
    max_partition_load / mean_partition_load of the dataset's join key
    hashed across p shuffle partitions (s >= 1; 1.0 = uniform). It is a
    runtime statistic measured at exchange boundaries (per-partition load
    histograms); statically derived estimates always carry the uniform
    default — only measurement can establish skew.
    """

    size_bytes: float
    cardinality: float
    source: StatsSource = StatsSource.ESTIMATED
    skew: float = 1.0

    @property
    def row_bytes(self) -> float:
        """|A|/a — average row size (paper Table 1)."""
        if self.cardinality <= 0:
            return 0.0
        return self.size_bytes / self.cardinality

    def is_valid(self, watermark_bytes: float = DEFAULT_WATERMARK_BYTES) -> bool:
        """Paper §4.4: only sizes below the watermark are valid statistics."""
        return (
            math.isfinite(self.size_bytes)
            and 0 <= self.size_bytes <= watermark_bytes
            and math.isfinite(self.cardinality)
            and self.cardinality >= 0
        )

    def as_runtime(self) -> "TableStats":
        return dataclasses.replace(self, source=StatsSource.RUNTIME)

    def with_skew(self, skew: float) -> "TableStats":
        """Attach a measured join-key skew factor (clamped to >= 1)."""
        return dataclasses.replace(self, skew=max(float(skew), 1.0))

    def scaled(self, selectivity: float) -> "TableStats":
        """Estimate stats after a filter with the given selectivity.

        Derived statistics are always ESTIMATED, even when the input was
        runtime-measured: only exchange boundaries produce RUNTIME stats.
        """
        sel = min(max(selectivity, 0.0), 1.0)
        return TableStats(self.size_bytes * sel, self.cardinality * sel,
                          StatsSource.ESTIMATED)


def unknown_stats() -> TableStats:
    """Stats for a lazily-loaded source without header statistics (§4.4)."""
    return TableStats(UNKNOWN_SIZE, UNKNOWN_SIZE, StatsSource.ESTIMATED)


# ---------------------------------------------------------------------------
# Static estimation rules for plan operators (standard CBO rules; §2.3).
# ---------------------------------------------------------------------------

def estimate_filter(inp: TableStats, selectivity: float) -> TableStats:
    return inp.scaled(selectivity)


def estimate_project(inp: TableStats, kept_byte_fraction: float) -> TableStats:
    frac = min(max(kept_byte_fraction, 0.0), 1.0)
    return TableStats(inp.size_bytes * frac, inp.cardinality,
                      StatsSource.ESTIMATED)


def estimate_join(left: TableStats, right: TableStats,
                  fk_to_pk: bool = True,
                  distinct_keys: float | None = None,
                  fk_selectivity: float = 1.0) -> TableStats:
    """Output stats of an equi-join.

    For FK->PK joins (the TPC-DS star-schema case) output cardinality is the
    probe-side cardinality scaled by ``fk_selectivity`` — the fraction of the
    build side's key domain that survived its filters (key-uniformity
    assumption; 1.0 for unfiltered dimensions). Otherwise the textbook
    a*b/max(distinct) rule. Output row size is the sum of both row sizes
    (all columns kept).
    """
    if fk_to_pk:
        card = left.cardinality * min(max(fk_selectivity, 0.0), 1.0)
    else:
        d = distinct_keys or max(left.cardinality, right.cardinality, 1.0)
        card = left.cardinality * right.cardinality / max(d, 1.0)
    row = left.row_bytes + right.row_bytes
    return TableStats(card * row, card, StatsSource.ESTIMATED)


def estimate_group_by(inp: TableStats, groups: float) -> TableStats:
    card = min(inp.cardinality, max(groups, 1.0))
    return TableStats(card * inp.row_bytes, card, StatsSource.ESTIMATED)


# ---------------------------------------------------------------------------
# Per-column statistics: NDV / MCV / equi-depth histograms.
#
# The mergeable intermediate is an exact compressed multiset (sorted
# (value, count) pairs) — per-partition summaries merge by adding counts,
# so distributed builds are order-, duplicate- and partitioning-invariant
# by construction, and merge(split(summary, p)) == summary at any p. The
# finalized ``ColumnStats`` keeps the heaviest values exactly (MCV) and
# equi-depth buckets over the remainder.
# ---------------------------------------------------------------------------

#: Most-common values kept exactly per column (counts, not estimates).
MCV_TOP_K: int = 8

#: Equi-depth buckets over the non-MCV remainder of a column.
HISTOGRAM_BUCKETS: int = 16


def q_error(estimated: float, measured: float) -> float:
    """The symmetric multiplicative estimation error max(e/m, m/e).

    Both sides are floored at one row so empty relations (and estimates
    rounding to zero) yield finite, comparable errors: q_error(0, 0) == 1.
    """
    e = max(float(estimated), 1.0)
    m = max(float(measured), 1.0)
    return max(e / m, m / e)


@dataclasses.dataclass(frozen=True)
class ColumnSummary:
    """Exact compressed multiset of one column: sorted (value, count) pairs.

    The order- and partitioning-invariant intermediate behind
    ``ColumnStats``: build each partition's summary independently, merge by
    adding counts. Values are stored as floats (the engine's columns are
    int32/float32 — both embed exactly).
    """

    values: Tuple[float, ...]
    counts: Tuple[float, ...]

    @property
    def total(self) -> float:
        return float(sum(self.counts))

    @property
    def ndv(self) -> float:
        return float(len(self.values))


def summary_from_pairs(values: Iterable[float],
                       counts: Iterable[float]) -> ColumnSummary:
    """Normalize (value, count) pairs into a ``ColumnSummary``: duplicate
    values merge by adding counts, zero/negative counts drop, pairs sort by
    value — so any pair order or duplication yields the identical summary."""
    acc: Dict[float, float] = {}
    for v, c in zip(values, counts):
        if c > 0:
            fv = float(v)
            acc[fv] = acc.get(fv, 0.0) + float(c)
    ordered = sorted(acc.items())
    return ColumnSummary(tuple(v for v, _ in ordered),
                         tuple(c for _, c in ordered))


def build_summary(values: Iterable[float]) -> ColumnSummary:
    """Summarize a raw value sequence (one partition's column)."""
    counts: Dict[float, float] = {}
    for v in values:
        fv = float(v)
        counts[fv] = counts.get(fv, 0.0) + 1.0
    ordered = sorted(counts.items())
    return ColumnSummary(tuple(v for v, _ in ordered),
                         tuple(c for _, c in ordered))


def merge_summaries(parts: Sequence[ColumnSummary]) -> ColumnSummary:
    """Exact multiset union of per-partition summaries (any order)."""
    return summary_from_pairs(
        [v for s in parts for v in s.values],
        [c for s in parts for c in s.counts])


def filter_summary(summary: ColumnSummary, op: str, value: float = 0.0,
                   value2: float = 0.0,
                   values: Sequence[float] = ()) -> ColumnSummary:
    """The exact multiset surviving one predicate, engine semantics:
    ``between`` inclusive on both ends, ``in`` an OR of equalities."""
    keep = _predicate(op, value, value2, values)
    pairs = [(v, c) for v, c in zip(summary.values, summary.counts)
             if keep(v)]
    return ColumnSummary(tuple(v for v, _ in pairs),
                         tuple(c for _, c in pairs))


def _predicate(op: str, value: float, value2: float,
               values: Sequence[float]) -> Callable[[float], bool]:
    members = {float(v) for v in values}
    table = {
        "eq": lambda v: v == value,
        "ne": lambda v: v != value,
        "lt": lambda v: v < value,
        "le": lambda v: v <= value,
        "gt": lambda v: v > value,
        "ge": lambda v: v >= value,
        "between": lambda v: value <= v <= value2,
        "in": lambda v: v in members,
    }
    if op not in table:
        raise ValueError(f"unknown filter op {op}")
    return table[op]


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """Finalized per-column statistics: row count, NDV, the top-K most
    common values with exact counts, and equi-depth buckets
    ``(lo, hi, rows, ndv)`` — bounds inclusive — over the remainder.
    ``integral`` marks integer-valued columns (point predicates on
    non-integers estimate zero)."""

    count: float
    ndv: float
    mcv: Tuple[Tuple[float, float], ...]
    buckets: Tuple[Tuple[float, float, float, float], ...]
    integral: bool = True

    def fraction(self, op: str, value: float = 0.0, value2: float = 0.0,
                 values: Sequence[float] = ()) -> float:
        """Estimated kept fraction of one predicate; 0.0 on empty input."""
        if self.count <= 0:
            return 0.0
        n = self.count
        if op == "eq":
            return _clamp01(self._eq_rows(value) / n)
        if op == "ne":
            return _clamp01(1.0 - self._eq_rows(value) / n)
        if op == "lt":
            return _clamp01(self._lt_rows(value) / n)
        if op == "le":
            return _clamp01(self._le_rows(value) / n)
        if op == "gt":
            return _clamp01(1.0 - self._le_rows(value) / n)
        if op == "ge":
            return _clamp01(1.0 - self._lt_rows(value) / n)
        if op == "between":
            return _clamp01(
                (self._le_rows(value2) - self._lt_rows(value)) / n)
        if op == "in":
            return _clamp01(
                sum(self._eq_rows(v) for v in {float(v) for v in values})
                / n)
        raise ValueError(f"unknown filter op {op}")

    def _eq_rows(self, value: float) -> float:
        v = float(value)
        for mv, mc in self.mcv:
            if mv == v:
                return mc
        if self.integral and not v.is_integer():
            return 0.0
        for lo, hi, rows, ndv in self.buckets:
            if lo <= v <= hi:
                return rows / max(ndv, 1.0)
        return 0.0

    def _le_rows(self, value: float) -> float:
        """Rows with column value <= ``value`` (MCV exact + bucket
        interpolation: discrete-uniform within integral buckets, linear
        within float buckets)."""
        v = float(value)
        rows = sum(mc for mv, mc in self.mcv if mv <= v)
        for lo, hi, cnt, _ in self.buckets:
            if v >= hi:
                rows += cnt
            elif v >= lo:
                if self.integral:
                    width = hi - lo + 1.0
                    rows += cnt * (math.floor(v) - lo + 1.0) / width
                else:
                    rows += cnt * (v - lo) / max(hi - lo, 1e-30)
        return rows

    def _lt_rows(self, value: float) -> float:
        v = float(value)
        rows = sum(mc for mv, mc in self.mcv if mv < v)
        for lo, hi, cnt, _ in self.buckets:
            if v > hi:
                rows += cnt
            elif v > lo:
                if self.integral:
                    width = hi - lo + 1.0
                    rows += cnt * (math.ceil(v) - lo) / width
                else:
                    rows += cnt * (v - lo) / max(hi - lo, 1e-30)
        return rows


def _clamp01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


def column_stats_from_summary(summary: ColumnSummary,
                              integral: bool = True,
                              mcv_k: int = MCV_TOP_K,
                              n_buckets: int = HISTOGRAM_BUCKETS
                              ) -> ColumnStats:
    """Finalize a summary: peel off the top ``mcv_k`` values by count
    (ties broken by value — deterministic under any build order), then cut
    the remainder into at most ``n_buckets`` equi-depth buckets."""
    n = summary.total
    if n <= 0:
        return ColumnStats(0.0, 0.0, (), (), integral)
    pairs = list(zip(summary.values, summary.counts))
    by_weight = sorted(pairs, key=lambda vc: (-vc[1], vc[0]))
    mcv = tuple(by_weight[:mcv_k])
    mcv_values = {v for v, _ in mcv}
    rest = [(v, c) for v, c in pairs if v not in mcv_values]
    buckets: list[Tuple[float, float, float, float]] = []
    if rest:
        rem = sum(c for _, c in rest)
        # Close a bucket once it holds one equi-depth share; depth balances
        # to within one value's count, deterministically (rest is sorted).
        target = rem / max(n_buckets, 1)
        lo = rest[0][0]
        rows = 0.0
        ndv = 0.0
        for i, (v, c) in enumerate(rest):
            rows += c
            ndv += 1.0
            if rows >= target or i == len(rest) - 1:
                buckets.append((lo, v, rows, ndv))
                rows = 0.0
                ndv = 0.0
                if i + 1 < len(rest):
                    lo = rest[i + 1][0]
    return ColumnStats(n, summary.ndv, mcv, tuple(buckets), integral)


def split_summary(summary: ColumnSummary, p: int) -> Tuple[ColumnSummary, ...]:
    """Round-robin the expanded multiset across ``p`` parts — the test
    helper for the merge(split(h)) ≡ h invariant (not a data path)."""
    parts: Tuple[Dict[float, float], ...] = tuple({} for _ in range(p))
    i = 0
    for v, c in zip(summary.values, summary.counts):
        whole = int(c)
        for _ in range(whole):
            part = parts[i % p]
            part[v] = part.get(v, 0.0) + 1.0
            i += 1
        frac = float(c) - whole
        if frac > 0:
            part = parts[i % p]
            part[v] = part.get(v, 0.0) + frac
            i += 1
    return tuple(
        summary_from_pairs(tuple(d.keys()), tuple(d.values()))
        for d in parts)
