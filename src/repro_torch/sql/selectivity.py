"""Op-aware filter selectivity derivation (shared by binder + estimator).

The hand-built suite declares every ``Filter.selectivity`` by hand; parsed
SQL text cannot. This module derives the estimate from the synthetic
schema's column metadata instead: every generated column is uniform over a
known domain (``datagen.COLUMN_DOMAINS`` for payload + date columns,
``datagen.STATIC_KEY_DOMAINS`` / ``Catalog.key_domains`` for FK/PK
columns), so an op-specific fraction is exact, not a guess — ``d_month eq
6`` is 1/12 under the 360-day calendar, ``ss_quantity lt 10`` is 9/99,
``i_category in (1,3,5)`` is 3/10.

Since PR 10 the estimator can also consult *measured* per-column
statistics (``Catalog.column_stats``: NDV / MCV / equi-depth histograms
from ``core.stats``). A histogram, when one covers the filter's column,
wins over both the declared selectivity and the domain fractions: the
parsed-SQL binder bakes a domain-derived estimate into every ``Filter``
it emits, so data-driven estimates must take precedence over declared
ones to ever bite — and a measured histogram is strictly better
information than either. Without stats (hand-built catalogs, unknown
columns) the old precedence stands: declared selectivity wins, then
domain fractions, then ``DEFAULT_SELECTIVITY``.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

from ..core.stats import ColumnStats
from . import datagen
from .logical import Filter

#: Fallback when nothing is known about the column.
DEFAULT_SELECTIVITY = 0.5

__all__ = ["DEFAULT_SELECTIVITY", "derive_selectivity"]


def _clamp(x: float) -> float:
    return min(max(x, 0.0), 1.0)


def _int_fraction(f: Filter, lo: float, hi: float) -> float:
    """Fraction of the integer domain ``[lo, hi)`` a predicate keeps."""
    n = hi - lo
    if n <= 0:
        return DEFAULT_SELECTIVITY

    def count_lt(v: float) -> float:
        return min(max(math.ceil(v) - lo, 0.0), n)

    def count_le(v: float) -> float:
        return min(max(math.floor(v) - lo + 1.0, 0.0), n)

    def count_eq(v: float) -> float:
        return 1.0 if (lo <= v < hi and float(v).is_integer()) else 0.0

    if f.op == "eq":
        return count_eq(f.value) / n
    if f.op == "ne":
        return 1.0 - count_eq(f.value) / n
    if f.op == "lt":
        return count_lt(f.value) / n
    if f.op == "le":
        return count_le(f.value) / n
    if f.op == "gt":
        return (n - count_le(f.value)) / n
    if f.op == "ge":
        return (n - count_lt(f.value)) / n
    if f.op == "between":
        return max(count_le(f.value2) - count_lt(f.value), 0.0) / n
    if f.op == "in":
        return sum(count_eq(v) for v in set(f.values)) / n
    raise ValueError(f"unknown filter op {f.op}")


def _float_fraction(f: Filter, lo: float, hi: float) -> float:
    """Fraction of the continuous-uniform domain ``[lo, hi)`` kept.
    Point predicates (``eq``/``in``) have measure zero; ``ne`` measure one.
    """
    width = hi - lo
    if width <= 0:
        return DEFAULT_SELECTIVITY
    if f.op == "eq":
        return 0.0
    if f.op == "ne":
        return 1.0
    if f.op in ("lt", "le"):
        return _clamp((f.value - lo) / width)
    if f.op in ("gt", "ge"):
        return _clamp((hi - f.value) / width)
    if f.op == "between":
        return _clamp((min(f.value2, hi) - max(f.value, lo)) / width)
    if f.op == "in":
        return 0.0
    raise ValueError(f"unknown filter op {f.op}")


def derive_selectivity(f: Filter,
                       key_domains: Optional[Mapping[str, float]] = None,
                       column_stats: Optional[Mapping[str, ColumnStats]]
                       = None) -> float:
    """Selectivity estimate for one Filter.

    A per-column histogram (``column_stats``, keyed by column name) wins
    when it covers the filter's column: its MCV/equi-depth fraction is the
    measured answer, overriding even a declared ``f.selectivity`` (the
    binder bakes domain estimates into every parsed filter — see the
    module docstring). Otherwise declared wins, then the column's domain
    is looked up — payload/date columns in ``COLUMN_DOMAINS``, key columns
    in ``key_domains`` (e.g. a live ``Catalog.key_domains``) falling back
    to the static ``STATIC_KEY_DOMAINS`` — and the op-specific kept
    fraction computed. Unknown columns get ``DEFAULT_SELECTIVITY``.
    """
    if f.op == "eqcol":
        # Column-to-column equality: no literal to intersect with a domain
        # or histogram. Declared wins; otherwise two independent uniform
        # columns over a shared domain of n values match with probability
        # 1/n — but the estimator has no join-aware domain here, so keep
        # the conservative default.
        if f.selectivity is not None:
            return f.selectivity
        return DEFAULT_SELECTIVITY
    if column_stats is not None:
        cs = column_stats.get(f.column)
        if cs is not None and cs.count > 0:
            return _clamp(cs.fraction(f.op, f.value, f.value2, f.values))
    if f.selectivity is not None:
        return f.selectivity
    dom = datagen.COLUMN_DOMAINS.get(f.column)
    if dom is None:
        n = None
        if key_domains is not None:
            n = key_domains.get(f.column)
        if n is None:
            n = datagen.STATIC_KEY_DOMAINS.get(f.column)
        if n is None or n <= 0:
            return DEFAULT_SELECTIVITY
        dom = (0, n, True)
    lo, hi, integral = dom
    frac = (_int_fraction(f, lo, hi) if integral
            else _float_fraction(f, lo, hi))
    return _clamp(frac)
