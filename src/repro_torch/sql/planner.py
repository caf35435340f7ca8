"""Planner helpers the executor's main path uses: the catalog's schema and
base statistics, and the histogram-aware retain and semi-join match
fractions of a build subtree.

Predicate pushdown, projection pruning, the System-R join-order DP,
runtime-filter planning and hypercube planning come with the reordering,
runtime-filter and hypercube slices of the port.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..core.stats import ColumnStats, TableStats
from .datagen import Catalog
from .logical import Node, Project, Schema, filter_chain
from .selectivity import derive_selectivity


def catalog_schema(catalog: Catalog) -> Schema:
    return {name: tuple(t.columns) for name, t in catalog.tables.items()}


def catalog_base_stats(catalog: Catalog) -> Dict[str, TableStats]:
    """Exact base-table statistics (the catalog's header stats)."""
    return {name: t.measure() for name, t in catalog.tables.items()}


def stats_retain_fraction(node: Node,
                          key_domains: Optional[Dict[str, float]] = None,
                          column_stats: Optional[Dict[str, ColumnStats]]
                          = None) -> float:
    """Histogram-aware twin of ``logical.leaf_retain_fraction``: the
    fraction of a build leaf's key domain surviving its filter chain,
    with each filter's fraction taken from the column's histogram when one
    exists. Without ``column_stats`` it reproduces the declared/derived
    fractions exactly."""
    base, filters = filter_chain(node)
    frac = 1.0
    for f in filters:
        frac *= min(max(derive_selectivity(f, key_domains, column_stats),
                        0.0), 1.0)
    if isinstance(base, Project):
        frac *= stats_retain_fraction(base.child, key_domains, column_stats)
    return frac


def semi_match_fraction(build: TableStats, probe_key: str,
                        key_domains: Optional[Dict[str, float]],
                        retain: float) -> float:
    """Fraction of probe rows a semi join keeps: the build side's distinct
    keys (its estimated cardinality — the engine's unique-build-key
    contract makes cardinality ≈ NDV) over the probe key's domain. Falls
    back to the build chain's filter-retain fraction when the probe key
    has no known domain."""
    domain = key_domains.get(probe_key) if key_domains else None
    if domain is not None and domain > 0:
        return min(max(build.cardinality, 0.0) / domain, 1.0)
    return min(max(retain, 0.0), 1.0)
