"""Planner helpers the executor uses: the catalog's schema and base
statistics, the histogram-aware retain and semi-join match fractions of a
build subtree, and runtime-filter placement (sideways information passing).

Predicate pushdown, projection pruning, the System-R join-order DP and
hypercube planning come with the reordering and hypercube slices of the
port.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ..core.cost_model import (BLOOM_DEFAULT_BITS_PER_KEY, CostParams,
                               JoinMethod, cached_filter_cost, method_cost)
from ..core.selection import JoinProperties, select_join_method
from ..core.stats import ColumnStats, TableStats
from .datagen import Catalog
from .logical import (Node, Project, RuntimeFilter, Scan, Schema,
                      filter_chain, key_band_fraction)
from .runtime_filters import (DEFAULT_FILTER_KINDS, FILTER_KINDS,
                              FilterCache, filter_cache_key)
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


def _step(probe: TableStats, build: TableStats, params: CostParams,
          ) -> Tuple[JoinMethod, float]:
    """Method + modeled workload of one candidate join (Algorithm 1 on the
    candidate's statistics; Eq. 4/8/10 dispatch when selection fell back)."""
    sel = select_join_method(probe, build, JoinProperties(), params)
    cost = sel.cost
    if not math.isfinite(cost):
        a, b = ((probe, build) if probe.size_bytes >= build.size_bytes
                else (build, probe))
        cost = method_cost(sel.method, a.size_bytes, b.size_bytes,
                           max(a.cardinality, 1.0), max(b.cardinality, 1.0),
                           params)
    return sel.method, cost


# ---------------------------------------------------------------------------
# Runtime-filter placement (sideways information passing)
# ---------------------------------------------------------------------------

def leaf_key_domain(node: Node, base_stats: Dict[str, TableStats]
                    ) -> Optional[float]:
    """Cardinality of the key domain a leaf's unique key spans: the base
    scan's row count (dimension PKs cover [0, n)). None when the leaf is
    not rooted in a scan (e.g. an aggregated subquery) — the filter planner
    then falls back to the leaf's static retain fraction."""
    base, _ = filter_chain(node)
    if isinstance(base, Project):
        return leaf_key_domain(base.child, base_stats)
    if isinstance(base, Scan):
        st = base_stats.get(base.table)
        return st.cardinality if st is not None else None
    return None


def plan_runtime_filters(edges, leaf_stats: List[TableStats],
                         sigmas: List[float], params: CostParams,
                         bits_per_key: int = BLOOM_DEFAULT_BITS_PER_KEY,
                         leaves: Optional[List[Node]] = None,
                         kinds=DEFAULT_FILTER_KINDS,
                         cache: Optional[FilterCache] = None
                         ) -> List[RuntimeFilter]:
    """Decide runtime-filter placement + kind per join-graph edge.

    ``sigmas[i]`` is leaf i's estimated match fraction when it plays the
    build role: the share of the probe side's key domain its surviving keys
    cover (measured build cardinality / domain when the executor calls
    this, the static retain fraction in the planner). Every kind in
    ``kinds`` quotes the edge (bloom always; zone map only when ``leaves``
    lets the band test see a range predicate on the build key; semi-join
    always, priced by its exact key list) and the strictly cheapest quote
    wins — ties resolve to the earliest kind in ``kinds``, which keeps the
    bloom-only behaviour bit-stable under the default order. An edge gets
    its winning filter iff the filtered join plus the filter's build +
    broadcast cost is *strictly* cheaper under the RelJoin cost model than
    the unfiltered join — so at sigma = 1 (unfiltered build) nothing is
    ever planned and selections are byte-identical to the paper's. Edges
    derived through key equivalence classes participate too: that is what
    pushes a dimension's filter below exchanges of relations it never
    directly joins.

    With a ``cache`` (cross-query ``FilterCache``), a kind whose payload
    is already cached for the edge's build leaf is quoted at
    ``cached_filter_cost`` instead — broadcast only, the build + reduce
    terms drop — so warm filters clear the gate on edges a cold build
    would not. An empty or absent cache changes no quote: cold-cache
    decisions are byte-identical to the uncached planner's.
    """
    out: List[RuntimeFilter] = []
    seen = set()
    for e in edges:
        ident = (e.probe, e.build, e.probe_key, e.build_key)
        if ident in seen:
            continue
        seen.add(ident)
        a, b = leaf_stats[e.probe], leaf_stats[e.build]
        if a.cardinality <= 0:
            continue
        n = max(b.cardinality, 0.0)
        band = (key_band_fraction(leaves[e.build], e.build_key)
                if leaves is not None else None)
        _, unfiltered = _step(a, b, params)
        best = None          # (total, quote, filtered_cost, cached, cost)
        for kname in kinds:
            quote = FILTER_KINDS[kname].quote(n, sigmas[e.build], band,
                                              bits_per_key, params)
            if quote is None or quote.keep_est >= 1.0:
                continue
            cached = (cache is not None and leaves is not None
                      and cache.contains(filter_cache_key(
                          leaves[e.build], e.build_key, quote.kind,
                          quote.bits, quote.k)))
            cost = (cached_filter_cost(quote.bits, params) if cached
                    else quote.cost)
            _, filtered = _step(a.scaled(quote.keep_est), b, params)
            total = filtered + cost
            if best is None or total < best[0]:
                best = (total, quote, filtered, cached, cost)
        if best is None:
            continue
        total, quote, filtered, cached, cost = best
        if total < unfiltered * (1 - 1e-9):
            out.append(RuntimeFilter(e.probe, e.build, e.probe_key,
                                     e.build_key, quote.bits, quote.k,
                                     sigmas[e.build], quote.keep_est,
                                     unfiltered - filtered, cost,
                                     derived=e.derived, kind=quote.kind,
                                     cached=cached))
    return out
