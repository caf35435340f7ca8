"""Pluggable runtime-filter kinds (sideways information passing).

A ``RuntimeFilterKind`` knows how to

  * **quote** itself for a join-graph edge (serialized wire size, planned
    kept fraction, build+broadcast workload under the RelJoin cost model),
  * **build** its payload from the build side's surviving join keys, and
  * **probe** a key column into a keep-mask (never a false negative).

so ``plan_runtime_filters`` can price every applicable kind per edge and
keep the strictly cheapest — the same relative-cost selection Algorithm 1
applies to join methods, applied to reducers:

    kind        wire size      kept fraction        applicable when
    ---------   ------------   ------------------   --------------------
    bloom       m ~ 10n bits   max(sigma, fpr)      always
    zone_map    64 bits        band width           key set band-shaped
    semi_join   32n bits       sigma (exact)        key list small

Every payload is a pure function of the build key *set* (order- and
duplication-invariant), and every probe mask admits false positives only —
the two properties result preservation rests on. An empty build side
yields the reject-everything payload for every kind (zero bloom words,
empty zone interval, empty key list). Payloads are tensors on the build
table's device: int32 bloom words (``kernels/bloom.py``), an int32 ``(2,)``
interval (``kernels/zone_map.py``), or ``(sorted_keys, n)`` from
``core/psts.key_set``.

**Cross-query caching.** Two queries whose build leaves scan the same table
through the same (order-normalized) predicate chain surface the same key
set, so a built payload can be reused verbatim. ``FilterCache`` keys
entries on ``(table, normalized predicate chain, join key, kind, size
params)`` and is invalidated by the catalog identity fingerprint
(``catalog_fingerprint``); the planner quotes a cache-hit edge at
``cached_filter_cost`` (broadcast only — the build + reduce terms drop),
leaving cold-cache decisions byte-identical.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..core.cost_model import (CostParams, SEMI_JOIN_BITS_PER_KEY,
                               ZONE_MAP_BITS, bloom_fpr, bloom_params,
                               bloom_total_cost, filtered_probe_fraction,
                               semi_join_cost, zone_map_cost)
from ..core.psts import key_set, semi_join_mask
from ..core.stats import StatsSource, TableStats
from ..joins.table import Table
from ..kernels.bloom import bloom_build, bloom_probe
from ..kernels.zone_map import key_range, range_probe
from .datagen import catalog_fingerprint
from .logical import (Node, Project, RuntimeFilter, Scan, filter_chain)


@dataclasses.dataclass(frozen=True)
class FilterQuote:
    """One kind's offer for one edge: what it ships, what it keeps, what
    it costs to build + broadcast (cost-model workload units)."""

    kind: str
    bits: int           # serialized wire size
    k: int              # bloom hash count (0 otherwise)
    keep_est: float     # planned kept fraction of the probe side
    cost: float         # reduce-tree + broadcast workload


class RuntimeFilterKind:
    """Protocol of one pluggable reducer. Subclasses are stateless."""

    name: str = "base"

    def quote(self, n_keys: float, sigma: float, band: Optional[float],
              bits_per_key: int, params: CostParams
              ) -> Optional[FilterQuote]:
        """Price this kind for an edge; None when not applicable.
        ``n_keys`` is the estimated distinct build-key count, ``sigma``
        the estimated match fraction, ``band`` the band-width fraction of
        the build leaf's key set (None = not band-shaped)."""
        raise NotImplementedError

    def build(self, build: Table, key: str, rf: RuntimeFilter):
        """Payload from the build side's surviving keys (tensors)."""
        raise NotImplementedError

    def probe(self, keys: torch.Tensor, payload, rf: RuntimeFilter
              ) -> torch.Tensor:
        """Keep-mask of ``keys`` against a payload (no false negatives)."""
        raise NotImplementedError


class BloomKind(RuntimeFilterKind):
    """Bit-packed bloom filter: always applicable, densest encoding
    (~10 bits/key), kept fraction floored by the false-positive rate."""

    name = "bloom"

    def quote(self, n_keys, sigma, band, bits_per_key, params):
        m_bits, k = bloom_params(n_keys, bits_per_key)
        keep = filtered_probe_fraction(sigma, bloom_fpr(n_keys, m_bits, k))
        return FilterQuote(self.name, m_bits, k, keep,
                           bloom_total_cost(m_bits, params))

    def build(self, build, key, rf):
        return bloom_build(build.column(key), build.valid,
                           m_bits=rf.m_bits, k=rf.k)

    def probe(self, keys, payload, rf):
        return bloom_probe(keys, payload, k=rf.k)


class ZoneMapKind(RuntimeFilterKind):
    """Min/max interval (8 bytes on the wire): applicable when the build
    leaf's surviving keys are band-shaped — a range predicate on the key
    itself — where it keeps exactly the band at the lowest possible
    broadcast cost."""

    name = "zone_map"

    def quote(self, n_keys, sigma, band, bits_per_key, params):
        if band is None:
            return None
        keep = min(max(band, 0.0), 1.0)
        return FilterQuote(self.name, ZONE_MAP_BITS, 0, keep,
                           zone_map_cost(params))

    def build(self, build, key, rf):
        return key_range(build.column(key), build.valid)

    def probe(self, keys, payload, rf):
        return range_probe(keys, payload)


class SemiJoinKind(RuntimeFilterKind):
    """Exact semi-join reducer over the distinct-key machinery in
    ``core.psts``: ships the sorted key list (32 bits/key), keeps exactly
    sigma. Beats bloom when the key list is small enough that exactness
    outprices the denser encoding — high-selectivity, small-domain
    dimensions."""

    name = "semi_join"

    def quote(self, n_keys, sigma, band, bits_per_key, params):
        bits = int(max(n_keys, 0.0) * SEMI_JOIN_BITS_PER_KEY)
        keep = min(max(sigma, 0.0), 1.0)
        return FilterQuote(self.name, bits, 0, keep,
                           semi_join_cost(n_keys, params))

    def build(self, build, key, rf):
        return key_set(build.column(key), build.valid)

    def probe(self, keys, payload, rf):
        sorted_keys, n = payload
        return semi_join_mask(keys, sorted_keys, n)


FILTER_KINDS: Dict[str, RuntimeFilterKind] = {
    k.name: k for k in (BloomKind(), ZoneMapKind(), SemiJoinKind())
}

#: Planner's default scoring order. Bloom first: on an exact cost tie the
#: earlier kind wins, which keeps bloom-only decisions bit-stable.
DEFAULT_FILTER_KINDS: Tuple[str, ...] = ("bloom", "zone_map", "semi_join")


def build_filter_payload(rf: RuntimeFilter, build: Table):
    """Materialize the planned filter from the build side's live keys."""
    return FILTER_KINDS[rf.kind].build(build, rf.build_key, rf)


def probe_filter_mask(rf: RuntimeFilter, payload, keys: torch.Tensor
                      ) -> torch.Tensor:
    """Keep-mask of a probe-side key column against a built payload."""
    return FILTER_KINDS[rf.kind].probe(keys, payload, rf)


# ---------------------------------------------------------------------------
# Cross-query filter cache
# ---------------------------------------------------------------------------

def predicate_chain(leaf: Node) -> Optional[Tuple[str, tuple]]:
    """Normalized conjunctive predicate chain of a Scan-rooted leaf.

    Returns ``(table, sorted (column, op, value, value2, values) specs)``
    — conjunctive filters commute, so sorting makes ``F1(F2(scan))`` and
    ``F2(F1(scan))`` identical, and projections are transparent (they
    never change a column's values). IN-list literals are part of the
    spec (order-normalized, deduplicated): two different IN lists select
    different key sets and must never share a cache entry. Returns None
    for leaves not rooted in a Scan (e.g. aggregated subqueries), whose
    surviving key set is not determined by a predicate chain. This
    normalization is the ground truth both for ``filter_cache_key`` and
    for the analyzer's cache-reuse rule (a stored payload may only serve
    an edge whose chain is a superset of the stored one)."""
    preds = []
    node = leaf
    while True:
        base, filters = filter_chain(node)
        preds.extend((f.column, f.op, float(f.value), float(f.value2),
                      tuple(sorted(set(float(v) for v in f.values))))
                     for f in filters)
        if isinstance(base, Project):
            node = base.child
            continue
        break
    if not isinstance(base, Scan):
        return None
    return base.table, tuple(sorted(preds))


def filter_cache_key(leaf: Node, build_key: str, kind: str, m_bits: int,
                     k: int) -> Optional[tuple]:
    """Canonical cache identity of one (build leaf, kind, params) combo.

    The payload is a pure function of the build leaf's surviving key
    *set*, which for a Scan-rooted leaf is fully determined by its
    :func:`predicate_chain` plus the key column. The kind and its size
    parameters (``m_bits``, and ``k`` for bloom) complete the key: a
    differently-sized bloom array is a different payload even over the
    same key set.

    Returns None — uncacheable — for leaves not rooted in a Scan (e.g.
    aggregated subqueries): their key set depends on the whole subtree's
    execution, which the chain normalization does not capture.
    """
    chain = predicate_chain(leaf)
    if chain is None:
        return None
    table, preds = chain
    return (table, preds, build_key, kind, m_bits, k)


def chain_stats_key(leaf: Node, build_key: str) -> Optional[tuple]:
    """Kind-independent identity of a build leaf's surviving key set —
    ``filter_cache_key`` minus the payload shape. Two payload-distinct
    cache entries (different kind or size) built over the same leaf chain
    measured the *same* build side, so the cache indexes its measured
    build-side stats by this key: a warm cache can then seed the planner's
    sigma estimate for any later query scanning the same chain, whatever
    filter kind that query ends up planning."""
    chain = predicate_chain(leaf)
    if chain is None:
        return None
    table, preds = chain
    return (table, preds, build_key)


@dataclasses.dataclass
class _CacheEntry:
    payload: object            # the built filter (tensors)
    build_stats: TableStats    # measured build-side stats at build time


class FilterCache:
    """Cross-query runtime-filter cache (multi-query amortization).

    q19-q23 rebuild identical dimension filters on every run — exactly
    the redundant runtime work adaptive replanning overhead studies show
    dominating repeat executions. A ``FilterCache`` shared across
    ``Executor`` instances (pass it to ``FilteredStrategy(cache=...)``)
    reuses built payloads instead: the executor consults it before every
    build and stores what it builds (with the measured build-side stats),
    and the planner quotes cache-hit edges at ``cached_filter_cost`` —
    broadcast only, the build + reduce terms drop — so cached filters are
    planned *more* aggressively than cold ones. With an empty (or no)
    cache every quote and selection is byte-identical to the uncached
    planner, preserving the strictly-cheaper gate.

    Validity is keyed on the catalog identity fingerprint
    (``catalog_fingerprint``: version *and* generation uid): ``sync``
    drops every entry when the executor's catalog differs from the one
    the entries were built against (regenerated data, new
    scale/seed/skew), so a stale payload can never filter fresh data —
    even when two distinct catalogs happen to share a version number.
    Entries are never evicted
    otherwise — payloads are tiny (bits on the wire by design) and the
    workload suite is finite; an LRU bound can ride on top when needed.

    ``hits`` / ``misses`` / ``invalidations`` counters make the cache's
    behaviour auditable in tests and benchmarks.
    """

    def __init__(self) -> None:
        self._entries: Dict[tuple, _CacheEntry] = {}
        # Measured build-side stats by chain identity (``chain_stats_key``:
        # the entry key minus kind/shape) — the planner-facing side table
        # that seeds sigma estimates on warm runs. Only RUNTIME-sourced
        # stats enter: an estimated stat must never masquerade as a
        # measurement.
        self._chain_stats: Dict[tuple, TableStats] = {}
        self._catalog_fingerprint: Optional[tuple] = None
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def __len__(self) -> int:
        return len(self._entries)

    def sync(self, catalog) -> None:
        """Bind the cache to ``catalog``; invalidate everything if it is
        not the catalog the current entries were built against. Identity
        is the full fingerprint (version + generation uid), so two
        distinct catalogs sharing a version number can never reuse each
        other's payloads."""
        fingerprint = catalog_fingerprint(catalog)
        if fingerprint != self._catalog_fingerprint:
            if self._entries:
                self.invalidations += 1
            self._entries.clear()
            self._chain_stats.clear()
            self._catalog_fingerprint = fingerprint

    def contains(self, key: Optional[tuple]) -> bool:
        """Planner-side peek: would ``lookup`` hit? (No counter traffic —
        quoting every kind for every edge is not a cache consultation.)"""
        return key is not None and key in self._entries

    def lookup(self, key: Optional[tuple]):
        """Executor-side consult: the cached payload, or None. Counts a
        hit or miss; uncacheable keys (None) count as misses."""
        entry = self._entries.get(key) if key is not None else None
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        return entry.payload

    def store(self, key: Optional[tuple], payload,
              build_stats: TableStats) -> None:
        """Record a freshly built payload (no-op for uncacheable keys)."""
        if key is not None:
            self._entries[key] = _CacheEntry(payload, build_stats)
            if build_stats.source is StatsSource.RUNTIME:
                self._chain_stats[key[:3]] = build_stats

    def build_stats(self, key: Optional[tuple]) -> Optional[TableStats]:
        """Measured build-side stats recorded with a cached payload."""
        entry = self._entries.get(key) if key is not None else None
        return entry.build_stats if entry is not None else None

    def measured_build_stats(self, key: Optional[tuple]
                             ) -> Optional[TableStats]:
        """Runtime-measured build-side stats for a ``chain_stats_key`` —
        the warm-cache sigma seed (None when cold or never measured)."""
        return self._chain_stats.get(key) if key is not None else None
