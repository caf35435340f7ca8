"""Adaptive stage-wise plan execution (paper §4.1, Fig. 3).

The executor walks the physical plan bottom-up. Every Join/Aggregate is an
exchange boundary == query-stage barrier: its inputs are materialized, their
*measured* (size, cardinality) become the adaptive runtime statistics, and
the method for the join about to run is (re-)selected with those statistics
— the paper's per-stage re-optimization (selection per join is independent,
§4.2, so bottom-up re-selection yields the model-global optimum).

``adaptive=False`` reproduces a static optimizer: selections use statistics
propagated from base tables through operator estimation rules (optionally
perturbed by ``est_error`` to emulate stale catalogs).

Runtime filters (``FilteredStrategy``): a filter per join-graph edge is
planned with measured build-side statistics and applied to the probe side
below its exchanges; inner-join regions of three or more leaves are
evaluated leaf-first for that, then joined in their written order.

Join reordering, skew measurement, plan verification, re-optimization and
shared intermediates come with later slices of the port and raise
``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from ..core.cost_model import (BLOOM_DEFAULT_BITS_PER_KEY, CostParams,
                               JoinMethod, filter_reduce_cost,
                               runtime_filter_cost)
from ..core.selection import JoinProperties, JoinType, Selection
from ..core.stats import (StatsSource, TableStats, estimate_filter,
                          estimate_group_by, estimate_join, q_error)
from ..joins.aggregate import group_aggregate
from ..joins.methods import JoinReport, run_equi_join
from ..joins.table import Table, compact_partitions
from .datagen import Catalog
from .logical import (Aggregate, Filter, Join, JoinEdge, Node, Project,
                      RuntimeFilter, Scan, augment_edges, extract_join_graph,
                      key_retain_fraction)
from .planner import (catalog_base_stats, catalog_schema, leaf_key_domain,
                      plan_runtime_filters, semi_match_fraction,
                      stats_retain_fraction)
from .runtime_filters import (DEFAULT_FILTER_KINDS, build_filter_payload,
                              chain_stats_key, filter_cache_key,
                              probe_filter_mask)
from .selectivity import derive_selectivity
from .strategies import Strategy

#: Executor features of later slices: (strategy flag, slice that brings it).
_LATER_SLICES = (("reorder", "reordering"), ("skew_aware", "skew"),
                 ("verify", "plan-verification"), ("reopt", "re-optimization"))

#: Shuffle-family methods: both sides cross the wire, so a probe-side
#: runtime filter reduces their exchange bytes (broadcast ships B only).
_SHUFFLE_FAMILY = (JoinMethod.SHUFFLE_HASH, JoinMethod.SHUFFLE_SORT,
                   JoinMethod.SALTED_SHUFFLE_HASH)

#: Join types for which a probe-side runtime filter is semantics-free.
#: INNER/LEFT_SEMI: dropped probe rows cannot appear in the result (no
#: filter kind has false negatives). LEFT_OUTER: dropped probe rows DO
#: appear (null-padded), so the executor captures them before the join
#: and re-injects them afterwards with zero-padded build columns and
#: ``_matched=False`` — exactly what the join itself would have produced
#: for them. LEFT_ANTI stays unfilterable: the filter would drop exactly
#: the rows the query keeps.
_FILTERABLE_TYPES = (JoinType.INNER, JoinType.LEFT_SEMI,
                     JoinType.LEFT_OUTER)


@dataclasses.dataclass
class JoinDecision:
    """Audit record of one join's selection + execution."""

    selection: Selection
    left_stats: TableStats
    right_stats: TableStats
    report: JoinReport
    #: The properties (incl. partition flags) the selection ran under.
    props: Optional[JoinProperties] = None

    @property
    def network_bytes(self) -> float:
        return sum(e.network_bytes for e in self.report.exchanges)

    @property
    def local_bytes(self) -> float:
        return self.report.local_bytes

    @property
    def straggler_bytes(self) -> float:
        """Hottest-partition load of this join's exchanges (both sides must
        land before the local join starts, so the stage's straggler is the
        sum of the per-exchange straggler loads)."""
        return sum(e.straggler_bytes for e in self.report.exchanges)

    @property
    def probe_shuffle_bytes(self) -> float:
        """Network bytes the probe (plan-left) side shipped through this
        join's shuffle — the traffic runtime filters exist to cut.
        Broadcast-family joins never move the probe side, so 0 there."""
        if self.selection.method not in _SHUFFLE_FAMILY:
            return 0.0
        return self.report.exchanges[0].network_bytes


@dataclasses.dataclass
class FilterDecision:
    """Audit record of one planned-and-executed runtime filter (any kind)."""

    plan: RuntimeFilter      # the planner's placement + kind + cost rationale
    rows_before: int
    rows_after: int
    p: int                   # parallelism the filter was broadcast over
    #: True when the payload came out of the cross-query FilterCache —
    #: no build ran, so the distributed-build reduce bytes are zero.
    cached: bool = False

    @property
    def broadcast_bytes(self) -> float:
        """Wire bytes of shipping the serialized filter to the probe
        side's p-1 remote tasks (Eq. 1 on m_bits/8 bytes) — paid per
        query, cached or not: ``runtime_filter_cost`` at w=1 (raw bytes),
        so the measured accounting tracks the planner's model."""
        return runtime_filter_cost(self.plan.m_bits,
                                   CostParams(p=self.p, w=1.0))

    @property
    def reduce_bytes(self) -> float:
        """Wire bytes of the distributed *build* merge, charged at the
        kind's reduce shape (``filter_reduce_cost`` at w=1). Zero on a
        cache hit — nothing was built."""
        if self.cached:
            return 0.0
        return filter_reduce_cost(self.plan.m_bits,
                                  CostParams(p=self.p, w=1.0),
                                  kind=self.plan.kind)

    @property
    def network_bytes(self) -> float:
        """Total measured wire cost of the filter: build merge (if any)
        plus the per-query broadcast."""
        return self.reduce_bytes + self.broadcast_bytes

    @property
    def keep_measured(self) -> float:
        if self.rows_before <= 0:
            return 1.0
        return self.rows_after / self.rows_before


@dataclasses.dataclass
class CardinalityRecord:
    """Estimated-vs-measured cardinality at one exchange boundary."""

    kind: str        # "join" | "aggregate"
    estimated: float
    measured: float

    @property
    def q_error(self) -> float:
        """Symmetric relative error, one-row-floored (``core.stats``)."""
        return q_error(self.estimated, self.measured)


@dataclasses.dataclass
class ExecutionResult:
    table: Table
    decisions: List[JoinDecision]
    wall_time_s: float
    network_bytes: float
    local_bytes: float
    rows: int
    #: Sum over joins of their hottest-partition exchange loads — the
    #: skew-sensitive lower bound on stage wall time (straggler metric).
    straggler_bytes: float = 0.0
    #: Runtime filters (any kind) that were planned and applied, in order.
    filters: List[FilterDecision] = dataclasses.field(default_factory=list)
    #: Estimated-vs-measured cardinality at every join/aggregate boundary.
    cardinalities: List[CardinalityRecord] = dataclasses.field(
        default_factory=list)

    def methods(self):
        return [d.selection.method for d in self.decisions]

    def workload(self, w: float = 1.0) -> float:
        """Measured cluster workload under the paper's weighting."""
        return w * self.network_bytes + self.local_bytes

    @property
    def filter_network_bytes(self) -> float:
        """Wire bytes spent building and broadcasting runtime filters
        (already included in ``network_bytes``)."""
        return sum(f.network_bytes for f in self.filters)

    @property
    def filter_reduce_bytes(self) -> float:
        """Wire bytes of the filters' distributed-build merges only — the
        component a cross-query cache hit eliminates. Zero on a fully warm
        run."""
        return sum(f.reduce_bytes for f in self.filters)

    @property
    def cached_filters(self) -> int:
        """How many applied filters came out of the cross-query cache."""
        return sum(1 for f in self.filters if f.cached)

    @property
    def probe_shuffle_bytes(self) -> float:
        """Suite metric for runtime filters: bytes the probe sides shipped
        through shuffle-family exchanges."""
        return sum(d.probe_shuffle_bytes for d in self.decisions)


@dataclasses.dataclass
class _Annotated:
    table: Table
    measured: TableStats   # adaptive runtime statistic (post-materialization)
    estimated: TableStats  # statically-propagated estimate


class Executor:
    """Runs a logical plan on the catalog's device.

    ``use_kernel=None`` runs the local joins through the hand-written
    kernels on a CUDA catalog and through the gather path / stable sort on
    a CPU one; ``True`` on a CPU catalog takes the kernel path through the
    kernels' plain versions.
    """

    #: Overflow retries: geometric doubling of the slot capacity, up to
    #: 2^6x the starting capacity for pathological skew.
    MAX_CAPACITY_RETRIES = 7

    def __init__(self, catalog: Catalog, strategy: Strategy,
                 adaptive: bool = True, est_error: float = 1.0,
                 use_kernel: Optional[bool] = None,
                 capacity_factor: float = 2.0, compact: bool = True,
                 reorder: Optional[bool] = None,
                 verify: Optional[bool] = None,
                 intermediates: Optional[Dict[str, Table]] = None,
                 reopt: Optional[bool] = None):
        asked = {"reorder": reorder, "verify": verify, "reopt": reopt}
        for flag, later in _LATER_SLICES:
            if asked.get(flag) or getattr(strategy, flag, False):
                raise NotImplementedError(
                    f"{flag} (strategy {strategy.name!r}) comes with the "
                    f"{later} slice of the port")
        if intermediates:
            raise NotImplementedError("shared intermediates come with the "
                                      "service slice of the port")
        self.catalog = catalog
        self.strategy = strategy
        self.adaptive = adaptive
        self.est_error = est_error
        self.device = next(iter(catalog.tables.values())).valid.device
        self.use_kernel = (self.device.type == "cuda" if use_kernel is None
                           else use_kernel)
        self.capacity_factor = capacity_factor
        self.compact = compact
        self.p = catalog.p
        # Runtime-filter pushdown (FilteredStrategy): a filter (cheapest
        # applicable kind) per join-graph edge, planned with *measured*
        # build-side statistics and applied to the probe side below its
        # exchanges.
        self.runtime_filters = getattr(strategy, "runtime_filters", False)
        self.filter_bits_per_key = getattr(strategy, "bits_per_key",
                                           BLOOM_DEFAULT_BITS_PER_KEY)
        self.filter_kinds = getattr(strategy, "filter_kinds",
                                    DEFAULT_FILTER_KINDS)
        # Cross-query filter cache: consulted before every build, written
        # after; None = cold path everywhere.
        self.filter_cache = getattr(strategy, "filter_cache", None)
        self._schema = catalog_schema(catalog)
        self._params = CostParams(p=self.p, w=getattr(strategy, "w", 1.0))
        # Key-domain denominators for the filter planner's sigma estimate.
        self._base_stats = (catalog_base_stats(catalog)
                            if self.runtime_filters else {})

    # -- public ---------------------------------------------------------------

    def execute(self, plan: Node) -> ExecutionResult:
        self._decisions: List[JoinDecision] = []
        self._filters: List[FilterDecision] = []
        self._cards: List[CardinalityRecord] = []
        if self.filter_cache is not None:
            # Bind the cache to this catalog: entries built against any
            # other catalog are invalidated before planning.
            self.filter_cache.sync(self.catalog)
        t0 = time.perf_counter()
        ann = self._eval(plan)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        net = sum(d.network_bytes for d in self._decisions)
        net += sum(f.network_bytes for f in self._filters)
        loc = sum(d.local_bytes for d in self._decisions)
        strag = sum(d.straggler_bytes for d in self._decisions)
        return ExecutionResult(ann.table, self._decisions, dt, net, loc,
                               ann.table.count(), straggler_bytes=strag,
                               filters=self._filters,
                               cardinalities=self._cards)

    # -- evaluation ------------------------------------------------------------

    def _eval(self, node: Node) -> _Annotated:
        if isinstance(node, Scan):
            t = self.catalog.table(node.table)
            measured = t.measure()
            est = TableStats(measured.size_bytes * self.est_error,
                             measured.cardinality * self.est_error,
                             StatsSource.ESTIMATED)
            return _Annotated(t, measured, est)

        if isinstance(node, Filter):
            child = self._eval(node.child)
            t = _apply_filter(child.table, node)
            # In-stage operator: runtime stats are *propagated estimates*
            # from the last materialization (paper §4.1 step 2). The
            # catalog's per-column histograms, when present, beat both the
            # declared selectivity and the uniform-domain fractions.
            sel = derive_selectivity(node, self.catalog.key_domains,
                                     self.catalog.column_stats or None)
            measured = estimate_filter(child.measured, sel)
            est = estimate_filter(child.estimated, sel)
            return _Annotated(t, measured, est)

        if isinstance(node, Project):
            child = self._eval(node.child)
            t = child.table.select(node.columns)
            frac = t.row_bytes / max(child.table.row_bytes, 1)
            m, e = child.measured, child.estimated
            return _Annotated(
                t,
                TableStats(m.size_bytes * frac, m.cardinality, m.source),
                TableStats(e.size_bytes * frac, e.cardinality, e.source))

        if isinstance(node, Join):
            if self.runtime_filters:
                # Leaf-level filter application is what pushes a filter
                # below the probe side's earlier exchanges.
                graph = extract_join_graph(node, self._schema)
                if graph is not None and graph.n >= 3:
                    return self._eval_region(graph)
            left = self._eval(node.left)
            right = self._eval(node.right)
            # Exchange boundary: re-measure both inputs (adaptive runtime
            # statistics). Non-adaptive mode keeps static estimates.
            lstats = self._boundary_stats(left, node.left)
            rstats = self._boundary_stats(right, node.right)
            spill = None
            if (self.runtime_filters and node.hint is None
                    and node.join_type in _FILTERABLE_TYPES):
                before = left
                left, lstats = self._filter_pair(left, lstats, right, rstats,
                                                 node)
                if (node.join_type is JoinType.LEFT_OUTER
                        and left is not before):
                    # Padding path: the rows the filter dropped are exactly
                    # the probe rows with no build match — capture them so
                    # they can re-enter the result null-padded.
                    spill = before.table.with_valid(before.table.valid
                                                    & ~left.table.valid)
            out = self._join(left, right, lstats, rstats, node.left_key,
                             node.right_key, node.join_type, node.hint,
                             retain=self._retain(node.right))
            if spill is not None:
                out = self._pad_outer_rows(out, spill)
            return out

        if isinstance(node, Aggregate):
            child = self._eval(node.child)
            out, _rep = self._run_agg_with_retry(child.table, node.key,
                                                 node.aggs)
            if self.compact:
                out = compact_partitions(out)
            measured = out.measure()
            cs = self.catalog.column_stats.get(node.key)
            if cs is not None and cs.count > 0:
                # Group-count estimate from the catalog's measured NDV —
                # a genuine prediction, so it enters the q-error trail.
                est = estimate_group_by(child.estimated, max(cs.ndv, 1.0))
                self._cards.append(CardinalityRecord(
                    "aggregate", est.cardinality, measured.cardinality))
            else:
                # No histogram for the group key: fall back to the measured
                # group count — not a prediction, so it stays out of the
                # q-error trail.
                est = estimate_group_by(child.estimated,
                                        measured.cardinality or 1)
            return _Annotated(out, measured, est)

        raise TypeError(f"unknown plan node {type(node)}")

    def _retain(self, leaf: Node) -> float:
        """Histogram-aware kept fraction of a build subtree's filter chain
        (the planner's ``stats_retain_fraction`` under this catalog)."""
        return stats_retain_fraction(leaf, self.catalog.key_domains,
                                     self.catalog.column_stats or None)

    # -- runtime filters --------------------------------------------------------

    def _leaf_sigma(self, leaf: Node, stat: TableStats,
                    build_key: str) -> float:
        """Estimated match fraction when ``leaf`` plays the build role: its
        surviving distinct keys (= measured cardinality; build keys are
        unique) over the key domain. Falls back to the static *key* retain
        fraction when no domain is known (e.g. aggregated subqueries).

        When the cross-query ``FilterCache`` holds *measured* build-side
        stats for this leaf's predicate chain, those replace a
        merely-estimated ``stat``; runtime-sourced stats are already
        measured and are never overridden."""
        if (self.filter_cache is not None
                and stat.source is not StatsSource.RUNTIME):
            cached = self.filter_cache.measured_build_stats(
                chain_stats_key(leaf, build_key))
            if cached is not None:
                stat = cached
        domain = self.catalog.key_domains.get(build_key)
        if domain is None:
            domain = leaf_key_domain(leaf, self._base_stats)
        if domain and domain > 0:
            return min(max(stat.cardinality, 0.0) / domain, 1.0)
        return key_retain_fraction(leaf, build_key)

    def _filter_pair(self, left: _Annotated, lstats: TableStats,
                     right: _Annotated, rstats: TableStats,
                     node: Join):
        """Plan + apply a runtime filter for a single (non-region) join:
        the probe table is masked before the join's exchange."""
        sigma = self._leaf_sigma(node.right, rstats, node.right_key)
        edge = JoinEdge(0, 1, node.left_key, node.right_key)
        plan = plan_runtime_filters([edge], [lstats, rstats], [1.0, sigma],
                                    self._params, self.filter_bits_per_key,
                                    leaves=[node.left, node.right],
                                    kinds=self.filter_kinds,
                                    cache=self.filter_cache)
        if not plan:
            return left, lstats
        left = self._apply_runtime_filter(plan[0], left, right.table,
                                          node.right)
        return left, self._boundary_stats(left, node.left)

    def _region_filters(self, graph, anns, stats, edges):
        """Plan filters over a region's (augmented) edges with measured leaf
        statistics and apply them at the probe *leaves* — below every
        exchange of the region — then re-measure, so every selection runs
        on post-filter cardinalities."""
        sigmas = [1.0] * graph.n
        for e in edges:
            sigmas[e.build] = self._leaf_sigma(graph.leaves[e.build],
                                               stats[e.build], e.build_key)
        plan = plan_runtime_filters(edges, stats, sigmas, self._params,
                                    self.filter_bits_per_key,
                                    leaves=graph.leaves,
                                    kinds=self.filter_kinds,
                                    cache=self.filter_cache)
        masked = set()   # leaves already masked by an earlier filter
        for rf in plan:
            # A build leaf that was itself a probe target earlier in this
            # region no longer matches its static predicate chain — its
            # payload is narrowed by *this query's* other filters and must
            # not be stored under the chain-only cache key (a later query
            # reusing it would drop rows that only this query excludes).
            anns[rf.probe] = self._apply_runtime_filter(
                rf, anns[rf.probe], anns[rf.build].table,
                graph.leaves[rf.build],
                cacheable=rf.build not in masked)
            masked.add(rf.probe)
            stats[rf.probe] = self._boundary_stats(anns[rf.probe],
                                                   graph.leaves[rf.probe])
        return anns, stats

    def _apply_runtime_filter(self, rf: RuntimeFilter, probe: _Annotated,
                              build: Table, build_leaf: Node,
                              cacheable: bool = True) -> _Annotated:
        """Build (or fetch from the cross-query cache) the planned filter
        kind and mask the probe table (no false negatives: only rows that
        cannot match are dropped). An empty build side yields the
        reject-everything payload for every kind. Fresh builds are stored
        with the measured build-side stats — unless ``cacheable=False``:
        the build table was masked by another runtime filter of this query
        and no longer matches its leaf's predicate chain. A cached *lookup*
        is still safe there, since the chain-keyed payload is a superset
        (false positives only, never false negatives)."""
        payload = None
        ck = None
        if self.filter_cache is not None:
            ck = filter_cache_key(build_leaf, rf.build_key, rf.kind,
                                  rf.m_bits, rf.k)
            payload = self.filter_cache.lookup(ck)
        cached = payload is not None
        if payload is None:
            payload = build_filter_payload(rf, build)
            if self.filter_cache is not None and cacheable:
                # Store the materialized build table's measurement: the
                # payload was just built from the real rows, so the true
                # cardinality is free.
                self.filter_cache.store(ck, payload, build.measure())
        keep = probe_filter_mask(rf, payload,
                                 probe.table.column(rf.probe_key))
        table = probe.table.with_valid(probe.table.valid & keep)
        measured = table.measure()
        self._filters.append(FilterDecision(rf, probe.table.count(),
                                            int(measured.cardinality),
                                            self.p, cached=cached))
        return _Annotated(table, measured,
                          probe.estimated.scaled(rf.keep_est))

    def _pad_outer_rows(self, ann: _Annotated, spill: Table) -> _Annotated:
        """LEFT_OUTER padding path: re-inject probe rows a runtime filter
        dropped. Those rows provably have no build match (filter kinds have
        no false negatives), so they re-enter exactly as the join would
        have emitted them: probe columns intact, build payload columns
        zero-padded, ``_matched`` False (bool zero)."""
        out = ann.table
        cols = {}
        for name, col in out.columns.items():
            if name in spill.columns:
                pad = spill.columns[name]
            else:
                pad = torch.zeros(spill.valid.shape, dtype=col.dtype,
                                  device=col.device)
            cols[name] = torch.cat([col, pad], dim=1)
        valid = torch.cat([out.valid, spill.valid], dim=1)
        # The appended rows sit in the probe's original layout, so any
        # hash-partitioning the join established no longer holds.
        table = Table(cols, valid, partitioned_by=None)
        if self.compact:
            table = compact_partitions(table)
        return _Annotated(table, table.measure(), ann.estimated)

    def _eval_region(self, graph) -> _Annotated:
        """Execute an inner-join region of three or more leaves with runtime
        filters: every leaf is materialized first (its adaptive runtime
        statistics), filters built from selective build leaves mask the
        probe leaves before any of the region's exchanges, and the region
        then runs in its written join order on the post-filter
        statistics."""
        anns = [self._eval(leaf) for leaf in graph.leaves]
        stats = [self._boundary_stats(a, l)
                 for a, l in zip(anns, graph.leaves)]
        retain = [self._retain(l) for l in graph.leaves]
        anns, stats = self._region_filters(graph, anns, stats,
                                           augment_edges(graph))
        return self._exec_region_tree(graph.tree, graph, anns, retain)

    def _exec_region_tree(self, tree, graph, anns,
                          retain: List[float]) -> _Annotated:
        """Execute a region in its written order (leaves pre-evaluated)."""
        if isinstance(tree, int):
            return anns[tree]
        left = self._exec_region_tree(tree[0], graph, anns, retain)
        right = self._exec_region_tree(tree[1], graph, anns, retain)
        e = graph.edges[tree[2]]
        lstats = self._region_stats(left, tree[0], graph)
        rstats = self._region_stats(right, tree[1], graph)
        r = retain[tree[1]] if isinstance(tree[1], int) else 1.0
        return self._join(left, right, lstats, rstats, e.probe_key,
                          e.build_key, JoinType.INNER, None, retain=r)

    def _region_stats(self, ann, tree, graph) -> TableStats:
        if isinstance(tree, int):
            return self._boundary_stats(ann, graph.leaves[tree])
        return ann.measured if self.adaptive else ann.estimated

    # -- join execution --------------------------------------------------------

    def _join(self, left: _Annotated, right: _Annotated,
              lstats: TableStats, rstats: TableStats, lk: str, rk: str,
              join_type: JoinType, hint,
              retain: float = 1.0) -> _Annotated:
        """Select (per strategy) + execute one physical join; audit it."""
        # Distribution properties: a side already hash-partitioned on its
        # join key gets its shuffle elided by the engine, so the model's
        # shuffle-family quotes drop that side's network term.
        props = JoinProperties(join_type=join_type, hint=hint,
                               left_partitioned=(left.table.partitioned_by
                                                 == lk),
                               right_partitioned=(right.table.partitioned_by
                                                  == rk))
        sel = self.strategy.select(lstats, rstats, props, self.p)
        sel = self._engine_feasible(sel, lstats, rstats, props)
        out, rep = self._run_join_with_retry(sel, left.table, right.table,
                                             lk, rk, join_type.value)
        if self.compact:
            out = compact_partitions(out)
        self._decisions.append(JoinDecision(sel, lstats, rstats, rep,
                                            props=props))
        measured = out.measure()
        # FK->PK output estimate, scaled by the build side's histogram
        # retain fraction: INNER narrows the probe by retain; semi keeps the
        # domain-coverage match fraction (build NDV over probe-key domain),
        # anti its complement; outer joins keep every probe row.
        if join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            sigma = semi_match_fraction(right.estimated, lk,
                                        self.catalog.key_domains, retain)
            frac = (sigma if join_type is JoinType.LEFT_SEMI
                    else max(1.0 - sigma, 0.0))
            est = left.estimated.scaled(frac)
        elif join_type is JoinType.INNER:
            est = estimate_join(left.estimated, right.estimated,
                                fk_selectivity=retain)
        else:
            est = estimate_join(left.estimated, right.estimated)
        self._cards.append(CardinalityRecord("join", est.cardinality,
                                             measured.cardinality))
        return _Annotated(out, measured, est)

    def _engine_feasible(self, sel: Selection, lstats: TableStats,
                         rstats: TableStats,
                         props: JoinProperties) -> Selection:
        """The engine always broadcasts the RIGHT (unique-key build) side,
        while the model's broadcast-hash premise is that B — the *smaller*
        side — is broadcast (§3.1.4). When the build side is the larger one
        the premise is void: broadcasting it costs (p-1)|A_big|, strictly
        worse than the shuffle the model ranks next. Degrade to shuffle
        hash (same spirit as §4.4's validity fallback)."""
        if (props.hint is None
                and sel.method is JoinMethod.BROADCAST_HASH
                and rstats.size_bytes > lstats.size_bytes):
            return dataclasses.replace(
                sel, method=JoinMethod.SHUFFLE_HASH,
                # The quoted cost must be the cost of the method that
                # actually runs, not the voided broadcast.
                cost=sel.costs.get(JoinMethod.SHUFFLE_HASH, sel.cost),
                reason=sel.reason + "; engine: build side larger -> shuffle")
        return sel

    def _run_join_with_retry(self, sel, left, right, lk, rk, jt):
        """Skew mitigation: double slot capacity until no overflow (the
        engine-level straggler guard)."""
        factor = self.capacity_factor
        for _ in range(self.MAX_CAPACITY_RETRIES):
            out, rep = run_equi_join(sel.method, left, right, lk, rk,
                                     join_type=jt, use_kernel=self.use_kernel,
                                     capacity_factor=factor,
                                     salt_r=sel.salt_r)
            if all(e.overflow_rows == 0 for e in rep.exchanges):
                return out, rep
            factor *= 2
        raise RuntimeError("shuffle overflow persisted after capacity retries")

    def _run_agg_with_retry(self, table, key, aggs):
        factor = self.capacity_factor
        for _ in range(self.MAX_CAPACITY_RETRIES):
            out, rep = group_aggregate(table, key, aggs, factor)
            if rep.overflow_rows == 0:
                return out, rep
            factor *= 2
        raise RuntimeError("aggregate overflow persisted after retries")

    def _boundary_stats(self, ann: _Annotated, node: Node) -> TableStats:
        if not self.adaptive:
            return ann.estimated
        # Post-exchange children were just materialized: exact runtime stats.
        if isinstance(node, (Join, Aggregate, Scan)):
            return ann.table.measure()
        return ann.measured


def _apply_filter(table: Table, f: Filter) -> Table:
    c = table.column(f.column)
    if f.op == "eq":
        m = c == f.value
    elif f.op == "ne":
        m = c != f.value
    elif f.op == "lt":
        m = c < f.value
    elif f.op == "le":
        m = c <= f.value
    elif f.op == "gt":
        m = c > f.value
    elif f.op == "ge":
        m = c >= f.value
    elif f.op == "between":
        m = (c >= f.value) & (c <= f.value2)
    elif f.op == "in":
        # OR of equalities against the literal list; an empty list keeps
        # nothing (SQL's `x IN ()` has no match).
        m = torch.zeros_like(table.valid)
        for v in f.values:
            m = m | (c == v)
    elif f.op == "eqcol":
        # Column-to-column equality: the binary engine's residual form of
        # a cyclic core's closing join edge.
        m = c == table.column(str(f.column2))
    else:
        raise ValueError(f"unknown filter op {f.op}")
    return table.with_valid(table.valid & m)
