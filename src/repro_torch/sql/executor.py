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
evaluated leaf-first for that.

Join reordering (``ReorderingStrategy``): the plan is rewritten by predicate
pushdown and projection pruning, every inner-join region of three or more
leaves is ordered by the System-R DP on its leaves' measured statistics and
re-planned at every exchange boundary, and a cyclic region (closing
``eqcol`` filters above it) is quoted as one hypercube multi-way shuffle
against the best binary tree.

Skew measurement (``SkewAwareStrategy``): the join-key straggler factor of
both inputs is measured at every exchange boundary and priced by the
selection, which may salt the hot keys.

Checkpoint re-optimization (``reopt=True``): every region boundary audits
the materialized intermediate's cardinality against the optimizer's
prediction and, past the q-error threshold, re-plans the remainder.

Plan verification (``verify=True``): every plan, re-plan, filter placement
and decision runs through the plan-analysis rules, and a violation raises
``PlanVerificationError``.

Shared intermediates (``intermediates=``, the query service's cross-query
subtree sharing): a Join or Aggregate whose signature is given returns the
injected table in place of running the subtree.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from .. import obs
from ..core.cost_model import (BLOOM_DEFAULT_BITS_PER_KEY,
                               DEFAULT_REOPT_QERROR, CostParams, JoinMethod,
                               filter_reduce_cost, runtime_filter_cost)
from ..core.selection import JoinProperties, JoinType, Selection
from ..core.stats import (StatsSource, TableStats, estimate_filter,
                          estimate_group_by, estimate_join, q_error)
from ..joins.aggregate import group_aggregate
from ..joins.exchange import key_skew
from ..joins.methods import (HypercubeLink, HypercubeSpec, JoinReport,
                             hypercube_multiway_join, run_equi_join)
from ..joins.table import Table, compact_partitions
from .datagen import Catalog
from .logical import (Aggregate, Filter, Join, JoinEdge, Node, Project,
                      RuntimeFilter, Scan, augment_edges,
                      effective_selectivity, extract_join_graph,
                      key_retain_fraction, leaf_columns, signature)
from .plan_analysis import (PlanVerificationError, Violation, analyze_plan,
                            audit_exchanges, audit_filter_decision,
                            audit_selection, catalog_dtypes, check_cache_reuse,
                            check_cache_store, check_filter_placement,
                            check_filter_quote, check_reopt_decision,
                            check_replan_step, check_schema_preserved)
from .planner import (JoinStep, catalog_base_stats, catalog_schema,
                      enumerate_join_order, leaf_key_domain,
                      modeled_tree_cost, plan_hypercube,
                      plan_runtime_filters, prune_projections,
                      push_down_filters, semi_match_fraction,
                      stats_retain_fraction)
from .runtime_filters import (DEFAULT_FILTER_KINDS, build_filter_payload,
                              chain_stats_key, filter_cache_key,
                              predicate_chain, probe_filter_mask)
from .selectivity import derive_selectivity
from .strategies import Strategy

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
#: for them (the padding path; plan-analysis rule F1). LEFT_ANTI stays
#: unfilterable: the filter would drop exactly the rows the query keeps.
_FILTERABLE_TYPES = (JoinType.INNER, JoinType.LEFT_SEMI,
                     JoinType.LEFT_OUTER)


@dataclasses.dataclass
class JoinDecision:
    """Audit record of one join's selection + execution."""

    selection: Selection
    left_stats: TableStats
    right_stats: TableStats
    report: JoinReport
    #: The properties (incl. partition flags) the selection ran under —
    #: what the plan analyzer's exchange audit (E1/E2) checks against.
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
class ReoptDecision:
    """Audit record of one checkpoint re-optimization decision.

    Emitted at every region exchange boundary of a reopt-enabled run,
    triggered or not — plan-analysis rule R2 audits the discipline:
    ``triggered`` iff the recomputed q-error exceeds the threshold, and a
    non-triggered checkpoint must leave the continuation untouched
    (``new_next == old_next``)."""

    boundary: int            # 0-based join index within the region
    estimated: TableStats    # the optimizer's predicted intermediate
    measured: TableStats     # the materialized intermediate, measured
    threshold: float         # the executor's q-error trigger
    q_error: float           # max(est/meas, meas/est), one-row-floored
    triggered: bool
    old_next: Optional[int]  # next build leaf under the unfolded stats
    new_next: Optional[int]  # next build leaf after the checkpoint


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
    #: Checkpoint re-optimization audit trail (reopt-enabled runs only).
    reopts: List[ReoptDecision] = dataclasses.field(default_factory=list)
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

    @property
    def max_q_error(self) -> float:
        """Worst estimated-vs-measured divergence across all boundaries
        (1.0 when nothing was recorded — a perfect, if vacuous, score)."""
        return max((c.q_error for c in self.cardinalities), default=1.0)

    @property
    def reopt_count(self) -> int:
        """How many checkpoints actually triggered a re-optimization."""
        return sum(1 for r in self.reopts if r.triggered)


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
                 hypercube: bool = True,
                 intermediates: Optional[Dict[str, Table]] = None,
                 reopt: Optional[bool] = None,
                 reopt_qerror: Optional[float] = None):
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
        # Plan-space search: wrap any strategy in ReorderingStrategy (or pass
        # reorder=True) to enable pushdown/pruning + adaptive join reordering.
        self.reorder = (getattr(strategy, "reorder", False)
                        if reorder is None else reorder)
        # Hypercube multi-way execution for cyclic regions (eqcol closing
        # predicates above a reorderable region). Armed whenever reordering
        # is — the selection itself stays cost-gated, so acyclic plans and
        # losing quotes are untouched. ``hypercube=False`` forces the
        # binary plan (the comparison arm).
        self.hypercube = hypercube
        # Skew-aware strategies get runtime key-skew measurements attached
        # to the boundary statistics (everyone else sees the uniform 1.0,
        # keeping the paper's strategies bit-identical and measurement-free).
        self.skew_aware = getattr(strategy, "skew_aware", False)
        self.skew_floor = getattr(strategy, "skew_floor", 1.1)
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
        # Debug-mode plan verification: every plan (incl. adaptive re-plans
        # and filter placements) runs through the static analyzer's rules
        # before/while executing; violations raise PlanVerificationError.
        self.verify = (getattr(strategy, "verify", False)
                       if verify is None else verify)
        # Checkpoint mid-query re-optimization: at every region exchange
        # boundary the materialized intermediate's measured cardinality is
        # compared against the optimizer's prediction; past the q-error
        # threshold the measured stats are folded into the remaining join
        # graph and the System-R DP re-runs on the remainder. Off by
        # default, and reopt-off runs take exactly the path they took
        # before it existed.
        self.reopt = (getattr(strategy, "reopt", False)
                      if reopt is None else reopt)
        self.reopt_qerror = (getattr(strategy, "reopt_qerror",
                                     DEFAULT_REOPT_QERROR)
                             if reopt_qerror is None else reopt_qerror)
        # Cross-query CSE injection (QueryService): pre-computed tables for
        # shared exchange-rooted subtrees, keyed on ``logical.signature``.
        # ``_eval`` returns them in place of re-executing the subtree.
        self.intermediates: Dict[str, Table] = (
            dict(intermediates) if intermediates else {})
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
        self._reopts: List[ReoptDecision] = []
        if self.filter_cache is not None:
            # Bind the cache to this catalog: entries built against any
            # other catalog are invalidated before planning.
            self.filter_cache.sync(self.catalog)
        if self.verify:
            self._gate(lambda: analyze_plan(plan, self._schema,
                                            catalog_dtypes(self.catalog)))
        if self.reorder:
            rewritten = prune_projections(
                push_down_filters(plan, self._schema), self._schema)
            if self.verify:
                self._gate(lambda: check_schema_preserved(plan, rewritten,
                                                          self._schema))
                self._gate(lambda: analyze_plan(rewritten, self._schema,
                                                catalog_dtypes(self.catalog)))
            plan = rewritten
        t0 = time.perf_counter()
        with obs.span(obs.QUERY):
            ann = self._eval(plan)
            if self.device.type == "cuda":
                with obs.sync("query"):
                    torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        net = sum(d.network_bytes for d in self._decisions)
        net += sum(f.network_bytes for f in self._filters)
        loc = sum(d.local_bytes for d in self._decisions)
        strag = sum(d.straggler_bytes for d in self._decisions)
        return ExecutionResult(ann.table, self._decisions, dt, net, loc,
                               ann.table.count(), straggler_bytes=strag,
                               filters=self._filters, reopts=self._reopts,
                               cardinalities=self._cards)

    def _gate(self, analysis: Callable[[], List[Violation]]) -> None:
        """Run one plan analysis; raise on any violation."""
        with obs.span(obs.VERIFY):
            violations = analysis()
        if violations:
            raise PlanVerificationError(violations)

    # -- evaluation ------------------------------------------------------------

    def _eval(self, node: Node) -> _Annotated:
        if self.intermediates and isinstance(node, (Join, Aggregate)):
            # Cross-query CSE: a shared exchange-rooted subtree another
            # query (or an earlier producer pass) already materialized is
            # consumed directly — no joins run, no bytes move. Every
            # operator derives a new table and writes no input tensor in
            # place, so fanning one table out to many consumers is safe.
            # Measured stats stand in for both channels: the subtree root
            # is an exchange boundary, where adaptive execution would
            # re-measure anyway.
            shared = self.intermediates.get(signature(node))
            if shared is not None:
                measured = shared.measure()
                return _Annotated(shared, measured, measured)
        if isinstance(node, Scan):
            with obs.span(obs.OP_SCAN):
                t = self.catalog.table(node.table)
                measured = t.measure()
                est = TableStats(measured.size_bytes * self.est_error,
                                 measured.cardinality * self.est_error,
                                 StatsSource.ESTIMATED)
                return _Annotated(t, measured, est)

        if isinstance(node, Filter):
            with obs.span(obs.OP_FILTER):
                if node.op == "eqcol" and self.reorder and self.hypercube:
                    # Closing edge(s) of a possibly-cyclic region: quote the
                    # hypercube multi-way shuffle against the best binary tree.
                    ann = self._try_hypercube(node)
                    if ann is not None:
                        return ann
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
            with obs.span(obs.OP_PROJECT):
                child = self._eval(node.child)
                t = child.table.select(node.columns)
                frac = t.row_bytes / max(child.table.row_bytes, 1)
                m, e = child.measured, child.estimated
                return _Annotated(
                    t,
                    TableStats(m.size_bytes * frac, m.cardinality, m.source),
                    TableStats(e.size_bytes * frac, e.cardinality, e.source))

        if isinstance(node, Join):
            if self.reorder or self.runtime_filters:
                # Regions are extracted for reordering AND for runtime
                # filters: leaf-level filter application is what pushes a
                # filter below the probe side's earlier exchanges.
                graph = extract_join_graph(node, self._schema)
                if graph is not None and graph.n >= 3:
                    return self._eval_region(graph)
            with obs.span(obs.OP_JOIN):
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
                    left, lstats = self._filter_pair(left, lstats, right,
                                                     rstats, node)
                    if (node.join_type is JoinType.LEFT_OUTER
                            and left is not before):
                        # Padding path: the rows the filter dropped are
                        # exactly the probe rows with no build match —
                        # capture them so they can re-enter the result
                        # null-padded.
                        spill = before.table.with_valid(before.table.valid
                                                        & ~left.table.valid)
                out = self._join(left, right, lstats, rstats, node.left_key,
                                 node.right_key, node.join_type, node.hint,
                                 retain=self._retain(node.right))
                if spill is not None:
                    out = self._pad_outer_rows(out, spill)
                return out

        if isinstance(node, Aggregate):
            with obs.span(obs.OP_AGGREGATE):
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
        with obs.span(obs.FILTERS_PLAN):
            sigma = self._leaf_sigma(node.right, rstats, node.right_key)
            edge = JoinEdge(0, 1, node.left_key, node.right_key)
            plan = plan_runtime_filters([edge], [lstats, rstats],
                                        [1.0, sigma], self._params,
                                        self.filter_bits_per_key,
                                        leaves=[node.left, node.right],
                                        kinds=self.filter_kinds,
                                        cache=self.filter_cache)
        if not plan:
            return left, lstats
        if self.verify:
            # The executor compensates LEFT_OUTER placements via the
            # padding path in _eval — that's what licenses F1 here.
            padded = node.join_type is JoinType.LEFT_OUTER
            self._gate(lambda: check_filter_placement(plan[0], node.join_type,
                                                      padded=padded)
                               + check_filter_quote(plan[0]))
        left = self._apply_runtime_filter(plan[0], left, right.table,
                                          node.right)
        return left, self._boundary_stats(left, node.left)

    def _region_filters(self, graph, anns, stats, edges):
        """Plan filters over a region's (augmented) edges with measured leaf
        statistics and apply them at the probe *leaves* — below every
        exchange of the region — then re-measure, so every selection runs
        on post-filter cardinalities."""
        with obs.span(obs.FILTERS_PLAN):
            sigmas = [1.0] * graph.n
            for e in edges:
                sigmas[e.build] = self._leaf_sigma(graph.leaves[e.build],
                                                   stats[e.build],
                                                   e.build_key)
            plan = plan_runtime_filters(edges, stats, sigmas, self._params,
                                        self.filter_bits_per_key,
                                        leaves=graph.leaves,
                                        kinds=self.filter_kinds,
                                        cache=self.filter_cache)
        masked = set()   # leaves already masked by an earlier filter
        for rf in plan:
            if self.verify:
                # Region edges are INNER by construction (extract_join_graph
                # only walks inner joins), so placement is always safe —
                # the gate still runs to catch a future loosening.
                self._gate(lambda: check_filter_placement(rf, JoinType.INNER)
                                   + check_filter_quote(rf))
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
            with obs.span(obs.FILTERS_PLAN):
                ck = filter_cache_key(build_leaf, rf.build_key, rf.kind,
                                      rf.m_bits, rf.k)
                payload = self.filter_cache.lookup(ck)
        cached = payload is not None
        if cached and self.verify and ck is not None:
            # F3 reuse side: the cache keys payloads by (chain, key, kind,
            # shape), so a hit's stored chain must be subset-safe for this
            # edge's chain.
            self._gate(lambda: check_cache_reuse((ck[0], ck[1]),
                                                 predicate_chain(build_leaf)))
        if payload is None:
            with obs.span(obs.FILTERS_BUILD):
                payload = build_filter_payload(rf, build)
            if self.filter_cache is not None and cacheable:
                if self.verify:
                    # F3 store side: only chain-faithful payloads may enter
                    # the cross-query cache.
                    self._gate(lambda: check_cache_store(
                        predicate_chain(build_leaf),
                        build_masked=not cacheable))
                # Store the materialized build table's measurement: the
                # payload was just built from the real rows, so the true
                # cardinality is free.
                self.filter_cache.store(ck, payload, build.measure())
        with obs.span(obs.FILTERS_PROBE):
            keep = probe_filter_mask(rf, payload,
                                     probe.table.column(rf.probe_key))
        table = probe.table.with_valid(probe.table.valid & keep)
        measured = table.measure()
        decision = FilterDecision(rf, probe.table.count(),
                                  int(measured.cardinality),
                                  self.p, cached=cached)
        if self.verify:
            self._gate(lambda: audit_filter_decision(decision))
        self._filters.append(decision)
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

    # -- adaptive join reordering (planner DP at exchange boundaries) ----------

    def _eval_region(self, graph) -> _Annotated:
        """Execute an inner-join region of three or more leaves.

        All region leaves are materialized first (they are needed under any
        order), giving their adaptive runtime statistics; with runtime
        filters, filters built from selective build leaves then mask the
        probe leaves before any of the region's exchanges. Without
        reordering the region runs in its written order. With it, the
        System-R DP enumerates the order on the (post-filter) statistics;
        after every executed join — an exchange boundary — the *remaining*
        order is re-enumerated with the measured intermediate statistics,
        not just the next method re-selected. The written order is kept
        whenever the DP cannot model a strictly cheaper one.

        Checkpoint re-optimization (``reopt=True``) adds a divergence
        audit at every boundary: the materialized intermediate's measured
        cardinality is compared against the optimizer's prediction, and
        past the q-error threshold the measured stats are folded into the
        remaining join graph and the DP re-runs on the remainder — even
        when the written (left-deep) order was standing until then.
        """
        with obs.span(obs.OP_REGION):
            anns = [self._eval(leaf) for leaf in graph.leaves]
            stats = [self._boundary_stats(a, l)
                     for a, l in zip(anns, graph.leaves)]
            retain = [self._retain(l) for l in graph.leaves]
            edges = augment_edges(graph)
            if self.runtime_filters:
                anns, stats = self._region_filters(graph, anns, stats, edges)
            if not self.reorder:
                # Filter-only strategies keep the written join order.
                return self._exec_region_tree(graph.tree, graph, anns, retain)
            with obs.span(obs.REPLAN):
                plan_cost = modeled_tree_cost(graph, stats, retain,
                                              self._params)
                order = enumerate_join_order(stats, retain, edges,
                                             self._params)
                use_dp = (order is not None
                          and order.cost < plan_cost * (1 - 1e-9))
                written = (self._linear_steps(graph)
                           if self.reopt and not use_dp else None)
            if not use_dp and written is None:
                # Written order stands and no checkpointing is possible (reopt
                # off, or a bushy written tree): execute the tree as-is.
                return self._exec_region_tree(graph.tree, graph, anns, retain)
            if use_dp:
                first = order.first
                fallback = [(s.build, None) for s in order.steps]
            else:
                first, fallback = written
            # Until a checkpoint triggers, a standing written order is executed
            # verbatim (no step-wise re-plan: that could silently deviate from
            # the order the DP just declared non-improvable).
            replanning = use_dp
            cur = anns[first]
            cur_stats = stats[first]
            joined = {first}
            boundary = 0
            while len(joined) < graph.n:
                with obs.span(obs.REPLAN):
                    rest = [i for i in range(graph.n) if i not in joined]
                    step = (self._replan_step(cur_stats, joined, rest, stats,
                                              retain, edges)
                            if replanning else None)
                    if step is None:
                        step = self._fallback_step(fallback, joined, edges)
                if self.verify:
                    # R1: adaptive re-plans only follow real join-graph edges.
                    self._gate(lambda: check_replan_step(step, joined, edges))
                b = step.build
                # What the optimizer believes this boundary will produce —
                # the estimate the checkpoint audits against.
                predicted = estimate_join(cur_stats, stats[b],
                                          fk_selectivity=retain[b])
                cur = self._join(cur, anns[b], cur_stats, stats[b],
                                 step.probe_key, step.build_key,
                                 JoinType.INNER, None, retain=retain[b])
                joined.add(b)
                next_stats = cur.measured if self.adaptive else cur.estimated
                if self.reopt:
                    q = q_error(predicted.cardinality,
                                cur.measured.cardinality)
                    triggered = q > self.reopt_qerror
                    # Continuation under the *unfolded* policy, for the audit
                    # trail (R2: a non-trigger must not change it).
                    with obs.span(obs.REPLAN):
                        old_next = self._peek_next(replanning, next_stats,
                                                   joined, stats, retain,
                                                   edges, fallback)
                    if triggered:
                        # Checkpoint: the intermediate is already materialized
                        # (every boundary materializes); fold its measured
                        # stats into the remaining join graph and re-run the
                        # DP on the remainder.
                        next_stats = cur.measured
                        replanning = True
                        with obs.span(obs.REPLAN):
                            new_next = self._peek_next(True, next_stats,
                                                       joined, stats, retain,
                                                       edges, fallback)
                    else:
                        new_next = old_next
                    dec = ReoptDecision(boundary, predicted, cur.measured,
                                        self.reopt_qerror, q, triggered,
                                        old_next, new_next)
                    if self.verify:
                        # R2: trigger iff threshold exceeded; non-triggered
                        # checkpoints leave the continuation untouched.
                        self._gate(lambda: check_reopt_decision(dec))
                    self._reopts.append(dec)
                cur_stats = next_stats
                boundary += 1
            return cur

    def _linear_steps(self, graph):
        """``(first leaf, [(build leaf, edge), ...])`` of a left-deep
        written region tree — the step form checkpoint re-optimization
        needs to audit a standing written order. None when the written
        tree is bushy (the tree path executes it unchanged)."""
        steps = []
        t = graph.tree
        while not isinstance(t, int):
            if not isinstance(t[1], int):
                return None
            steps.append((t[1], graph.edges[t[2]]))
            t = t[0]
        steps.reverse()
        return t, steps

    def _peek_next(self, replanning, cur_stats, joined, stats, retain,
                   edges, fallback) -> Optional[int]:
        """Build leaf the current policy would join next (None = region
        done) — pure lookahead, consumes nothing."""
        if len(joined) >= len(stats):
            return None
        rest = [i for i in range(len(stats)) if i not in joined]
        step = (self._replan_step(cur_stats, joined, rest, stats, retain,
                                  edges)
                if replanning else None)
        if step is None:
            step = self._fallback_step(fallback, joined, edges)
        return step.build

    def _replan_step(self, cur_stats, joined, rest, stats, retain, edges):
        """Re-enumerate the remaining join order from the current
        intermediate (pseudo-leaf 0); return its first step."""
        idx = {r: i + 1 for i, r in enumerate(rest)}
        pstats = [cur_stats] + [stats[r] for r in rest]
        pretain = [1.0] + [retain[r] for r in rest]
        pedges = []
        for e in edges:
            if e.build in joined:
                continue
            if e.probe in joined:
                pedges.append(JoinEdge(0, idx[e.build], e.probe_key,
                                       e.build_key, e.derived))
            else:
                pedges.append(JoinEdge(idx[e.probe], idx[e.build],
                                       e.probe_key, e.build_key, e.derived))
        order = enumerate_join_order(pstats, pretain, pedges, self._params,
                                     start=0)
        if order is None or not order.steps:
            return None
        s = order.steps[0]
        return JoinStep(rest[s.build - 1], s.probe_key, s.build_key,
                        s.method, s.cost)

    def _fallback_step(self, fallback, joined, edges):
        """Next feasible step from the static ``(build, edge)`` order: a
        written order carries its own tree edge; DP orders (edge None)
        take the first live join-graph edge for that build."""
        for b, e in fallback:
            if b in joined:
                continue
            if e is not None and e.probe in joined:
                return JoinStep(b, e.probe_key, e.build_key, None, 0.0)
            for ed in edges:
                if ed.build == b and ed.probe in joined:
                    return JoinStep(b, ed.probe_key, ed.build_key, None, 0.0)
        raise RuntimeError("no feasible join step left in region")

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

    # -- hypercube multi-way execution (cyclic join cores) ---------------------

    def _try_hypercube(self, node: Filter) -> Optional[_Annotated]:
        """Quote + execute the hypercube multi-way shuffle for a cyclic
        region: one-or-more consecutive eqcol Filters (the closing edges)
        sitting directly above a reorderable INNER region. Returns None
        whenever the shape does not match or the multi-way quote is not
        strictly cheaper than the best binary tree — the caller then falls
        through to the binary path, which evaluates the same eqcol
        predicates as post-join residuals (identical semantics)."""
        eqcols: List[Filter] = []
        base: Node = node
        while isinstance(base, Filter) and base.op == "eqcol":
            eqcols.append(base)
            base = base.child
        graph = extract_join_graph(base, self._schema)
        if graph is None or graph.n < 3:
            return None
        cols = [frozenset(leaf_columns(leaf, self._schema))
                for leaf in graph.leaves]

        def owner(col):
            found = [i for i in range(graph.n) if col in cols[i]]
            return found[0] if len(found) == 1 else None

        closing = []
        for f in eqcols:
            u, v = owner(f.column), owner(str(f.column2))
            if u is None or v is None or u == v:
                return None
            closing.append(((u, f.column), (v, str(f.column2))))
        # Materialize the region leaves (needed under either plan) for
        # their adaptive runtime statistics; roll back the audit trail if
        # the binary plan stands, since the caller re-evaluates them.
        n_dec, n_fil = len(self._decisions), len(self._filters)
        anns = [self._eval(leaf) for leaf in graph.leaves]
        stats = [self._boundary_stats(a, leaf)
                 for a, leaf in zip(anns, graph.leaves)]
        retain = [self._retain(leaf) for leaf in graph.leaves]
        binary = modeled_tree_cost(graph, stats, retain, self._params)
        order = enumerate_join_order(stats, retain, augment_edges(graph),
                                     self._params)
        if order is not None:
            binary = min(binary, order.cost)
        hp = plan_hypercube(graph, closing, stats, binary, self._params)
        if hp is None:
            del self._decisions[n_dec:]
            del self._filters[n_fil:]
            return None
        spec = HypercubeSpec(
            dims=hp.dims, axis_keys=hp.axis_keys,
            links=tuple(HypercubeLink(*lk) for lk in hp.links),
            checks=hp.checks)
        tables = tuple(anns[i].table for i in hp.order)
        out, rep = self._run_hypercube_with_retry(tables, spec)
        if self.compact:
            out = compact_partitions(out)
        probe = hp.order[0]
        build = max(hp.order[1:], key=lambda i: stats[i].size_bytes)
        props = JoinProperties()
        if self.verify:
            self._gate(lambda: audit_selection(hp.selection, stats[probe],
                                               stats[build], props,
                                               self._params))
            self._gate(lambda: audit_exchanges(hp.selection, props, rep))
        self._decisions.append(JoinDecision(hp.selection, stats[probe],
                                            stats[build], rep, props=props))
        est = anns[probe].estimated
        for i in hp.order[1:]:
            est = estimate_join(est, anns[i].estimated)
        for f in eqcols:
            est = est.scaled(effective_selectivity(f))
        return _Annotated(out, out.measure(), est)

    def _run_hypercube_with_retry(self, tables, spec):
        factor = self.capacity_factor
        for _ in range(self.MAX_CAPACITY_RETRIES):
            out, rep = hypercube_multiway_join(tables, spec,
                                               capacity_factor=factor,
                                               use_kernel=self.use_kernel)
            if all(e.overflow_rows == 0 for e in rep.exchanges):
                return out, rep
            factor *= 2
        raise RuntimeError("hypercube overflow persisted after retries")

    # -- join execution --------------------------------------------------------

    def _join(self, left: _Annotated, right: _Annotated,
              lstats: TableStats, rstats: TableStats, lk: str, rk: str,
              join_type: JoinType, hint,
              retain: float = 1.0) -> _Annotated:
        """Select (per strategy) + execute one physical join; audit it."""
        # Distribution properties: a side already hash-partitioned on its
        # join key gets its shuffle elided by the engine, so the model's
        # shuffle-family quotes drop that side's network term (the
        # redundant-exchange finding plan analysis rule E2 pins).
        props = JoinProperties(join_type=join_type, hint=hint,
                               left_partitioned=(left.table.partitioned_by
                                                 == lk),
                               right_partitioned=(right.table.partitioned_by
                                                  == rk))
        if self.skew_aware:
            # Adaptive runtime statistic beyond (size, cardinality): the
            # join-key straggler factor from per-partition load histograms.
            # A side already hash-partitioned by its join key keeps the
            # uniform default: its shuffle would be *elided* (§3.7's
            # C_shuffle = 0 case), so charging a straggler — or salting,
            # which un-elides the exchange — would regress exactly the
            # plans the elision optimizes.
            if left.table.partitioned_by != lk:
                lstats = lstats.with_skew(
                    key_skew(left.table, lk, self.p, self.skew_floor))
            if right.table.partitioned_by != rk:
                rstats = rstats.with_skew(
                    key_skew(right.table, rk, self.p, self.skew_floor))
        with obs.span(obs.SELECT):
            sel = self.strategy.select(lstats, rstats, props, self.p)
            sel = self._engine_feasible(sel, lstats, rstats, props)
        if self.verify:
            # Pre-run cost audit (C1/C2/S1): a bad selection is caught
            # before any bytes move.
            self._gate(lambda: audit_selection(sel, lstats, rstats, props,
                                               self._params))
        out, rep = self._run_join_with_retry(sel, left.table, right.table,
                                             lk, rk, join_type.value)
        if self.compact:
            out = compact_partitions(out)
        if self.verify:
            # Post-run exchange audit (E1/E2): every elision proven
            # necessary, every proven partitioning actually elided.
            self._gate(lambda: audit_exchanges(sel, props, rep))
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
        # (The salted method needs no twin guard: selection only emits it
        # when the A role sits on the plan's left — the side the engine
        # actually salts.)
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
