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

This is the main path: the written join order, no runtime filters, skew
measurement, plan verification, re-optimization or shared intermediates.
Those come with later slices of the port and raise ``NotImplementedError``
here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from ..core.cost_model import JoinMethod
from ..core.selection import JoinProperties, JoinType, Selection
from ..core.stats import (StatsSource, TableStats, estimate_filter,
                          estimate_group_by, estimate_join, q_error)
from ..joins.aggregate import group_aggregate
from ..joins.methods import JoinReport, run_equi_join
from ..joins.table import Table, compact_partitions
from .datagen import Catalog
from .logical import Aggregate, Filter, Join, Node, Project, Scan
from .planner import semi_match_fraction, stats_retain_fraction
from .selectivity import derive_selectivity
from .strategies import Strategy

#: Executor features of later slices: (strategy flag, slice that brings it).
_LATER_SLICES = (("reorder", "reordering"), ("skew_aware", "skew"),
                 ("runtime_filters", "runtime-filter"),
                 ("verify", "plan-verification"), ("reopt", "re-optimization"))


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
    #: Estimated-vs-measured cardinality at every join/aggregate boundary.
    cardinalities: List[CardinalityRecord] = dataclasses.field(
        default_factory=list)

    def methods(self):
        return [d.selection.method for d in self.decisions]

    def workload(self, w: float = 1.0) -> float:
        """Measured cluster workload under the paper's weighting."""
        return w * self.network_bytes + self.local_bytes


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

    # -- public ---------------------------------------------------------------

    def execute(self, plan: Node) -> ExecutionResult:
        self._decisions: List[JoinDecision] = []
        self._cards: List[CardinalityRecord] = []
        t0 = time.perf_counter()
        ann = self._eval(plan)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        net = sum(d.network_bytes for d in self._decisions)
        loc = sum(d.local_bytes for d in self._decisions)
        strag = sum(d.straggler_bytes for d in self._decisions)
        return ExecutionResult(ann.table, self._decisions, dt, net, loc,
                               ann.table.count(), straggler_bytes=strag,
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
            left = self._eval(node.left)
            right = self._eval(node.right)
            # Exchange boundary: re-measure both inputs (adaptive runtime
            # statistics). Non-adaptive mode keeps static estimates.
            lstats = self._boundary_stats(left, node.left)
            rstats = self._boundary_stats(right, node.right)
            return self._join(left, right, lstats, rstats, node.left_key,
                              node.right_key, node.join_type, node.hint,
                              retain=self._retain(node.right))

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
