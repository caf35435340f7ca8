"""Join-method selection strategies evaluated in the paper (Table 3), the
skew-aware extension and the reordering and runtime-filter wrappers.

The ``name`` strings are the JAX package's, so results key the same way.
"""

from __future__ import annotations

import dataclasses

from ..core.cost_model import (BLOOM_DEFAULT_BITS_PER_KEY,
                               DEFAULT_REOPT_QERROR, CostParams, JoinMethod)
from ..core.selection import (JoinProperties, Selection, select_absolute_size,
                              select_forced, select_join_method)
from ..core.stats import DEFAULT_WATERMARK_BYTES, TableStats
from .runtime_filters import DEFAULT_FILTER_KINDS, FilterCache


class Strategy:
    name: str = "base"
    #: When True the Executor runs the planner: pushdown + pruning rewrites
    #: and adaptive cost-based join reordering (System-R DP per region).
    reorder: bool = False
    #: When True the Executor measures the join-key partition skew of both
    #: inputs at every exchange boundary (partition_hist histograms) and
    #: attaches it to the runtime statistics, enabling the straggler-aware
    #: costs and the salted shuffle method.
    skew_aware: bool = False
    #: When True the Executor plans runtime-filter pushdown: build a filter
    #: (cheapest applicable kind — bloom / zone map / semi-join) over the
    #: build side's join keys at its exchange boundary and apply it to the
    #: probe side *below* its exchanges, wherever the cost model says the
    #: filtered join plus the filter's build + broadcast is strictly
    #: cheaper.
    runtime_filters: bool = False
    #: When True the Executor arms the plan-analysis debug gates: every
    #: plan (including adaptive re-plans and runtime-filter placements) is
    #: verified against the static rule set before/while running, and any
    #: violation raises ``PlanVerificationError`` naming the rule.
    verify: bool = False
    #: When True the Executor checkpoints every region exchange boundary:
    #: the materialized intermediate's measured cardinality is audited
    #: against the optimizer's prediction, and past ``reopt_qerror`` the
    #: measured stats are folded into the remaining join graph and the
    #: System-R DP re-runs on the remainder (mid-query re-optimization).
    reopt: bool = False
    #: q-error threshold arming the checkpoint above.
    reopt_qerror: float = DEFAULT_REOPT_QERROR

    def select(self, left: TableStats, right: TableStats,
               props: JoinProperties, p: int) -> Selection:
        raise NotImplementedError


@dataclasses.dataclass
class RelJoinStrategy(Strategy):
    """The paper's strategy: Algorithm 1 on adaptive runtime statistics."""

    w: float = 1.0
    watermark_bytes: float = DEFAULT_WATERMARK_BYTES

    def __post_init__(self):
        self.name = f"RelJoin(w={self.w:g})"

    def select(self, left, right, props, p):
        return select_join_method(left, right, props, CostParams(p=p, w=self.w),
                                  watermark_bytes=self.watermark_bytes)


@dataclasses.dataclass
class SkewAwareStrategy(Strategy):
    """RelJoin's Algorithm 1 on skew-annotated runtime statistics.

    Method selection is exactly :func:`select_join_method`; the difference
    is in the statistics: the Executor, seeing ``skew_aware=True``, measures
    the join-key straggler factor s = max/mean partition load of both inputs
    at every exchange boundary. Shuffle-family costs then inflate by s,
    which (a) shifts the broadcast/shuffle threshold to k0(s) and (b) lets
    the SALTED_SHUFFLE_HASH method win when plain shuffle would straggle.
    At s = 1 (uniform keys, or fluctuation below ``skew_floor``) every
    selection is byte-for-byte the one RelJoinStrategy makes.
    """

    w: float = 1.0
    watermark_bytes: float = DEFAULT_WATERMARK_BYTES
    #: Measured skew below this is hashing noise and snaps to 1.0.
    skew_floor: float = 1.1

    def __post_init__(self):
        self.name = f"SkewAware(w={self.w:g})"
        self.skew_aware = True

    def select(self, left, right, props, p):
        return select_join_method(left, right, props, CostParams(p=p, w=self.w),
                                  watermark_bytes=self.watermark_bytes)


@dataclasses.dataclass
class AQEStrategy(Strategy):
    """Spark AQE: absolute-size broadcast criterion on adaptive stats."""

    threshold_bytes: float = 10 * 1024 ** 2
    prefer_sort: bool = True

    def __post_init__(self):
        self.name = "AQE"

    def select(self, left, right, props, p):
        return select_absolute_size(left, right, props, self.threshold_bytes,
                                    self.prefer_sort)


@dataclasses.dataclass
class ForcedStrategy(Strategy):
    """ShuffleSort / ShuffleHash forced via hint (paper Table 3)."""

    method: JoinMethod = JoinMethod.SHUFFLE_SORT

    def __post_init__(self):
        self.name = ("ShuffleSort" if self.method is JoinMethod.SHUFFLE_SORT
                     else "ShuffleHash")

    def select(self, left, right, props, p):
        return select_forced(self.method, left, right, props)


@dataclasses.dataclass
class ReorderingStrategy(Strategy):
    """Wrapper adding plan-space search to any baseline.

    Method selection is delegated to the wrapped strategy unchanged; the
    Executor, seeing ``reorder=True``, additionally runs predicate pushdown,
    projection pruning, and the System-R DP join reordering (scored with the
    RelJoin cost model at weight ``w``) with adaptive re-planning at every
    exchange boundary, and quotes the hypercube multi-way join for cyclic
    regions.
    """

    inner: Strategy = dataclasses.field(default_factory=lambda:
                                        RelJoinStrategy())
    #: Workload weight for the ordering DP; None inherits the wrapped
    #: strategy's w (when it has one) so the DP optimizes the same
    #: objective the per-join selections use.
    w: float | None = None
    #: Checkpoint mid-query re-optimization (see ``Strategy.reopt``); a
    #: reordering concern, so the knob lives on this wrapper.
    reopt: bool = False
    reopt_qerror: float = DEFAULT_REOPT_QERROR

    def __post_init__(self):
        self.name = f"Reorder({self.inner.name})"
        if self.reopt:
            self.name += "+reopt"
        self.reorder = True
        # Forward the wrapped strategy's executor-facing flags: without
        # these, Reorder(SkewAware(...)) would silently lose skew handling
        # and Reorder(Filtered(...)) its runtime-filter pushdown.
        self.skew_aware = getattr(self.inner, "skew_aware", False)
        self.skew_floor = getattr(self.inner, "skew_floor", 1.1)
        self.runtime_filters = getattr(self.inner, "runtime_filters", False)
        self.bits_per_key = getattr(self.inner, "bits_per_key",
                                    BLOOM_DEFAULT_BITS_PER_KEY)
        self.filter_kinds = getattr(self.inner, "filter_kinds",
                                    DEFAULT_FILTER_KINDS)
        self.filter_cache = getattr(self.inner, "filter_cache", None)
        self.verify = getattr(self.inner, "verify", False)
        if self.w is None:
            self.w = getattr(self.inner, "w", 1.0)

    def select(self, left, right, props, p):
        return self.inner.select(left, right, props, p)


@dataclasses.dataclass
class FilteredStrategy(Strategy):
    """Wrapper adding runtime-filter pushdown to any baseline.

    Method selection is delegated to the wrapped strategy unchanged; the
    Executor, seeing ``runtime_filters=True``, additionally plans a runtime
    filter per join-graph edge (``planner.plan_runtime_filters``): every
    kind in ``kinds`` — bloom words, min/max zone map, exact semi-join key
    list — quotes the edge and the strictly cheapest wins. The filter is
    built from the build side's surviving join keys at its exchange
    boundary, applied to the probe relation's key column at the *leaf* —
    below every exchange the probe side later goes through — and only
    where the cost model prices the filtered join plus the filter's build
    + broadcast strictly below the unfiltered join. With every sigma
    estimate at 1 (no selective dimension predicate) nothing is planned
    and the wrapped strategy's selections are byte-identical.
    """

    inner: Strategy = dataclasses.field(default_factory=lambda:
                                        RelJoinStrategy())
    #: Bloom budget: bits per distinct build-side key (m is the next power
    #: of two; k the optimal ln2 * m/n).
    bits_per_key: int = BLOOM_DEFAULT_BITS_PER_KEY
    #: Reducer kinds the planner may quote, in tie-break order.
    #: ``("bloom",)`` restricts the framework to bloom-only quoting.
    kinds: tuple = DEFAULT_FILTER_KINDS
    #: Cross-query ``FilterCache`` shared across Executor instances: built
    #: payloads are reused on later queries against the same catalog, and
    #: cache-hit edges are quoted without the build + reduce terms. None
    #: (default) keeps every run cold — byte-identical to the uncached
    #: planner.
    cache: FilterCache | None = None

    def __post_init__(self):
        self.name = f"Filtered({self.inner.name})"
        self.runtime_filters = True
        self.filter_kinds = tuple(self.kinds)
        self.filter_cache = self.cache
        # Forward the wrapped strategy's executor-facing flags so
        # Filtered(Reorder(...)) / Filtered(SkewAware(...)) compose.
        self.reorder = getattr(self.inner, "reorder", False)
        self.skew_aware = getattr(self.inner, "skew_aware", False)
        self.skew_floor = getattr(self.inner, "skew_floor", 1.1)
        self.verify = getattr(self.inner, "verify", False)
        self.reopt = getattr(self.inner, "reopt", False)
        self.reopt_qerror = getattr(self.inner, "reopt_qerror",
                                    DEFAULT_REOPT_QERROR)
        self.w = getattr(self.inner, "w", 1.0)

    def select(self, left, right, props, p):
        return self.inner.select(left, right, props, p)


def default_strategies(w: float = 1.0):
    return [ForcedStrategy(JoinMethod.SHUFFLE_SORT),
            ForcedStrategy(JoinMethod.SHUFFLE_HASH),
            AQEStrategy(),
            RelJoinStrategy(w=w)]
