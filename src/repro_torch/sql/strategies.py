"""Join-method selection strategies evaluated in the paper (Table 3).

The ``name`` strings are the JAX package's, so results key the same way.
The skew-aware and reordering strategies come with later slices of the
port.
"""

from __future__ import annotations

import dataclasses

from ..core.cost_model import (BLOOM_DEFAULT_BITS_PER_KEY, CostParams,
                               JoinMethod)
from ..core.selection import (JoinProperties, Selection, select_absolute_size,
                              select_forced, select_join_method)
from ..core.stats import DEFAULT_WATERMARK_BYTES, TableStats
from .runtime_filters import DEFAULT_FILTER_KINDS, FilterCache


class Strategy:
    name: str = "base"

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
class FilteredStrategy(Strategy):
    """Wrapper adding runtime-filter pushdown to any baseline.

    Method selection is delegated to the wrapped strategy unchanged; the
    Executor, seeing ``runtime_filters=True``, additionally plans a runtime
    filter per join-graph edge (``planner.plan_runtime_filters``): every
    kind in ``kinds`` — bloom words, min/max zone map, exact semi-join key
    list — quotes the edge and the strictly cheapest wins. The filter is
    built from the build side's surviving join keys, applied to the probe
    relation's key column at the *leaf* — below every exchange the probe
    side later goes through — and only where the cost model prices the
    filtered join plus the filter's build + broadcast strictly below the
    unfiltered join. With every sigma estimate at 1 (no selective dimension
    predicate) nothing is planned and the wrapped strategy's selections are
    byte-identical.
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
    #: (default) keeps every run cold.
    cache: FilterCache | None = None

    def __post_init__(self):
        self.name = f"Filtered({self.inner.name})"
        self.runtime_filters = True
        self.filter_kinds = tuple(self.kinds)
        self.filter_cache = self.cache
        # Forward the wrapped strategy's executor-facing flags, so that a
        # wrapped strategy of a later slice reaches the executor's checks.
        self.reorder = getattr(self.inner, "reorder", False)
        self.skew_aware = getattr(self.inner, "skew_aware", False)
        self.verify = getattr(self.inner, "verify", False)
        self.reopt = getattr(self.inner, "reopt", False)
        self.w = getattr(self.inner, "w", 1.0)

    def select(self, left, right, props, p):
        return self.inner.select(left, right, props, p)


def default_strategies(w: float = 1.0):
    return [ForcedStrategy(JoinMethod.SHUFFLE_SORT),
            ForcedStrategy(JoinMethod.SHUFFLE_HASH),
            AQEStrategy(),
            RelJoinStrategy(w=w)]
