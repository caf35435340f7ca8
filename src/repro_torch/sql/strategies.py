"""Join-method selection strategies evaluated in the paper (Table 3).

The ``name`` strings are the JAX package's, so results key the same way.
The skew-aware, reordering and runtime-filter strategies come with later
slices of the port.
"""

from __future__ import annotations

import dataclasses

from ..core.cost_model import CostParams, JoinMethod
from ..core.selection import (JoinProperties, Selection, select_absolute_size,
                              select_forced, select_join_method)
from ..core.stats import DEFAULT_WATERMARK_BYTES, TableStats


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


def default_strategies(w: float = 1.0):
    return [ForcedStrategy(JoinMethod.SHUFFLE_SORT),
            ForcedStrategy(JoinMethod.SHUFFLE_HASH),
            AQEStrategy(),
            RelJoinStrategy(w=w)]
