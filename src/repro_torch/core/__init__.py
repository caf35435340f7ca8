"""RelJoin core: the paper's cost model, selection algorithm and adaptive
statistics (pure Python, shared in content with the JAX package)."""

from .cost_model import (CostParams, JoinMethod, RANK, all_costs,
                         broadcast_hash_cost, k0_threshold, method_cost,
                         relative_size, shuffle_hash_cost, shuffle_sort_cost)
from .selection import (AQE_BROADCAST_THRESHOLD_BYTES, INNER_LIKE,
                        JoinProperties, JoinType, Selection,
                        select_absolute_size, select_forced,
                        select_join_method)
from .stats import (DEFAULT_WATERMARK_BYTES, StatsSource, TableStats,
                    estimate_filter, estimate_group_by, estimate_join,
                    estimate_project, unknown_stats)

__all__ = [
    "CostParams", "JoinMethod", "RANK", "all_costs", "broadcast_hash_cost",
    "k0_threshold", "method_cost", "relative_size", "shuffle_hash_cost",
    "shuffle_sort_cost", "AQE_BROADCAST_THRESHOLD_BYTES", "INNER_LIKE",
    "JoinProperties", "JoinType", "Selection", "select_absolute_size",
    "select_forced", "select_join_method", "DEFAULT_WATERMARK_BYTES",
    "StatsSource", "TableStats", "estimate_filter", "estimate_group_by",
    "estimate_join", "estimate_project", "unknown_stats",
]
