"""RelJoin core: the paper's cost model, selection algorithm, adaptive
statistics, the PSTS metric, and the RelShard tensor-op planner that
applies the same cost model to sharded-LM collectives (``relshard``)."""

from .cost_model import (CostParams, JoinMethod, RANK, all_costs,
                         bloom_total_cost, broadcast_hash_cost,
                         broadcast_nl_cost, broadcast_preferred,
                         cached_filter_cost, cartesian_cost,
                         default_salt_factor, filter_reduce_cost,
                         k0_threshold, method_cost, relative_size,
                         salted_shuffle_hash_cost, semi_join_cost,
                         shuffle_hash_cost, shuffle_sort_cost,
                         zone_map_cost)
from .psts import (PSTSReport, compute_psts, distinct_count, key_set,
                   selections_differ, semi_join_mask)
from .selection import (AQE_BROADCAST_THRESHOLD_BYTES, INNER_LIKE,
                        JoinProperties, JoinType, Selection,
                        select_absolute_size, select_forced,
                        select_join_method)
from .stats import (DEFAULT_WATERMARK_BYTES, StatsSource, TableStats,
                    estimate_filter, estimate_group_by, estimate_join,
                    estimate_project, unknown_stats)

__all__ = [
    "CostParams", "JoinMethod", "RANK", "all_costs", "bloom_total_cost",
    "broadcast_hash_cost", "broadcast_nl_cost", "broadcast_preferred",
    "cached_filter_cost", "cartesian_cost", "default_salt_factor",
    "filter_reduce_cost", "k0_threshold", "method_cost", "relative_size",
    "salted_shuffle_hash_cost", "semi_join_cost", "shuffle_hash_cost",
    "shuffle_sort_cost", "zone_map_cost", "PSTSReport", "compute_psts",
    "distinct_count", "key_set", "selections_differ", "semi_join_mask",
    "AQE_BROADCAST_THRESHOLD_BYTES", "INNER_LIKE", "JoinProperties",
    "JoinType", "Selection", "select_absolute_size", "select_forced",
    "select_join_method", "DEFAULT_WATERMARK_BYTES", "StatsSource",
    "TableStats", "estimate_filter", "estimate_group_by", "estimate_join",
    "estimate_project", "unknown_stats",
]
