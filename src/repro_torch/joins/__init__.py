"""Distributed join engine on torch tensors: columnar tables, exchanges,
local join algorithms, the physical distributed equi-join methods and
group-by aggregation."""

from .aggregate import global_aggregate, group_aggregate
from .exchange import ExchangeReport, broadcast, shuffle
from .methods import (JoinReport, broadcast_hash_join, run_equi_join,
                      shuffle_hash_join, shuffle_sort_join)
from .table import (Table, compact_partitions, concat_partitions, from_numpy,
                    partition_round_robin, resolve_device)

__all__ = [
    "global_aggregate", "group_aggregate", "ExchangeReport", "broadcast",
    "shuffle", "JoinReport", "broadcast_hash_join", "run_equi_join",
    "shuffle_hash_join", "shuffle_sort_join", "Table", "compact_partitions",
    "concat_partitions", "from_numpy", "partition_round_robin",
    "resolve_device",
]
