"""Distributed join engine on torch tensors: columnar tables, exchanges,
local join algorithms, the physical distributed join methods (salted
shuffle hash and the nested-loop family included), the hypercube multi-way
join and group-by aggregation."""

from .aggregate import global_aggregate, group_aggregate
from .exchange import (ExchangeReport, broadcast, hypercube_shuffle,
                       key_skew, salted_shuffle, shuffle)
from .methods import (HypercubeLink, HypercubeSpec, JoinReport,
                      broadcast_hash_join, broadcast_nl_join, cartesian_join,
                      hypercube_multiway_join, run_equi_join,
                      salted_shuffle_hash_join, shuffle_hash_join,
                      shuffle_sort_join)
from .table import (Table, compact_partitions, concat_partitions, from_numpy,
                    partition_round_robin, resolve_device)

__all__ = [
    "global_aggregate", "group_aggregate", "ExchangeReport", "broadcast",
    "hypercube_shuffle", "key_skew", "salted_shuffle", "shuffle",
    "HypercubeLink", "HypercubeSpec", "JoinReport",
    "hypercube_multiway_join", "broadcast_hash_join", "broadcast_nl_join",
    "cartesian_join", "run_equi_join",
    "salted_shuffle_hash_join", "shuffle_hash_join", "shuffle_sort_join",
    "Table",
    "compact_partitions", "concat_partitions", "from_numpy",
    "partition_round_robin", "resolve_device",
]
