"""Distributed join engine on torch tensors: columnar tables, exchanges,
local join algorithms, the physical distributed join methods (salted
shuffle hash and the nested-loop family included), the hypercube multi-way
join, group-by aggregation, and the distributed twins of the methods and
the filter builds on ``torch.distributed``."""

from .aggregate import global_aggregate, group_aggregate
from .distributed import (JoinMesh, WireStats, cube_axis_names,
                          dist_bloom_build, dist_broadcast_hash_join,
                          dist_hypercube_join, dist_key_set_build,
                          dist_shuffle_hash_join, dist_shuffle_sort_join,
                          dist_zone_map_build, make_cube_mesh, make_join_mesh,
                          place, place_cube)
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
    "global_aggregate", "group_aggregate", "JoinMesh", "WireStats",
    "cube_axis_names", "dist_bloom_build", "dist_broadcast_hash_join",
    "dist_hypercube_join", "dist_key_set_build", "dist_shuffle_hash_join",
    "dist_shuffle_sort_join", "dist_zone_map_build", "make_cube_mesh",
    "make_join_mesh", "place", "place_cube", "ExchangeReport", "broadcast",
    "hypercube_shuffle", "key_skew", "salted_shuffle", "shuffle",
    "HypercubeLink", "HypercubeSpec", "JoinReport",
    "hypercube_multiway_join", "broadcast_hash_join", "broadcast_nl_join",
    "cartesian_join", "run_equi_join",
    "salted_shuffle_hash_join", "shuffle_hash_join", "shuffle_sort_join",
    "Table",
    "compact_partitions", "concat_partitions", "from_numpy",
    "partition_round_robin", "resolve_device",
]
