"""SQL layer of the port: logical plans, the synthetic TPC-DS-like
workload, the paper's selection strategies, runtime filters and the
adaptive stage-wise executor."""

from .datagen import (Catalog, catalog_fingerprint, catalog_from_numpy,
                      generate, payload_from_numpy)
from .executor import (CardinalityRecord, ExecutionResult, Executor,
                       FilterDecision, JoinDecision)
from .logical import (Aggregate, Filter, Join, Node, Project, Scan,
                      filter_chain, signature)
from .queries import all_queries, filtered_queries
from .runtime_filters import FilterCache
from .strategies import (AQEStrategy, FilteredStrategy, ForcedStrategy,
                         RelJoinStrategy, Strategy, default_strategies)

__all__ = ["Catalog", "catalog_fingerprint", "catalog_from_numpy",
           "generate", "payload_from_numpy", "CardinalityRecord",
           "ExecutionResult", "Executor", "FilterDecision", "JoinDecision",
           "Aggregate", "Filter", "Join", "Node", "Project", "Scan",
           "filter_chain", "signature", "all_queries", "filtered_queries",
           "FilterCache",
           "AQEStrategy", "FilteredStrategy", "ForcedStrategy",
           "RelJoinStrategy", "Strategy", "default_strategies"]
