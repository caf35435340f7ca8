"""SQL layer of the port: logical plans, the synthetic TPC-DS-like
workload, the paper's selection strategies, runtime filters, the plan
optimizer and the adaptive stage-wise executor."""

from .datagen import (Catalog, catalog_fingerprint, catalog_from_numpy,
                      generate, payload_from_numpy)
from .executor import (CardinalityRecord, ExecutionResult, Executor,
                       FilterDecision, JoinDecision)
from .logical import (Aggregate, Filter, Join, Node, Project, Scan,
                      filter_chain, signature)
from .planner import OptimizedPlan, optimize
from .queries import (all_queries, cyclic_queries, every_query,
                      filtered_queries, misordered_queries)
from .runtime_filters import FilterCache
from .strategies import (AQEStrategy, FilteredStrategy, ForcedStrategy,
                         RelJoinStrategy, ReorderingStrategy, Strategy,
                         default_strategies)

__all__ = ["Catalog", "catalog_fingerprint", "catalog_from_numpy",
           "generate", "payload_from_numpy", "CardinalityRecord",
           "ExecutionResult", "Executor", "FilterDecision", "JoinDecision",
           "Aggregate", "Filter", "Join", "Node", "Project", "Scan",
           "filter_chain", "signature", "OptimizedPlan", "optimize",
           "all_queries", "cyclic_queries", "every_query", "filtered_queries",
           "misordered_queries", "FilterCache", "AQEStrategy",
           "FilteredStrategy", "ForcedStrategy", "RelJoinStrategy",
           "ReorderingStrategy", "Strategy", "default_strategies"]
