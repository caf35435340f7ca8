"""SQL layer of the port: logical plans, the synthetic TPC-DS-like
workload, the paper's selection strategies and the adaptive stage-wise
executor (main path)."""

from .datagen import Catalog, catalog_fingerprint, catalog_from_numpy, generate
from .executor import (CardinalityRecord, ExecutionResult, Executor,
                       JoinDecision)
from .logical import (Aggregate, Filter, Join, Node, Project, Scan,
                      filter_chain, signature)
from .queries import all_queries
from .strategies import (AQEStrategy, ForcedStrategy, RelJoinStrategy,
                         Strategy, default_strategies)

__all__ = ["Catalog", "catalog_fingerprint", "catalog_from_numpy",
           "generate", "CardinalityRecord", "ExecutionResult", "Executor",
           "JoinDecision", "Aggregate", "Filter", "Join", "Node", "Project",
           "Scan", "filter_chain", "signature", "all_queries", "AQEStrategy",
           "ForcedStrategy", "RelJoinStrategy", "Strategy",
           "default_strategies"]
