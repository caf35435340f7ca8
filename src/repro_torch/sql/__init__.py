"""SQL layer of the port: a SQL text front end (tokenizer, recursive-descent
parser, binder and pretty-printer), logical plans, the synthetic
TPC-DS-like workload, the paper's selection strategies, runtime filters,
the plan optimizer and the adaptive stage-wise executor."""

from .binder import SqlBindError, bind, parse_sql
from .datagen import (Catalog, catalog_fingerprint, catalog_from_numpy,
                      generate, payload_from_numpy)
from .executor import (CardinalityRecord, ExecutionResult, Executor,
                       FilterDecision, JoinDecision, ReoptDecision)
from .logical import (Aggregate, Filter, Join, Node, Project, Scan,
                      filter_chain, signature)
from .parser import SqlSyntaxError, parse, tokenize
from .plan_analysis import (RULES, PlanVerificationError, Rule, Violation,
                            analyze_plan, audit_join_decision,
                            verify_execution)
from .planner import OptimizedPlan, optimize
from .printer import to_sql
from .queries import (all_queries, cyclic_queries, every_query,
                      filtered_queries, misordered_queries, service_queries,
                      skewed_queries, text_queries)
from .runtime_filters import FilterCache
from .selectivity import derive_selectivity
from .strategies import (AQEStrategy, FilteredStrategy, ForcedStrategy,
                         RelJoinStrategy, ReorderingStrategy,
                         SkewAwareStrategy, Strategy, default_strategies)

__all__ = ["SqlBindError", "bind", "parse_sql", "SqlSyntaxError", "parse",
           "tokenize", "to_sql", "derive_selectivity",
           "Catalog", "catalog_fingerprint", "catalog_from_numpy",
           "generate", "payload_from_numpy", "CardinalityRecord",
           "ExecutionResult", "Executor", "FilterDecision", "JoinDecision",
           "ReoptDecision",
           "Aggregate", "Filter", "Join", "Node", "Project", "Scan",
           "filter_chain", "signature", "RULES", "PlanVerificationError",
           "Rule", "Violation", "analyze_plan", "audit_join_decision",
           "verify_execution", "OptimizedPlan", "optimize",
           "all_queries", "cyclic_queries", "every_query", "filtered_queries",
           "misordered_queries", "service_queries", "skewed_queries",
           "text_queries", "FilterCache", "AQEStrategy",
           "FilteredStrategy", "ForcedStrategy", "RelJoinStrategy",
           "ReorderingStrategy", "SkewAwareStrategy", "Strategy",
           "default_strategies"]
