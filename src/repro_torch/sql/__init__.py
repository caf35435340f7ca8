"""SQL layer of the port: a SQL text front end (tokenizer, recursive-descent
parser, binder and pretty-printer), logical plans, the synthetic
TPC-DS-like workload, the paper's selection strategies, runtime filters,
the plan optimizer (with its cross-query plan cache), the adaptive
stage-wise executor and the concurrent query service."""

from .binder import SqlBindError, bind, parse_sql
from .datagen import (Catalog, catalog_fingerprint, catalog_from_numpy,
                      generate, payload_from_numpy)
from .executor import (CardinalityRecord, ExecutionResult, Executor,
                       FilterDecision, JoinDecision, ReoptDecision)
from .logical import (Aggregate, Filter, Join, Node, Project, Scan,
                      filter_chain, shared_subtree_candidates, signature,
                      subtree_size)
from .parser import SqlSyntaxError, parse, tokenize
from .plan_analysis import (RULES, PlanVerificationError, Rule, Violation,
                            analyze_plan, audit_join_decision,
                            verify_execution)
from .planner import OptimizedPlan, PlanCache, modeled_plan_cost, optimize
from .printer import to_sql
from .queries import (all_queries, cyclic_queries, every_query,
                      filtered_queries, misordered_queries, service_queries,
                      skewed_queries, text_queries)
from .runtime_filters import FilterCache
from .selectivity import derive_selectivity
from .service import (ADMISSION_POLICIES, AdmissionController, BatchReport,
                      QueryService, SharedSubtree, Submission)
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
           "filter_chain", "shared_subtree_candidates", "signature",
           "subtree_size", "RULES", "PlanVerificationError",
           "Rule", "Violation", "analyze_plan", "audit_join_decision",
           "verify_execution", "OptimizedPlan", "PlanCache",
           "modeled_plan_cost", "optimize",
           "all_queries", "cyclic_queries", "every_query", "filtered_queries",
           "misordered_queries", "service_queries", "skewed_queries",
           "text_queries", "FilterCache", "ADMISSION_POLICIES",
           "AdmissionController", "BatchReport", "QueryService",
           "SharedSubtree", "Submission", "AQEStrategy",
           "FilteredStrategy", "ForcedStrategy", "RelJoinStrategy",
           "ReorderingStrategy", "SkewAwareStrategy", "Strategy",
           "default_strategies"]
