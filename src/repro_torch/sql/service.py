"""Concurrent query service: N queries, one catalog, shared work.

The production regime the ROADMAP targets is many simultaneous queries,
not one fast query. ``QueryService`` admits a set of queries (SQL text or
logical plans) against one catalog and executes them as a batch,
amortizing work four ways:

  1. **Plan cache** (``planner.PlanCache``) — compiled plans keyed on
     ``logical.signature()`` + every optimize() knob, bound to the catalog
     identity fingerprint exactly like ``FilterCache``. A warm submission
     skips the whole rewrite + System-R DP pass.
  2. **Cross-query CSE** — identical exchange-rooted subtrees (Join /
     Aggregate, enumerated by ``logical.shared_subtree_candidates``) are
     deduped by subtree signature: each shared subtree executes **once**
     per batch and its materialized table fans out to every consumer via
     the Executor's ``intermediates`` injection. Fan-out is aliasing, not
     copying: every operator derives new tensors and none writes an input
     in place, so one table can feed many consumers.
  3. **Shared FilterCache** — one cross-query ``FilterCache`` spans the
     batch, so a filter payload built for one query's edge is reused by
     every later query with the same build leaf.
  4. **Admission control** — submissions queue through a deque and
     batches form under a cost budget quoted by
     ``planner.modeled_plan_cost`` — the RelJoin cost model's static
     workload estimate, comparable across queries on the same catalog.

Correctness contract: per-query results are identical to solo execution
(``execute_solo``). CSE only dedupes occurrences that solo execution
evaluates as a self-contained exchange boundary (the region-atomicity
rule in ``shared_subtree_candidates``), runtime filters never change
result rows, and the service optimizes with ``prune=False`` — projection
pruning narrows scans per *whole-plan* column sets, which would make
structurally-shared subtrees signature-distinct (the classic CSE /
column-pruning tension; a shared subtree must carry every column any
consumer needs).

Run ``python -m repro_torch.sql.service`` (on the CUDA card; ``--device
cpu`` for the CPU) for the standalone pass: the service suite (q19-q23 +
the deliberately-overlapping q33/q34) executes batched with ``verify=True``
plan-analysis gates armed on every plan, and every query's rows are
checked against its solo run.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Tuple, Union

import torch

from .. import obs
from ..core.cost_model import CostParams
from ..joins.table import Table
from .binder import parse_sql
from .datagen import Catalog
from .executor import ExecutionResult, Executor
from .logical import Node, shared_subtree_candidates, subtree_size
from .planner import (OptimizedPlan, PlanCache, catalog_base_stats,
                      catalog_schema, modeled_plan_cost, optimize)
from .runtime_filters import FilterCache
from .strategies import FilteredStrategy, RelJoinStrategy, Strategy

#: Admission policies: ``fifo`` preserves submission order; ``cost``
#: stably reorders each batch cheapest-quote-first (small interactive
#: queries are not stuck behind a scan-heavy report).
ADMISSION_POLICIES = ("fifo", "cost")


@dataclasses.dataclass
class Submission:
    """One admitted query: its compiled plan + admission metadata."""

    qid: int
    name: str
    plan: Node                 # logical plan as submitted (pre-rewrite)
    optimized: OptimizedPlan   # compiled plan (possibly from the PlanCache)
    quoted_cost: float         # modeled_plan_cost — the admission quote
    plan_cached: bool          # True when optimize() was skipped entirely


@dataclasses.dataclass
class SharedSubtree:
    """One deduped subtree: executed once, fanned out to its consumers."""

    sig: str
    node: Node
    consumers: Tuple[str, ...]  # query names containing the subtree
    occurrences: int            # total occurrences across the batch (>= 2)
    result: ExecutionResult     # the single producer execution


@dataclasses.dataclass
class BatchReport:
    """Everything one batch did: per-query results + shared-work audit."""

    results: Dict[str, ExecutionResult]
    shared: List[SharedSubtree]
    wall_time_s: float   # host clock around work ending in a synchronize

    @property
    def total_network_bytes(self) -> float:
        """Suite wire traffic: every shared producer once + every consumer
        (whose injected subtrees moved zero bytes)."""
        return (sum(s.result.network_bytes for s in self.shared)
                + sum(r.network_bytes for r in self.results.values()))


class AdmissionController:
    """Cost-budgeted batch former over a deque admission queue.

    ``next_batch`` pops submissions while the batch's summed quotes stay
    within ``budget`` (None = unbounded: one batch takes everything). A
    single over-budget query is still admitted *alone* — a budget below
    every quote must not live-lock the queue. ``policy="cost"`` stably
    sorts the queue cheapest-first before popping; ``"fifo"`` preserves
    submission order.
    """

    def __init__(self, budget: Optional[float] = None,
                 policy: str = "fifo") -> None:
        if policy not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}; "
                             f"expected one of {ADMISSION_POLICIES}")
        self.budget = budget
        self.policy = policy
        self.queue: Deque[Submission] = collections.deque()

    def __len__(self) -> int:
        return len(self.queue)

    def submit(self, sub: Submission) -> None:
        self.queue.append(sub)

    def next_batch(self) -> List[Submission]:
        if self.policy == "cost" and len(self.queue) > 1:
            # Stable: equal quotes keep submission order.
            self.queue = collections.deque(
                sorted(self.queue, key=lambda s: s.quoted_cost))
        batch: List[Submission] = []
        spent = 0.0
        while self.queue:
            head = self.queue[0]
            if (batch and self.budget is not None
                    and spent + head.quoted_cost > self.budget):
                break
            batch.append(self.queue.popleft())
            spent += head.quoted_cost
        return batch


class QueryService:
    """Multi-tenant batched query execution against one catalog.

    ``submit()`` compiles (or plan-cache-fetches) each query and quotes
    its admission cost; ``run()`` drains the admission queue in budgeted
    batches, deduping shared subtrees per batch. ``execute_solo()`` is
    the reference path — one query, cold caches, same optimizer settings
    — that batched results are checked against.
    """

    def __init__(self, catalog: Catalog, *,
                 strategy: Optional[Strategy] = None,
                 cost_budget: Optional[float] = None,
                 policy: str = "fifo",
                 cse: bool = True,
                 verify: bool = False,
                 adaptive: bool = True) -> None:
        self.catalog = catalog
        # One FilterCache spans the batch: respect a cache the caller's
        # strategy already carries, otherwise own a fresh one.
        cache = getattr(strategy, "filter_cache", None)
        self.filter_cache: FilterCache = (cache if cache is not None
                                          else FilterCache())
        if strategy is None:
            strategy = FilteredStrategy(RelJoinStrategy(),
                                        cache=self.filter_cache)
        self.strategy = strategy
        self.plan_cache = PlanCache()
        self.cse = cse
        self.verify = verify
        self.adaptive = adaptive
        self.admission = AdmissionController(cost_budget, policy)
        self.device = next(iter(catalog.tables.values())).valid.device
        self._schema = catalog_schema(catalog)
        self._base_stats = catalog_base_stats(catalog)
        self._params = CostParams(p=catalog.p,
                                  w=getattr(strategy, "w", 1.0))
        self._qid = 0

    # -- admission -------------------------------------------------------------

    def submit(self, query: Union[str, Node],
               name: Optional[str] = None) -> Submission:
        """Admit one query (SQL text or logical plan): lower, compile (or
        hit the plan cache), quote, enqueue."""
        with obs.span(obs.SUBMIT):
            plan = parse_sql(query) if isinstance(query, str) else query
            hits_before = self.plan_cache.hits
            optimized = self._optimize(plan, plan_cache=self.plan_cache)
            with obs.span(obs.QUOTE):
                quote = modeled_plan_cost(optimized.plan, self._base_stats,
                                          self._schema, self._params,
                                          self.catalog.key_domains)
            sub = Submission(
                qid=self._qid,
                name=name if name is not None else f"q{self._qid}",
                plan=plan,
                optimized=optimized,
                quoted_cost=quote,
                plan_cached=self.plan_cache.hits > hits_before)
            self._qid += 1
            self.admission.submit(sub)
            return sub

    def _optimize(self, plan: Node,
                  plan_cache: Optional[PlanCache] = None) -> OptimizedPlan:
        # prune=False: projection pruning would specialize shared subtrees
        # per consumer column set and defeat CSE (module docstring).
        with obs.span(obs.OPTIMIZE):
            return optimize(plan, self.catalog, params=self._params,
                            prune=False, verify=self.verify,
                            plan_cache=plan_cache)

    def _executor(self, intermediates: Optional[Dict[str, Table]] = None
                  ) -> Executor:
        return Executor(self.catalog, self.strategy, adaptive=self.adaptive,
                        verify=True if self.verify else None,
                        intermediates=intermediates)

    # -- execution -------------------------------------------------------------

    def run(self) -> List[BatchReport]:
        """Drain the admission queue: one ``BatchReport`` per cost-budgeted
        batch, in admission order."""
        reports = []
        while len(self.admission):
            reports.append(self._execute_batch(self.admission.next_batch()))
        return reports

    def _execute_batch(self, batch: List[Submission]) -> BatchReport:
        with obs.span(obs.BATCH):
            t0 = time.perf_counter()
            intermediates: Dict[str, Table] = {}
            shared: List[SharedSubtree] = []
            if self.cse:
                # Count every candidate occurrence across the batch
                # (intra-query duplicates count too — two occurrences in one
                # plan still share).
                info: Dict[str, list] = {}
                with obs.span(obs.CSE):
                    for sub in batch:
                        for sig, node in shared_subtree_candidates(
                                sub.optimized.plan):
                            entry = info.setdefault(sig, [node, 0, []])
                            entry[1] += 1
                            if sub.name not in entry[2]:
                                entry[2].append(sub.name)
                shared_sigs = [s for s, e in info.items() if e[1] >= 2]
                # Producers run smallest-first so a shared subtree nested
                # inside a larger shared subtree is already injectable when
                # the larger one executes.
                for sig in sorted(shared_sigs,
                                  key=lambda s: subtree_size(info[s][0])):
                    node, count, consumers = info[sig]
                    res = self._executor(intermediates).execute(node)
                    intermediates[sig] = res.table
                    shared.append(SharedSubtree(sig, node, tuple(consumers),
                                                count, res))
            results: Dict[str, ExecutionResult] = {}
            for sub in batch:
                results[sub.name] = self._executor(intermediates).execute(
                    sub.optimized.plan)
            if self.device.type == "cuda":
                # The host clock reads the work done, not the work queued.
                with obs.sync("batch"):
                    torch.cuda.synchronize(self.device)
            return BatchReport(results, shared, time.perf_counter() - t0)

    def execute_solo(self, query: Union[str, Node]) -> ExecutionResult:
        """Reference single-query execution: same optimizer settings, but
        no plan cache, no injected intermediates, and a *fresh* FilterCache
        — the result batched execution must reproduce."""
        plan = parse_sql(query) if isinstance(query, str) else query
        optimized = self._optimize(plan)
        strategy = self.strategy
        if isinstance(strategy, FilteredStrategy):
            strategy = dataclasses.replace(strategy, cache=FilterCache())
        ex = Executor(self.catalog, strategy, adaptive=self.adaptive,
                      verify=True if self.verify else None)
        return ex.execute(optimized.plan)

    # -- stats publish ---------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        """Service-lifetime cache counters."""
        return {
            "plan_cache_hits": self.plan_cache.hits,
            "plan_cache_misses": self.plan_cache.misses,
            "plan_cache_size": len(self.plan_cache),
            "filter_cache_hits": self.filter_cache.hits,
            "filter_cache_misses": self.filter_cache.misses,
            "queries_submitted": self._qid,
        }


def main(argv=None) -> int:
    """Standalone pass: the service suite batched with verify gates armed
    on every executed plan, rows checked against solo runs, on the CUDA
    card unless ``--device`` names another."""
    import argparse

    from ..joins.ref import rows_as_set, rows_close
    from .datagen import generate
    from .queries import service_queries

    ap = argparse.ArgumentParser(
        description="the service suite batched against its solo runs")
    ap.add_argument("--device", default=None,
                    help="torch device of the catalog (default: the CUDA "
                         "card; there is no fallback when none is found)")
    args = ap.parse_args(argv)

    catalog = generate(scale=0.05, p=4, seed=11, device=args.device)
    service = QueryService(catalog, verify=True)
    queries = service_queries()
    for qname, plan in queries.items():
        service.submit(plan, name=qname)
    reports = service.run()
    if len(reports) != 1:
        raise RuntimeError("unbudgeted run should form one batch")
    report = reports[0]

    failures = []
    if not report.shared:
        failures.append("no shared subtrees deduped across the suite")
    serial_bytes = 0.0
    serial_joins = 0
    for qname in queries:
        solo = service.execute_solo(queries[qname])
        serial_bytes += solo.network_bytes
        serial_joins += len(solo.decisions)
        batched = report.results[qname]
        a = rows_as_set(solo.table.to_numpy())
        b = rows_as_set(batched.table.to_numpy())
        if not rows_close(a, b):
            failures.append(f"{qname}: batched rows differ from solo")
    batch_joins = (sum(len(s.result.decisions) for s in report.shared)
                   + sum(len(r.decisions) for r in report.results.values()))
    if batch_joins >= serial_joins:
        failures.append(f"dedup ran no fewer joins than serial "
                        f"({batch_joins} >= {serial_joins})")
    if report.total_network_bytes >= serial_bytes:
        failures.append(f"batched bytes not below serial "
                        f"({report.total_network_bytes:.0f} >= "
                        f"{serial_bytes:.0f})")
    print(f"service pass on {service.device}: {len(queries)} queries, "
          f"{len(report.shared)} shared subtrees, "
          f"{batch_joins}/{serial_joins} joins, "
          f"{report.total_network_bytes:.0f}/{serial_bytes:.0f} bytes, "
          f"stats={service.stats()}")
    for f in failures:
        print(f"FAIL: {f}")
    return 1 if failures else 0


__all__ = ["ADMISSION_POLICIES", "AdmissionController", "BatchReport",
           "QueryService", "SharedSubtree", "Submission", "main"]


if __name__ == "__main__":
    raise SystemExit(main())
