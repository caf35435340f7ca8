"""The port's query service against the JAX package's, on the CPU: every
case of the reference's ``tests/test_service.py``.

One module-scoped batch per package runs the service suite (q19-q23 + the
deliberately-overlapping q33/q34) through ``QueryService(catalog,
verify=True)`` on catalogs made from one seed (``generate(0.1, 4, 42)``).
The port's batch must equal the reference's: the shared subtrees (their
signatures, consumers, occurrences and producer runs), every query's
decisions and network bytes exactly, its rows within ``rows_close``
(float sums differ in order), the quotes to a relative 1e-9 (the same
float computation on the same statistics) and the cache counters. The
admission, plan-cache and candidate cases run on both packages and
compare what they return.

Fan-out aliases one table to many consumers; tensors are mutable, so the
port's batch records every injected table's tensors before its first
consumer runs and the tests require them unchanged after the batch.
"""

import pytest

from repro.joins.ref import rows_as_set, rows_close
from repro.sql import AdmissionController as JAdmissionController
from repro.sql import PlanCache as JPlanCache
from repro.sql import QueryService as JQueryService
from repro.sql import Submission as JSubmission
from repro.sql import generate as j_generate
from repro.sql import optimize as j_optimize
from repro.sql import service_queries as j_service_queries
from repro.sql import shared_subtree_candidates as j_candidates
from repro.sql.logical import Aggregate as JAggregate
from repro.sql.logical import Join as JJoin
from repro.sql.logical import Scan as JScan
from repro.sql.logical import signature as j_signature
from repro_torch.sql import (ADMISSION_POLICIES, AdmissionController,
                             Aggregate, Join, PlanCache, QueryService, Scan,
                             Submission, generate, optimize, parse_sql,
                             service_queries, shared_subtree_candidates,
                             signature)
from repro_torch.sql.queries import SQL_TEXTS

PAIR19 = frozenset(("q19_filtered_customer", "q33_shared_customer_join"))
PAIR22 = frozenset(("q22_zone_map_window", "q34_shared_window_join"))


def _rows(res):
    return rows_as_set(res.table.to_numpy())


def _decisions(res):
    return [(d.selection.method.value, bool(d.selection.swapped_sides))
            for d in res.decisions]


def _sub(qid, cost, jax=False):
    """Minimal Submission for admission-only tests (no compiled plan)."""
    return (JSubmission if jax else Submission)(
        qid=qid, name=f"q{qid}", plan=None, optimized=None,
        quoted_cost=cost, plan_cached=False)


def _snapshot(table):
    return ({n: c.clone() for n, c in table.columns.items()},
            table.valid.clone(), table.partitioned_by)


@pytest.fixture(scope="module")
def port_catalog():
    return generate(0.1, 4, 42, device="cpu")


@pytest.fixture(scope="module")
def jax_batch(catalog):
    """(service, submissions, batch report) of the reference."""
    service = JQueryService(catalog, verify=True)
    subs = {q: service.submit(plan, name=q)
            for q, plan in j_service_queries().items()}
    reports = service.run()
    assert len(reports) == 1
    return service, subs, reports[0]


@pytest.fixture(scope="module")
def port_batch(port_catalog):
    """(service, submissions, batch report, solo runs, injected tables)
    of the port. Every table the batch injects is recorded, with a copy of
    its tensors, when it first reaches an executor: after its producer
    ran and before any consumer did."""
    service = QueryService(port_catalog, verify=True)
    injected = {}
    make = service._executor

    def spy(intermediates=None):
        for sig, table in (intermediates or {}).items():
            injected.setdefault(sig, (table, _snapshot(table)))
        return make(intermediates)

    service._executor = spy
    queries = service_queries()
    subs = {q: service.submit(plan, name=q) for q, plan in queries.items()}
    reports = service.run()
    assert len(reports) == 1
    solos = {q: service.execute_solo(plan) for q, plan in queries.items()}
    return service, subs, reports[0], solos, injected


# ---------------------------------------------------------------------------
# Correctness: batched == solo == the reference's batch
# ---------------------------------------------------------------------------


def test_batched_rows_identical_to_solo(port_batch, jax_batch):
    _, _, report, solos, _ = port_batch
    jreport = jax_batch[2]
    assert sorted(report.results) == sorted(jreport.results)
    for qname, solo in solos.items():
        got = _rows(report.results[qname])
        assert rows_close(got, _rows(solo)), qname
        assert rows_close(got, _rows(jreport.results[qname])), qname


@pytest.mark.parametrize("query", sorted(j_service_queries()))
def test_batched_run_equals_reference(port_batch, jax_batch, query):
    """Per query: the decisions, network/local bytes, row count and
    runtime filters of the reference's batched run."""
    got = port_batch[2].results[query]
    want = jax_batch[2].results[query]
    assert _decisions(got) == _decisions(want)
    assert got.network_bytes == want.network_bytes
    assert got.local_bytes == want.local_bytes
    assert got.rows == want.rows
    assert ([(f.plan.kind, f.rows_before, f.rows_after, f.cached)
             for f in got.filters]
            == [(f.plan.kind, f.rows_before, f.rows_after, f.cached)
                for f in want.filters])


def test_shared_subtrees_executed_exactly_once(port_batch, jax_batch):
    """q33 duplicates q19's join and q34 duplicates q22's: each shared
    subtree gets exactly one producer execution, and its consumers run
    zero joins of their own for it (the injected table replaces them).
    The shared subtrees, their order and producer runs are the
    reference's."""
    _, _, report, solos, _ = port_batch
    jreport = jax_batch[2]
    assert ([(s.sig, s.consumers, s.occurrences) for s in report.shared]
            == [(s.sig, s.consumers, s.occurrences) for s in jreport.shared])
    for s, js in zip(report.shared, jreport.shared):
        assert _decisions(s.result) == _decisions(js.result)
        assert s.result.network_bytes == js.result.network_bytes
        assert rows_close(_rows(s.result), _rows(js.result))
    by_consumers = {frozenset(s.consumers): s for s in report.shared}
    assert PAIR19 in by_consumers and PAIR22 in by_consumers
    for s in report.shared:
        assert s.occurrences >= 2
    sigs = [s.sig for s in report.shared]
    assert len(sigs) == len(set(sigs))
    for qname in PAIR19 | PAIR22:
        assert len(report.results[qname].decisions) == 0, qname
        assert report.results[qname].network_bytes == 0.0, qname
    batch_joins = (sum(len(s.result.decisions) for s in report.shared)
                   + sum(len(r.decisions) for r in report.results.values()))
    serial_joins = sum(len(r.decisions) for r in solos.values())
    assert batch_joins < serial_joins


def test_suite_bytes_strictly_below_serial(port_batch, jax_batch):
    _, _, report, solos, _ = port_batch
    assert report.total_network_bytes == jax_batch[2].total_network_bytes
    serial = sum(r.network_bytes for r in solos.values())
    assert report.total_network_bytes < serial


def test_injected_tables_unchanged_by_their_consumers(port_batch):
    """Every injected table's tensors and attributes are those its
    producer left, after all of its consumers ran."""
    _, _, report, _, injected = port_batch
    assert sorted(injected) == sorted(s.sig for s in report.shared)
    for s in report.shared:
        table, (cols, valid, part) = injected[s.sig]
        assert table is s.result.table
        assert sorted(table.columns) == sorted(cols), s.sig
        assert table.partitioned_by == part
        assert table.valid.equal(valid), s.sig
        for name, col in cols.items():
            assert table.columns[name].dtype == col.dtype
            assert table.columns[name].equal(col), (s.sig, name)


def test_stats_publish(port_batch, jax_batch):
    service, subs, _, _, _ = port_batch
    stats = service.stats()
    assert stats == jax_batch[0].stats()
    assert stats["queries_submitted"] >= len(subs)
    assert stats["plan_cache_misses"] >= len(subs)
    assert stats["plan_cache_size"] == len(service.plan_cache)


# ---------------------------------------------------------------------------
# Subtree-candidate enumeration (region atomicity)
# ---------------------------------------------------------------------------


def test_candidates_are_exchange_rooted_and_region_atomic():
    """Only Join/Aggregate roots are candidates, and an inner join nested
    directly under another hint-free inner join is NOT one: solo execution
    dissolves it into the parent's region. The candidates' signatures are
    the reference's."""
    def build(J, A, S):
        inner = J(S("store_sales"), S("customer"),
                  "ss_customer_sk", "c_customer_sk")
        outer = J(inner, S("store"), "ss_store_sk", "s_store_sk")
        plan = A(outer, "c_region", (("ss_net_profit", "sum"),))
        agg_leaf = A(S("catalog_sales"), "cs_item_sk",
                     (("cs_sales_price", "sum"),))
        j = J(S("store_sales"), agg_leaf, "ss_item_sk", "cs_item_sk")
        return inner, outer, plan, agg_leaf, j

    inner, outer, plan, agg_leaf, j = build(Join, Aggregate, Scan)
    jplan, jj = build(JJoin, JAggregate, JScan)[2::2]
    nodes = [n for _, n in shared_subtree_candidates(plan)]
    assert plan in nodes
    assert outer in nodes
    assert inner not in nodes
    assert agg_leaf in [n for _, n in shared_subtree_candidates(j)]
    for got, want in ((plan, jplan), (j, jj)):
        assert ([s for s, _ in shared_subtree_candidates(got)]
                == [s for s, _ in j_candidates(want)])


def test_aggregate_specs_distinguish_signatures():
    """q33 is q19's join under a different aggregate column: the plan
    signatures differ while the join subtrees match."""
    q19 = parse_sql(SQL_TEXTS["q19_filtered_customer"])
    q33 = parse_sql(SQL_TEXTS["q33_shared_customer_join"])
    assert signature(q19) != signature(q33)
    assert signature(q19.child) == signature(q33.child)


# ---------------------------------------------------------------------------
# Plan cache
# ---------------------------------------------------------------------------


def test_plan_cache_warm_hit_skips_optimize(catalog, port_catalog):
    service = QueryService(port_catalog)
    plan = service_queries()["q19_filtered_customer"]
    cold = service.submit(plan, name="cold")
    warm = service.submit(plan, name="warm")
    assert not cold.plan_cached and warm.plan_cached
    assert warm.optimized is cold.optimized   # the stored object, verbatim
    assert service.plan_cache.hits == 1
    jservice = JQueryService(catalog)
    jplan = j_service_queries()["q19_filtered_customer"]
    jcold = jservice.submit(jplan, name="cold")
    jservice.submit(jplan, name="warm")
    assert signature(cold.optimized.plan) == \
        j_signature(jcold.optimized.plan)
    assert cold.quoted_cost == pytest.approx(jcold.quoted_cost, rel=1e-9)
    assert service.stats() == jservice.stats()


def test_plan_cache_binds_to_catalog_fingerprint(catalog, port_catalog):
    """Two catalogs sharing a version number must not share plans: the
    fingerprint (version + uid) is the binding, mirroring FilterCache."""
    counters = []
    for opt, cat, gen, plan, cache in (
            (optimize, port_catalog,
             lambda: generate(0.1, 4, 43, device="cpu"),
             service_queries()["q19_filtered_customer"], PlanCache()),
            (j_optimize, catalog, lambda: j_generate(0.1, 4, 43),
             j_service_queries()["q19_filtered_customer"], JPlanCache())):
        opt(plan, cat, prune=False, plan_cache=cache)
        assert len(cache) == 1 and cache.misses == 1
        other = gen()
        other.version = cat.version   # forced version collision
        opt(plan, other, prune=False, plan_cache=cache)
        assert cache.invalidations == 1
        assert cache.hits == 0            # the collision was NOT a hit
        assert len(cache) == 1            # re-populated against `other`
        counters.append((cache.hits, cache.misses, cache.invalidations,
                         len(cache)))
    assert counters[0] == counters[1]


def test_plan_cache_key_separates_optimizer_knobs(catalog, port_catalog):
    """The same logical plan under different rewrite knobs compiles to
    different plans — the key must keep them apart, as the reference's."""
    plan = service_queries()["q19_filtered_customer"]
    jplan = j_service_queries()["q19_filtered_customer"]
    cache, jcache = PlanCache(), JPlanCache()
    for prune in (False, True, False):
        got = optimize(plan, port_catalog, prune=prune, plan_cache=cache)
        want = j_optimize(jplan, catalog, prune=prune, plan_cache=jcache)
        assert signature(got.plan) == j_signature(want.plan)
    assert (cache.hits, cache.misses, len(cache)) == (1, 2, 2)
    assert (cache.hits, cache.misses, cache.invalidations, len(cache)) == \
        (jcache.hits, jcache.misses, jcache.invalidations, len(jcache))
    assert sorted(cache._entries) == sorted(jcache._entries)


# ---------------------------------------------------------------------------
# Shared FilterCache across the batch (interleaved multi-query execution)
# ---------------------------------------------------------------------------


def test_interleaved_queries_share_one_filter_cache(catalog, port_catalog):
    """Two queries with overlapping predicate chains through the service
    (CSE off, so both execute their joins): rows identical to solo, and
    the second query's eligible filters all report cached=True with zero
    rebuild bytes — as in the reference's run of the same pair."""
    service = QueryService(port_catalog, cse=False)
    q19 = service_queries()["q19_filtered_customer"]
    q33 = service_queries()["q33_shared_customer_join"]
    service.submit(q19, name="first")
    service.submit(q33, name="second")
    report = service.run()[0]
    first, second = report.results["first"], report.results["second"]
    assert first.filters and second.filters
    assert first.cached_filters == 0
    assert second.cached_filters == len(second.filters)
    assert second.filter_reduce_bytes == 0.0
    assert rows_close(_rows(first), _rows(service.execute_solo(q19)))
    assert rows_close(_rows(second), _rows(service.execute_solo(q33)))
    jservice = JQueryService(catalog, cse=False)
    jqueries = j_service_queries()
    jservice.submit(jqueries["q19_filtered_customer"], name="first")
    jservice.submit(jqueries["q33_shared_customer_join"], name="second")
    jreport = jservice.run()[0]
    for name in ("first", "second"):
        got, want = report.results[name], jreport.results[name]
        assert got.cached_filters == want.cached_filters
        assert got.filter_reduce_bytes == want.filter_reduce_bytes
        assert got.network_bytes == want.network_bytes
        assert _decisions(got) == _decisions(want)
        assert rows_close(_rows(got), _rows(want))
    assert service.stats() == jservice.stats()


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------


def _drain(ac):
    out = []
    while True:
        batch = ac.next_batch()
        out.append([s.qid for s in batch])
        if not batch:
            return out


@pytest.mark.parametrize("policy,budget,costs,want", [
    ("fifo", None, [5.0, 1.0, 3.0], [[0, 1, 2], []]),
    # Stable: the two cost-1.0 queries keep submission order.
    ("cost", None, [5.0, 1.0, 3.0, 1.0], [[1, 3, 2, 0], []]),
    # 2+2 <= 4; the next 2 would be followed by 10; an over-budget query
    # is admitted alone — no live-lock.
    ("fifo", 4.0, [2.0, 2.0, 2.0, 10.0, 1.0], [[0, 1], [2], [3], [4], []]),
    ("cost", 4.0, [2.0, 2.0, 2.0, 10.0, 1.0], [[4, 0], [1, 2], [3], []]),
])
def test_admission_orders_equal_reference(policy, budget, costs, want):
    """The reference's fifo, cost and budget cases, on both packages'
    controllers."""
    got = AdmissionController(budget=budget, policy=policy)
    ref = JAdmissionController(budget=budget, policy=policy)
    for i, cost in enumerate(costs):
        got.submit(_sub(i, cost))
        ref.submit(_sub(i, cost, jax=True))
    assert _drain(got) == _drain(ref) == want
    assert len(got) == 0


def test_admission_rejects_unknown_policy():
    with pytest.raises(ValueError) as err:
        AdmissionController(policy="priority")
    with pytest.raises(ValueError) as jerr:
        JAdmissionController(policy="priority")
    assert str(err.value) == str(jerr.value)
    assert ADMISSION_POLICIES == ("fifo", "cost")


def test_cost_policy_orders_the_suite_as_the_reference(catalog,
                                                       port_catalog):
    """The suite's real quotes under ``policy="cost"``: the admitted order
    is the reference's."""
    service = QueryService(port_catalog, policy="cost")
    jservice = JQueryService(catalog, policy="cost")
    for (q, plan), jplan in zip(service_queries().items(),
                                j_service_queries().values()):
        service.submit(plan, name=q)
        jservice.submit(jplan, name=q)
    assert ([s.name for s in service.admission.next_batch()]
            == [s.name for s in jservice.admission.next_batch()])


def test_service_budget_run_produces_multiple_batches(catalog,
                                                      port_catalog):
    """End to end: a budget below the suite's total quote forces multiple
    batches — the reference's split of the same quotes — every query still
    executes, and rows still match solo."""
    probe = QueryService(port_catalog)
    queries = dict(list(service_queries().items())[:3])
    quotes = [probe.submit(p, name=q).quoted_cost
              for q, p in queries.items()]
    budget = max(quotes)  # big enough for any single query, not for all
    service = QueryService(port_catalog, cost_budget=budget)
    for q, p in queries.items():
        service.submit(p, name=q)
    reports = service.run()
    assert len(reports) >= 2
    jservice = JQueryService(catalog, cost_budget=budget)
    for q, p in list(j_service_queries().items())[:3]:
        jservice.submit(p, name=q)
    jsplit = []
    while len(jservice.admission):
        jsplit.append([s.name for s in jservice.admission.next_batch()])
    assert [list(r.results) for r in reports] == jsplit
    executed = {q for r in reports for q in r.results}
    assert executed == set(queries)
    for r in reports:
        for qname, res in r.results.items():
            assert rows_close(_rows(res),
                              _rows(service.execute_solo(queries[qname])))


def test_submission_quotes_are_positive(port_batch, jax_batch):
    """Every quote is positive and the reference's, to a relative 1e-9."""
    subs, jsubs = port_batch[1], jax_batch[1]
    assert sorted(subs) == sorted(jsubs)
    for q, sub in subs.items():
        assert sub.quoted_cost > 0
        assert sub.quoted_cost == pytest.approx(jsubs[q].quoted_cost,
                                                rel=1e-9)
        assert (sub.qid, sub.name, sub.plan_cached) == \
            (jsubs[q].qid, jsubs[q].name, jsubs[q].plan_cached)
        assert signature(sub.optimized.plan) == \
            j_signature(jsubs[q].optimized.plan)
        assert sub.optimized.reordered == jsubs[q].optimized.reordered


# ---------------------------------------------------------------------------
# The standalone pass
# ---------------------------------------------------------------------------


def test_main_equals_the_reference_on_the_cpu(capsys):
    """``main`` at its reference size (``generate(0.05, 4, 11)``) passes
    and prints the reference's counts: shared subtrees, joins, bytes and
    cache counters."""
    from repro.sql import service as j_service
    from repro_torch.sql import service as t_service
    assert t_service.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert j_service.main() == 0
    want = capsys.readouterr().out
    assert got.startswith("service pass on cpu: ")
    assert got.split(": ", 1)[1] == want.split(": ", 1)[1]


def test_main_without_a_card_does_not_fall_back(monkeypatch):
    import torch

    from repro_torch.sql import service as t_service
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_service.main([])
