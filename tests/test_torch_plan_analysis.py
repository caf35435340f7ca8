"""The port's plan verification against the JAX package's, on the CPU.

Every mutation of the reference's ``tests/test_plan_analysis.py`` is built
twice, once from each package's classes, and run through each package's
rules: the port must report the same ``Violation``s (rule id, path and
detail, compared as strings: details quote the same numbers) and trip
exactly the rule the mutation targets. ``RULES`` and ``optimize(verify=
True)`` are held to the reference; the gated executor and
``verify_execution`` run clean over the golden queries; the module's
``main`` runs on the CPU at a small scale.
"""

import dataclasses
import json
import types
from pathlib import Path

import pytest
import torch

import repro.core.cost_model as j_cost_model
import repro.core.selection as j_selection
import repro.core.stats as j_stats
import repro.joins.exchange as j_exchange
import repro.joins.methods as j_methods
import repro.sql.executor as j_executor
import repro.sql.logical as j_logical
import repro.sql.plan_analysis as j_pa
import repro.sql.planner as j_planner
import repro_torch.core.cost_model as t_cost_model
import repro_torch.core.selection as t_selection
import repro_torch.core.stats as t_stats
import repro_torch.joins.exchange as t_exchange
import repro_torch.joins.methods as t_methods
import repro_torch.sql.executor as t_executor
import repro_torch.sql.logical as t_logical
import repro_torch.sql.plan_analysis as t_pa
import repro_torch.sql.planner as t_planner
from repro.sql import every_query as j_every_query
from repro.sql import filtered_queries as j_filtered_queries
from repro.sql import optimize as j_optimize
from repro.sql import skewed_queries as j_skewed_queries
from repro_torch.sql import (Executor, FilterCache, FilteredStrategy,
                             PlanVerificationError, RelJoinStrategy,
                             ReorderingStrategy, SkewAwareStrategy,
                             all_queries, cyclic_queries, default_strategies,
                             every_query, filtered_queries, generate,
                             optimize, signature, skewed_queries,
                             text_queries, verify_execution)

GOLDEN = json.loads((Path(__file__).parent / "fixtures" / "golden_plans.json"
                     ).read_text())["queries"]


def namespace(cm, sel, st, ex, me, exe, lo, pa, pl):
    """One package's classes and rule functions, under common names."""
    ns = types.SimpleNamespace(pa=pa, ReoptDecision=exe.ReoptDecision,
                               JoinStep=pl.JoinStep,
                               catalog_schema=pl.catalog_schema,
                               ExchangeReport=ex.ExchangeReport,
                               JoinReport=me.JoinReport,
                               CostParams=cm.CostParams,
                               JoinMethod=cm.JoinMethod,
                               TableStats=st.TableStats)
    for name in ("JoinProperties", "JoinType", "Selection",
                 "select_join_method"):
        setattr(ns, name, getattr(sel, name))
    for name in ("Aggregate", "Filter", "Join", "JoinEdge", "Project",
                 "RuntimeFilter", "Scan"):
        setattr(ns, name, getattr(lo, name))
    return ns


JNS = namespace(j_cost_model, j_selection, j_stats, j_exchange, j_methods,
                j_executor, j_logical, j_pa, j_planner)
TNS = namespace(t_cost_model, t_selection, t_stats, t_exchange, t_methods,
                t_executor, t_logical, t_pa, t_planner)


@pytest.fixture(scope="module")
def port_catalog():
    return generate(0.1, 4, 42, device="cpu")


# ---------------------------------------------------------------------------
# The mutations: each returns [(violations, rules the call must trip)].
# ---------------------------------------------------------------------------

def _stats(n, size, card, skew=1.0):
    return n.TableStats(float(size), float(card)).with_skew(skew)


def _rf(n, keep_est=0.2, benefit=1e6, cost=1e3, kind="bloom"):
    return n.RuntimeFilter(0, 1, "fk", "pk", m_bits=1 << 13, k=4,
                           sigma_est=0.2, keep_est=keep_est, benefit=benefit,
                           cost=cost, kind=kind)


def _shuffle_report(n, elided_left=False, elided_right=False):
    ex = lambda e: n.ExchangeReport(  # noqa: E731
        "shuffle", 0.0 if e else 1000.0, 0.0, elided=e)
    return n.JoinReport(n.JoinMethod.SHUFFLE_HASH,
                        [ex(elided_left), ex(elided_right)], 0.0, 0)


def m_p1(n, cat):
    schema = n.catalog_schema(cat)
    want = {"P1_UNKNOWN_COLUMN"}
    return [(n.pa.analyze_plan(n.Filter(n.Scan("item"), "no_such_column",
                                        "eq", 1), schema), want),
            (n.pa.analyze_plan(n.Join(n.Scan("store_sales"), n.Scan("item"),
                                      "ss_item_sk", "no_such_key"), schema),
             want),
            (n.pa.analyze_plan(n.Scan("no_such_table"), schema), want)]


def m_p2(n, cat):
    schema = n.catalog_schema(cat)
    before = n.Join(n.Scan("store_sales"), n.Scan("item"), "ss_item_sk",
                    "i_item_sk")
    after = n.Project(before, ("ss_item_sk", "i_brand"))
    return [(n.pa.check_schema_preserved(before, after, schema),
             {"P2_OUTPUT_SCHEMA_CHANGED"}),
            (n.pa.check_schema_preserved(before, before, schema), set())]


def m_p3(n, cat):
    schema, dtypes = n.catalog_schema(cat), n.pa.catalog_dtypes(cat)
    plan = n.Join(n.Scan("store_sales"), n.Scan("item"), "ss_sales_price",
                  "i_item_sk")
    return [(n.pa.analyze_plan(plan, schema, dtypes),
             {"P3_KEY_DTYPE_MISMATCH"}),
            (n.pa.analyze_plan(plan, schema), set())]


def m_p4(n, cat):
    plan = n.Aggregate(n.Scan("item"), "i_brand", (("i_price", "median"),))
    return [(n.pa.analyze_plan(plan, n.catalog_schema(cat)),
             {"P4_BAD_AGG_OP"})]


def m_e1(n, cat):
    sel = n.Selection(n.JoinMethod.SHUFFLE_HASH, "test", 1.0,
                      {n.JoinMethod.SHUFFLE_HASH: 1.0})
    bsel = n.Selection(n.JoinMethod.BROADCAST_HASH, "test", 1.0,
                       {n.JoinMethod.BROADCAST_HASH: 1.0})
    brep = n.JoinReport(n.JoinMethod.BROADCAST_HASH,
                        [n.ExchangeReport("broadcast", 0.0, 0.0,
                                          elided=True)], 0.0, 0)
    want = {"E1_MISSING_EXCHANGE"}
    return [(n.pa.audit_exchanges(sel, n.JoinProperties(),
                                  _shuffle_report(n, True, False)), want),
            (n.pa.audit_exchanges(bsel, n.JoinProperties(
                right_partitioned=True), brep), want)]


def m_e2(n, cat):
    sel = n.Selection(n.JoinMethod.SHUFFLE_HASH, "test", 1.0,
                      {n.JoinMethod.SHUFFLE_HASH: 1.0})
    props = n.JoinProperties(right_partitioned=True)
    return [(n.pa.audit_exchanges(sel, props, _shuffle_report(n)),
             {"E2_REDUNDANT_EXCHANGE"}),
            (n.pa.audit_exchanges(sel, props,
                                  _shuffle_report(n, False, True)), set())]


def m_f1(n, cat):
    rf, jt, f1 = _rf(n), n.JoinType, {"F1_FILTER_UNSAFE_JOIN_TYPE"}
    place = n.pa.check_filter_placement
    return [(place(rf, jt.INNER), set()), (place(rf, jt.LEFT_SEMI), set()),
            (place(rf, jt.LEFT_OUTER), f1),
            (place(rf, jt.LEFT_OUTER, padded=True), set()),
            (place(rf, jt.LEFT_ANTI, padded=True), f1)]


def m_f2(n, cat):
    f2 = {"F2_FILTER_NOT_CHEAPER"}
    quote = n.pa.check_filter_quote
    return [(quote(_rf(n)), set()), (quote(_rf(n, keep_est=1.0)), f2),
            (quote(_rf(n, benefit=10.0, cost=10.0)), f2)]


def m_f3(n, cat):
    base = ("item", (("i_category", "lt", 3.0, 0.0),))
    wider = ("item", ())
    f3 = {"F3_CACHE_CHAIN_MISMATCH"}
    reuse, store = n.pa.check_cache_reuse, n.pa.check_cache_store
    return [(reuse(base, base), set()), (reuse(wider, base), set()),
            (reuse(base, wider), f3), (reuse(base, ("store", ())), f3),
            (reuse(None, base), f3),
            (store(base, build_masked=False), set()),
            (store(base, build_masked=True), f3)]


def m_s1(n, cat):
    sel = n.Selection(n.JoinMethod.SALTED_SHUFFLE_HASH, "test", 1.0, {},
                      swapped_sides=True, salt_r=4)
    return [(n.pa.audit_selection(sel, _stats(n, 1000, 100),
                                  _stats(n, 2000, 200), n.JoinProperties(),
                                  n.CostParams(p=4, w=1.0)),
             {"S1_SALT_UNREPLICABLE_BUILD"})]


def m_c1(n, cat):
    params = n.CostParams(p=4, w=1.0)
    sel = n.Selection(n.JoinMethod.SHUFFLE_HASH, "test", 1.0, {})
    bad = n.Selection(n.JoinMethod.SHUFFLE_HASH, "test", -1.0,
                      {n.JoinMethod.SHUFFLE_HASH: -1.0})
    c1 = {"C1_NEGATIVE_COST_TERM"}
    return [(n.pa.audit_selection(sel, _stats(n, -5, 100),
                                  _stats(n, 2000, 200), n.JoinProperties(),
                                  params), c1),
            (n.pa.audit_selection(bad, _stats(n, 1000, 100),
                                  _stats(n, 2000, 200), n.JoinProperties(),
                                  params), c1)]


def m_c2(n, cat):
    params = n.CostParams(p=4, w=1.0)
    left, right = _stats(n, 8000, 800), _stats(n, 7000, 700)
    props = n.JoinProperties()
    sel = n.select_join_method(left, right, props, params)
    assert sel.method is n.JoinMethod.SHUFFLE_HASH
    worse = dataclasses.replace(
        sel, method=n.JoinMethod.BROADCAST_HASH,
        cost=sel.costs[n.JoinMethod.BROADCAST_HASH])
    misquoted = dataclasses.replace(sel, cost=sel.cost * 2)
    c2 = {"C2_NONMINIMAL_METHOD"}
    audit = n.pa.audit_selection
    return [(audit(sel, left, right, props, params), set()),
            (audit(worse, left, right, props, params), c2),
            (audit(misquoted, left, right, props, params), c2)]


def m_r1(n, cat):
    edges = [n.JoinEdge(0, 1, "fk", "pk"), n.JoinEdge(1, 2, "fk2", "pk2")]
    r1 = {"R1_REPLAN_BROKEN_EDGE"}
    check = n.pa.check_replan_step
    return [(check(n.JoinStep(1, "fk", "pk", None, 0.0), {0}, edges), set()),
            (check(n.JoinStep(2, "fk2", "pk2", None, 0.0), {0}, edges), r1),
            (check(n.JoinStep(1, "fk", "pk2", None, 0.0), {0}, edges), r1)]


def m_r2(n, cat):
    est, meas = _stats(n, 1000, 100), _stats(n, 9000, 900)
    fired = n.ReoptDecision(boundary=0, estimated=est, measured=meas,
                            threshold=3.0, q_error=9.0, triggered=True,
                            old_next=1, new_next=2)
    calm = n.ReoptDecision(boundary=1, estimated=est,
                           measured=_stats(n, 1100, 110), threshold=3.0,
                           q_error=1.1, triggered=False, old_next=2,
                           new_next=2)
    r2 = {"R2_REOPT_DISCIPLINE"}
    check = n.pa.check_reopt_decision
    return [(check(fired), set()), (check(calm), set()),
            (check(dataclasses.replace(fired, q_error=1.0, triggered=False,
                                       new_next=1)), r2),
            (check(dataclasses.replace(fired, triggered=False,
                                       new_next=1)), r2),
            (check(dataclasses.replace(calm, new_next=0)), r2)]


MUTATIONS = {"P1_UNKNOWN_COLUMN": m_p1, "P2_OUTPUT_SCHEMA_CHANGED": m_p2,
             "P3_KEY_DTYPE_MISMATCH": m_p3, "P4_BAD_AGG_OP": m_p4,
             "E1_MISSING_EXCHANGE": m_e1, "E2_REDUNDANT_EXCHANGE": m_e2,
             "F1_FILTER_UNSAFE_JOIN_TYPE": m_f1,
             "F2_FILTER_NOT_CHEAPER": m_f2,
             "F3_CACHE_CHAIN_MISMATCH": m_f3,
             "S1_SALT_UNREPLICABLE_BUILD": m_s1,
             "C1_NEGATIVE_COST_TERM": m_c1, "C2_NONMINIMAL_METHOD": m_c2,
             "R1_REPLAN_BROKEN_EDGE": m_r1, "R2_REOPT_DISCIPLINE": m_r2}


def _triples(violations):
    return [(v.rule, v.path, v.detail, str(v)) for v in violations]


@pytest.mark.parametrize("rule", sorted(MUTATIONS))
def test_mutation_violations_equal_reference(catalog, port_catalog, rule):
    want = MUTATIONS[rule](JNS, catalog)
    got = MUTATIONS[rule](TNS, port_catalog)
    assert len(got) == len(want)
    for (gv, rules), (wv, _) in zip(got, want):
        assert _triples(gv) == _triples(wv)
        assert {v.rule for v in gv} == rules
    assert any(rules == {rule} for _, rules in got)


def test_rules_equal_reference():
    assert list(t_pa.RULES) == list(j_pa.RULES)
    for rule_id, rule in j_pa.RULES.items():
        assert dataclasses.astuple(t_pa.RULES[rule_id]) == \
            dataclasses.astuple(rule)
    assert sorted(MUTATIONS) == sorted(j_pa.RULES)
    assert t_pa.__all__ == j_pa.__all__


def test_infer_properties_equal_reference(catalog, port_catalog):
    for n, cat in ((JNS, catalog), (TNS, port_catalog)):
        assert n.pa.catalog_dtypes(cat)["item"] == {
            "i_item_sk": "int32", "i_category": "int32", "i_brand": "int32",
            "i_price": "float32"}
    outs = []
    for n, cat in ((JNS, catalog), (TNS, port_catalog)):
        schema = n.catalog_schema(cat)
        plan = n.Join(n.Scan("store_sales"), n.Scan("item"), "ss_item_sk",
                      "i_item_sk", join_type=n.JoinType.LEFT_OUTER)
        agg = n.Aggregate(n.Scan("item"), "i_brand",
                          (("i_price", "mean"), ("i_price", "count")))
        outs.append([
            {path: (p.columns, p.dtypes, p.distribution.kind,
                    p.distribution.key) for path, p in props.items()}
            for props, _ in (n.pa.infer_properties(plan, schema),
                             n.pa.infer_properties(
                                 agg, schema, n.pa.catalog_dtypes(cat)))])
    assert outs[0] == outs[1]
    assert outs[1][0]["root"][1]["i_item_sk_matched"] == "bool"
    assert outs[1][1]["root"][1]["mean_i_price"] == "float32"


# ---------------------------------------------------------------------------
# optimize(verify=True)
# ---------------------------------------------------------------------------

def _golden_queries():
    return {**every_query(), **skewed_queries(), **filtered_queries(),
            **text_queries(), **cyclic_queries()}


def test_optimize_verify_equals_reference(catalog, port_catalog):
    jplans = {**j_every_query(), **j_skewed_queries(),
              **j_filtered_queries()}
    for qname, plan in _golden_queries().items():
        got = optimize(plan, port_catalog, verify=True)
        assert got.plan == optimize(plan, port_catalog).plan
        assert {"reordered": got.reordered,
                "signature": signature(got.plan)} == GOLDEN[qname]["dp"]
        if qname in jplans:
            want = j_optimize(jplans[qname], catalog, verify=True)
            assert signature(got.plan) == j_logical.signature(want.plan)
            assert [dataclasses.astuple(r) for r in got.regions] == \
                [dataclasses.astuple(r) for r in want.regions]
    # A plan the static pass rejects raises with the reference's
    # violations.
    bad = {"P1_UNKNOWN_COLUMN"}
    errors = []
    for n, opt, cat in ((JNS, j_optimize, catalog),
                        (TNS, optimize, port_catalog)):
        plan = n.Join(n.Scan("store_sales"), n.Scan("item"), "ss_item_sk",
                      "no_such_key")
        with pytest.raises(n.pa.PlanVerificationError) as ei:
            opt(plan, cat, verify=True)
        errors.append(_triples(ei.value.violations))
        assert {v.rule for v in ei.value.violations} == bad
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# The gated executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qname", sorted(GOLDEN))
def test_golden_queries_clean_under_verify(port_catalog, qname):
    """Every golden query under the four default strategies (and
    Reorder(RelJoin)) with every gate armed, and ``verify_execution``
    clean afterwards."""
    plan = _golden_queries()[qname]
    params = t_cost_model.CostParams(p=port_catalog.p, w=1.0)
    for s in default_strategies() + [ReorderingStrategy(RelJoinStrategy())]:
        res = Executor(port_catalog, s, verify=True).execute(plan)
        assert verify_execution(res, params) == [], s.name
        if not isinstance(s, ReorderingStrategy):
            assert [{"method": d.selection.method.value,
                     "swapped": bool(d.selection.swapped_sides)}
                    for d in res.decisions] == \
                GOLDEN[qname]["strategies"][s.name]


_COMPOSED = ("q2_chain7", "q7_filtered_fact", "q13_fact_fact_first",
             "q19_filtered_customer", "q21_catalog_filtered_dates")


@pytest.mark.parametrize("qname", _COMPOSED)
def test_composed_strategies_clean_under_verify(port_catalog, qname):
    """Adaptive re-plans, runtime-filter placements, cache traffic,
    skew-aware selections and checkpoints all pass the gates."""
    plan = _golden_queries()[qname]
    strat = FilteredStrategy(ReorderingStrategy(RelJoinStrategy()),
                             cache=FilterCache())
    Executor(port_catalog, strat, verify=True).execute(plan)
    # Warm second run: cache hits go through the F3 reuse gate.
    warm = Executor(port_catalog, strat, verify=True).execute(plan)
    if qname in filtered_queries():
        assert warm.cached_filters >= 1
    Executor(port_catalog, SkewAwareStrategy(), verify=True).execute(plan)
    Executor(port_catalog, ReorderingStrategy(RelJoinStrategy(), reopt=True),
             verify=True).execute(plan)


def test_agg_agg_join_elides_and_discounts(port_catalog):
    res = Executor(port_catalog, RelJoinStrategy(), verify=True).execute(
        all_queries()["q4_agg_agg"])
    (d,) = res.decisions
    assert d.props.left_partitioned and d.props.right_partitioned
    assert all(e.elided for e in d.report.exchanges)
    assert d.network_bytes == 0.0
    assert t_pa.audit_join_decision(
        d, t_cost_model.CostParams(p=port_catalog.p, w=1.0)) == []


def test_verify_raises_on_bad_plan_like_the_reference(catalog, port_catalog):
    from repro.sql import Executor as JExecutor
    from repro.sql import RelJoinStrategy as JRelJoinStrategy
    errors = []
    for n, ex, strat, cat in (
            (JNS, JExecutor, JRelJoinStrategy, catalog),
            (TNS, Executor, RelJoinStrategy, port_catalog)):
        plan = n.Join(n.Scan("store_sales"), n.Scan("item"), "ss_item_sk",
                      "no_such_key")
        with pytest.raises(n.pa.PlanVerificationError) as ei:
            ex(cat, strat(), verify=True).execute(plan)
        errors.append((_triples(ei.value.violations), str(ei.value)))
    assert errors[0] == errors[1]
    assert not Executor(port_catalog, RelJoinStrategy()).verify
    assert PlanVerificationError is t_pa.PlanVerificationError


# ---------------------------------------------------------------------------
# The standalone pass
# ---------------------------------------------------------------------------

#: One query of each suite: star, reordering, skew, filters, text-only
#: (LEFT JOIN against an aggregate), the hypercube. The whole suite runs
#: gated above and, through ``main``, on the card.
MAIN_SUBSET = ("q1_star3", "q13_fact_fact_first", "q16_hot_customer",
               "q20_filter_below_earlier_exchange", "q26_outer_agg",
               "q35_triangle")


def test_main_runs_clean_on_the_cpu(capsys):
    assert t_pa.main(["--scale", "0.02", "--p", "2", "--seed", "42",
                      "--device", "cpu", "--queries",
                      ",".join(MAIN_SUBSET)]) == 0
    out = capsys.readouterr().out
    assert "checked 6 plans x 9 strategies (54 gated executions): " \
        "0 violation(s)" in out
    assert all(f"{q}: ok" in out for q in MAIN_SUBSET)


def test_main_subset_and_unknown_query(capsys):
    assert t_pa.main(["--scale", "0.02", "--p", "2", "--device", "cpu",
                      "--queries", "q16_hot_customer,q35_triangle"]) == 0
    assert "checked 2 plans x 9 strategies" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        t_pa.main(["--device", "cpu", "--queries", "q99_nope"])


def test_main_without_a_card_does_not_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_pa.main(["--scale", "0.02", "--p", "2"])
