"""Plan-lint: static plan verifier + property-inference pass.

RelJoin's win comes from aggressively rewriting plans — predicate pushdown,
System-R reordering, skew salting, runtime-filter placement, cache-aware
re-costing, adaptive mid-pipeline re-planning — and every rewrite is an
opportunity to silently corrupt a plan in ways the cost model can't see.
This module gates all of them with *named, testable rules* over three
passes, none of which executes the plan:

1. **Property inference** (:func:`infer_properties`) — bottom-up
   schema/dtype flow and distribution properties (hash-partitioned-on-key /
   broadcast / singleton / arbitrary, the lattice in ``logical.py``), in
   the style of Spark's EnsureRequirements. Feeds the P-rules, and lets
   the exchange audit prove each exchange of a chosen join method
   *necessary* (an elided shuffle needs a proven hash distribution — E1)
   and *sufficient* (a side already partitioned on its join key must not
   be re-shuffled — E2).

2. **Rewrite-safety rules** — runtime filters only on filter-safe edges
   (F1: a LEFT_OUTER probe-side placement is rejected unless the
   unmatched-row padding path is used; LEFT_ANTI never), filters only
   when strictly cheaper (F2), cached-filter reuse only when the stored
   predicate chain is a subset of the edge's (F3: the payload must be a
   key-set superset of the edge's surviving build keys), salting only
   when the build side is replicable (S1), adaptive re-plan steps only
   along real join-graph edges (R1), and optimizer rewrites must preserve
   the output schema (P2).

3. **Cost-model audit** — every ``JoinDecision`` / ``FilterDecision`` the
   planner emits is checked for non-negative byte terms (C1) and for the
   selected method's quoted cost being minimal among the quoted
   alternatives, by reproducing Algorithm 1 on the recorded statistics
   (C2).

Violations carry ``(rule, path, detail)``; the executor/planner debug
gates (``verify=True``) raise :class:`PlanVerificationError` listing
them. ``python -m repro_torch.sql.plan_analysis`` runs every golden query
under every strategy with the gates armed — the standalone CI pass — on
the CUDA card (``--device cpu`` for the CPU).

The rules, their ids and their messages are the JAX package's, so the two
packages report the same violations on the same plans and decisions.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Dict, List, Optional, Tuple

from ..core.cost_model import CostParams, JoinMethod
from ..core.selection import (JoinProperties, JoinType, Selection,
                              select_join_method)
from ..core.stats import TableStats, q_error as _q_error
from ..joins.aggregate import AGG_OPS as _AGG_OPS
from .logical import (ARBITRARY as _ARBITRARY, Aggregate, Distribution,
                      Filter, Join, Node, Project, RuntimeFilter, Scan,
                      Schema, hash_dist, leaf_columns)

__all__ = [
    "RULES", "Rule", "Violation", "PlanVerificationError", "NodeProperties",
    "analyze_plan", "audit_exchanges", "audit_filter_decision",
    "audit_join_decision", "audit_selection", "catalog_dtypes",
    "check_cache_reuse", "check_cache_store", "check_filter_placement",
    "check_filter_quote", "check_reopt_decision", "check_replan_step",
    "check_schema_preserved", "infer_properties", "main",
    "verify_execution",
]


# ---------------------------------------------------------------------------
# Rule registry: the reference's, rule for rule (docs/plan_analysis.md
# documents each).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Rule:
    """One named plan invariant. ``severity`` is ``"error"`` (violating
    plans can return wrong results) or ``"perf"`` (violating plans return
    correct results but pay for work the engine could avoid)."""

    rule_id: str
    severity: str
    invariant: str


RULES: Dict[str, Rule] = {r.rule_id: r for r in (
    Rule("P1_UNKNOWN_COLUMN", "error",
         "Every column an operator references exists in its input schema "
         "(tables in the catalog, filter/project/aggregate/join columns in "
         "the child's inferred output)."),
    Rule("P2_OUTPUT_SCHEMA_CHANGED", "error",
         "Optimizer rewrites (pushdown, pruning, reordering) preserve the "
         "plan's output column set."),
    Rule("P3_KEY_DTYPE_MISMATCH", "error",
         "The two key columns of an equi-join have the same dtype — hash "
         "and sort comparisons across dtypes are not value-faithful."),
    Rule("P4_BAD_AGG_OP", "error",
         "Every aggregation op is one the engine implements (AGG_OPS)."),
    Rule("E1_MISSING_EXCHANGE", "error",
         "An exchange may be elided only when the analyzer can prove the "
         "side's distribution already satisfies the method's requirement "
         "(hash-partitioned on the join key for shuffles; salted and "
         "broadcast exchanges are never elidable)."),
    Rule("E2_REDUNDANT_EXCHANGE", "perf",
         "A side proven hash-partitioned on its join key must not be "
         "re-shuffled — the exchange must be elided, and the cost model "
         "must not re-pay it."),
    Rule("F1_FILTER_UNSAFE_JOIN_TYPE", "error",
         "A probe-side runtime filter is placed only on join types whose "
         "result survives dropping non-matching probe rows: INNER and "
         "LEFT_SEMI always; LEFT_OUTER only via the padding path that "
         "re-injects dropped rows with null-padded build columns and "
         "_matched=False; LEFT_ANTI never (the filter would drop exactly "
         "the rows the query keeps)."),
    Rule("F2_FILTER_NOT_CHEAPER", "perf",
         "A planned runtime filter keeps strictly less than the full probe "
         "side and its modeled benefit strictly exceeds its build + "
         "broadcast cost (the planner's strictly-cheaper gate)."),
    Rule("F3_CACHE_CHAIN_MISMATCH", "error",
         "A cached filter payload serves an edge only when the stored "
         "predicate chain is a subset of the edge's build chain (payload "
         "keys are a superset — false positives only), and a payload "
         "built from a build side masked by another runtime filter is "
         "never stored under its chain-only key."),
    Rule("S1_SALT_UNREPLICABLE_BUILD", "error",
         "SALTED_SHUFFLE_HASH is selected only when the model's A role "
         "sits on the plan's probe (left) side — the engine salts the "
         "left side and replicates the right, so a swapped-sides salted "
         "selection prices a plan the engine cannot run."),
    Rule("C1_NEGATIVE_COST_TERM", "error",
         "Every byte term a decision records — input sizes, cardinalities, "
         "quoted costs, filter wire bytes, row counts — is non-negative "
         "and non-NaN."),
    Rule("C2_NONMINIMAL_METHOD", "perf",
         "A cost-quoting selection picks the method Algorithm 1 picks on "
         "the recorded statistics and properties, at that method's quoted "
         "cost — minimal among the quoted alternatives under the "
         "algorithm's feasibility/preference order."),
    Rule("R1_REPLAN_BROKEN_EDGE", "error",
         "Every adaptive re-plan step joins the current intermediate to a "
         "remaining leaf along a real join-graph edge (probe endpoint "
         "already joined, matching keys) — the BuildRight contract "
         "survives re-planning."),
    Rule("R2_REOPT_DISCIPLINE", "error",
         "Every checkpoint re-optimization decision is disciplined: it "
         "triggers iff the recomputed estimated-vs-measured q-error "
         "exceeds the recorded threshold, and a non-triggered checkpoint "
         "leaves the planned continuation untouched (new_next == "
         "old_next) — re-planning may only be bought with evidence."),
)}


@dataclasses.dataclass(frozen=True)
class Violation:
    """One rule violation at one plan location."""

    rule: str
    path: str
    detail: str

    def __str__(self) -> str:
        return f"{self.rule} at {self.path}: {self.detail}"


class PlanVerificationError(RuntimeError):
    """Raised by the debug-mode gates when a plan violates any rule."""

    def __init__(self, violations: List[Violation]):
        self.violations = list(violations)
        msg = "; ".join(str(v) for v in self.violations)
        super().__init__(f"plan verification failed: {msg}")


def _v(rule_id: str, path: str, detail: str) -> Violation:
    assert rule_id in RULES, rule_id
    return Violation(rule_id, path, detail)


# ---------------------------------------------------------------------------
# Pass 1: property inference (schema / dtype / distribution flow).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NodeProperties:
    """Inferred output properties of one plan node: column names in output
    order, a column -> dtype-name map ("" when unknown), and the
    distribution property from ``logical``'s lattice."""

    columns: Tuple[str, ...]
    dtypes: Dict[str, str]
    distribution: Distribution


def catalog_dtypes(catalog) -> Dict[str, Dict[str, str]]:
    """table -> column -> dtype-name map from a generated Catalog — the
    dtype ground truth the inference pass flows through the plan. Names
    drop torch's ``torch.`` prefix ("int32", "float32"), as numpy names
    them."""
    return {name: {col: str(arr.dtype).removeprefix("torch.")
                   for col, arr in t.columns.items()}
            for name, t in catalog.tables.items()}


def infer_properties(plan: Node, schema: Schema,
                     dtypes: Optional[Dict[str, Dict[str, str]]] = None
                     ) -> Tuple[Dict[str, NodeProperties], List[Violation]]:
    """Bottom-up property inference over a logical plan.

    Returns ``(props, violations)``: per-path :class:`NodeProperties`
    (mirroring executor semantics, including the ``_r`` collision rename
    and the left-outer ``_matched`` flag) plus all P-rule violations.
    A subtree whose schema cannot be resolved stops inference upward —
    its own violation is the root cause; no cascading noise is emitted.
    """
    props: Dict[str, NodeProperties] = {}
    violations: List[Violation] = []

    def done(path: str, p: NodeProperties) -> NodeProperties:
        props[path] = p
        return p

    def go(node: Node, path: str) -> Optional[NodeProperties]:
        if isinstance(node, Scan):
            if node.table not in schema:
                violations.append(_v("P1_UNKNOWN_COLUMN", path,
                                     f"scan of unknown table {node.table!r}"))
                return None
            cols = tuple(schema[node.table])
            dt = dict((dtypes or {}).get(node.table, {}))
            return done(path, NodeProperties(
                cols, {c: dt.get(c, "") for c in cols}, _ARBITRARY))

        if isinstance(node, Filter):
            child = go(node.child, path + ".child")
            if child is None:
                return None
            if node.column not in child.columns:
                violations.append(_v(
                    "P1_UNKNOWN_COLUMN", path,
                    f"filter references {node.column!r}, not in input "
                    f"columns {sorted(child.columns)}"))
            if (node.op == "eqcol"
                    and node.column2 not in child.columns):
                violations.append(_v(
                    "P1_UNKNOWN_COLUMN", path,
                    f"eqcol filter references {node.column2!r}, not in "
                    f"input columns {sorted(child.columns)}"))
            return done(path, child)

        if isinstance(node, Project):
            child = go(node.child, path + ".child")
            if child is None:
                return None
            missing = [c for c in node.columns if c not in child.columns]
            if missing:
                violations.append(_v(
                    "P1_UNKNOWN_COLUMN", path,
                    f"projection references {missing}, not in input "
                    f"columns {sorted(child.columns)}"))
            dist = child.distribution
            if dist.kind == "hash" and dist.key not in node.columns:
                dist = _ARBITRARY  # the hash key was projected away
            return done(path, NodeProperties(
                tuple(node.columns),
                {c: child.dtypes.get(c, "") for c in node.columns}, dist))

        if isinstance(node, Aggregate):
            child = go(node.child, path + ".child")
            if child is None:
                return None
            if node.key not in child.columns:
                violations.append(_v(
                    "P1_UNKNOWN_COLUMN", path,
                    f"group key {node.key!r} not in input columns "
                    f"{sorted(child.columns)}"))
            out_dtypes = {node.key: child.dtypes.get(node.key, "")}
            cols = [node.key]
            for col, op in node.aggs:
                if col not in child.columns:
                    violations.append(_v(
                        "P1_UNKNOWN_COLUMN", path,
                        f"aggregation over {col!r}, not in input columns "
                        f"{sorted(child.columns)}"))
                if op not in _AGG_OPS:
                    violations.append(_v(
                        "P4_BAD_AGG_OP", path,
                        f"op {op!r} not implemented (AGG_OPS={_AGG_OPS})"))
                name = f"{op}_{col}"
                cols.append(name)
                src = child.dtypes.get(col, "")
                out_dtypes[name] = ("int32" if op == "count"
                                    else "float32" if op == "mean" else src)
            return done(path, NodeProperties(tuple(cols), out_dtypes,
                                             hash_dist(node.key)))

        if isinstance(node, Join):
            left = go(node.left, path + ".left")
            right = go(node.right, path + ".right")
            if left is None or right is None:
                return None
            if node.left_key not in left.columns:
                violations.append(_v(
                    "P1_UNKNOWN_COLUMN", path,
                    f"left join key {node.left_key!r} not in probe columns "
                    f"{sorted(left.columns)}"))
            if node.right_key not in right.columns:
                violations.append(_v(
                    "P1_UNKNOWN_COLUMN", path,
                    f"right join key {node.right_key!r} not in build "
                    f"columns {sorted(right.columns)}"))
            lt = left.dtypes.get(node.left_key, "")
            rt = right.dtypes.get(node.right_key, "")
            if lt and rt and lt != rt:
                violations.append(_v(
                    "P3_KEY_DTYPE_MISMATCH", path,
                    f"{node.left_key!r} is {lt} but {node.right_key!r} is "
                    f"{rt}"))
            if node.join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
                # Probe columns only survive; distribution is the probe's
                # at best, unknown method-wise -> arbitrary is sound.
                return done(path, NodeProperties(left.columns, left.dtypes,
                                                 _ARBITRARY))
            cols = list(left.columns)
            out_dtypes = dict(left.dtypes)
            for c in right.columns:
                name = c if c not in cols else f"{c}_r"
                cols.append(name)
                out_dtypes[name] = right.dtypes.get(c, "")
            if node.join_type is JoinType.LEFT_OUTER:
                name = f"{node.right_key}_matched"
                cols.append(name)
                out_dtypes[name] = "bool"
            # Output distribution depends on the physical method
            # (logical.join_output_distribution); statically arbitrary.
            return done(path, NodeProperties(tuple(cols), out_dtypes,
                                             _ARBITRARY))

        violations.append(_v("P1_UNKNOWN_COLUMN", path,
                             f"unknown plan node {type(node).__name__}"))
        return None

    go(plan, "root")
    return props, violations


def analyze_plan(plan: Node, schema: Schema,
                 dtypes: Optional[Dict[str, Dict[str, str]]] = None
                 ) -> List[Violation]:
    """The static pass: property inference + P-rules over one plan."""
    return infer_properties(plan, schema, dtypes)[1]


def check_schema_preserved(before: Node, after: Node, schema: Schema,
                           path: str = "root") -> List[Violation]:
    """P2: an optimizer rewrite preserves the plan's output column set."""
    try:
        want = set(leaf_columns(before, schema))
        got = set(leaf_columns(after, schema))
    except (KeyError, TypeError):
        return []  # unresolvable schema is P1 territory, reported there
    if want == got:
        return []
    lost, gained = sorted(want - got), sorted(got - want)
    return [_v("P2_OUTPUT_SCHEMA_CHANGED", path,
               f"rewrite changed output columns (lost {lost}, "
               f"gained {gained})")]


# ---------------------------------------------------------------------------
# Pass 2: rewrite-safety rules (runtime filters, cache reuse, salting,
# adaptive re-plan steps).
# ---------------------------------------------------------------------------

#: Join types whose result survives dropping non-matching probe rows
#: outright (no compensation needed).
_FILTER_SAFE_TYPES = (JoinType.INNER, JoinType.LEFT_SEMI)


def check_filter_placement(rf: RuntimeFilter, join_type: JoinType,
                           padded: bool = False,
                           path: str = "filter") -> List[Violation]:
    """F1: probe-side runtime filters only on filter-safe edges.

    ``padded`` asserts the executor compensates a LEFT_OUTER placement by
    re-injecting filtered-out probe rows with null-padded build columns
    and ``_matched=False`` (the padding path) — without it the filter
    would silently delete unmatched output rows.
    """
    if join_type in _FILTER_SAFE_TYPES:
        return []
    if join_type is JoinType.LEFT_OUTER and padded:
        return []
    why = ("LEFT_OUTER probe-side filter without the unmatched-row "
           "padding path" if join_type is JoinType.LEFT_OUTER else
           f"probe-side filter on {join_type.value} join (dropped probe "
           f"rows are part of the result)")
    return [_v("F1_FILTER_UNSAFE_JOIN_TYPE", path,
               f"{rf.kind} filter {rf.probe_key}<-{rf.build_key}: {why}")]


def check_filter_quote(rf: RuntimeFilter,
                       path: str = "filter") -> List[Violation]:
    """F2: a planned filter must be strictly worth it — it keeps < 100%
    of the probe side and its modeled benefit strictly exceeds its cost."""
    out: List[Violation] = []
    if not rf.keep_est < 1.0:
        out.append(_v("F2_FILTER_NOT_CHEAPER", path,
                      f"{rf.kind} filter {rf.probe_key}<-{rf.build_key} "
                      f"keeps {rf.keep_est:.3f} >= 1 of the probe side"))
    if not rf.benefit > rf.cost:
        out.append(_v("F2_FILTER_NOT_CHEAPER", path,
                      f"{rf.kind} filter {rf.probe_key}<-{rf.build_key}: "
                      f"benefit {rf.benefit:.1f} <= cost {rf.cost:.1f}"))
    return out


def check_cache_store(chain: Optional[tuple], build_masked: bool,
                      path: str = "cache") -> List[Violation]:
    """F3 (store side): a payload built from a build side that another
    runtime filter of this query already masked no longer matches its
    static predicate chain and must not enter the cross-query cache."""
    if not build_masked:
        return []
    return [_v("F3_CACHE_CHAIN_MISMATCH", path,
               f"storing payload for masked build side under chain-only "
               f"key {chain!r} (payload is narrower than the chain)")]


def check_cache_reuse(stored_chain: Optional[tuple],
                      edge_chain: Optional[tuple],
                      path: str = "cache") -> List[Violation]:
    """F3 (reuse side): a stored payload may serve an edge only when the
    stored predicate chain is a *subset* of the edge's build chain — then
    the payload's key set is a superset of the edge's surviving build
    keys and filtering stays false-positive-only."""
    if stored_chain is None or edge_chain is None:
        return [_v("F3_CACHE_CHAIN_MISMATCH", path,
                   "cache traffic for a leaf with no chain identity "
                   "(not Scan-rooted)")]
    s_table, s_preds = stored_chain
    e_table, e_preds = edge_chain
    if s_table != e_table:
        return [_v("F3_CACHE_CHAIN_MISMATCH", path,
                   f"stored chain scans {s_table!r}, edge scans "
                   f"{e_table!r}")]
    if not set(s_preds) <= set(e_preds):
        extra = sorted(set(s_preds) - set(e_preds))
        return [_v("F3_CACHE_CHAIN_MISMATCH", path,
                   f"stored chain has predicates {extra} the edge chain "
                   f"lacks — the payload may miss keys the edge's build "
                   f"side retains")]
    return []


def check_replan_step(step, joined, edges,
                      path: str = "region") -> List[Violation]:
    """R1: an adaptive re-plan step must follow a real join-graph edge —
    build endpoint outside the joined set, probe endpoint inside, keys
    matching — so the BuildRight contract survives re-planning."""
    for e in edges:
        if (e.build == step.build and e.probe in joined
                and e.probe_key == step.probe_key
                and e.build_key == step.build_key):
            return []
    return [_v("R1_REPLAN_BROKEN_EDGE", path,
               f"re-plan step joins leaf {step.build} via "
               f"{step.probe_key}={step.build_key} but no join-graph edge "
               f"oriented into the joined set {sorted(joined)} matches")]


def check_reopt_decision(dec, path: str = "reopt") -> List[Violation]:
    """R2: checkpoint re-optimization discipline over one decision.

    The trigger is recomputed from the recorded estimated/measured
    cardinalities (``core.stats.q_error``) and must match both the
    recorded ``q_error`` and the ``triggered`` flag against the recorded
    threshold; a non-triggered checkpoint must not have changed the
    continuation — the re-planned subtree must stay consistent with the
    live join graph's next step."""
    out: List[Violation] = []
    q = _q_error(dec.estimated.cardinality, dec.measured.cardinality)
    if not math.isclose(q, dec.q_error, rel_tol=_REL_TOL, abs_tol=1e-9):
        out.append(_v("R2_REOPT_DISCIPLINE", path,
                      f"recorded q-error {dec.q_error:.3f} != recomputed "
                      f"{q:.3f} (est={dec.estimated.cardinality:.0f}, "
                      f"meas={dec.measured.cardinality:.0f})"))
    elif dec.triggered != (q > dec.threshold):
        out.append(_v("R2_REOPT_DISCIPLINE", path,
                      f"triggered={dec.triggered} but q-error {q:.3f} vs "
                      f"threshold {dec.threshold:g} says "
                      f"{q > dec.threshold}"))
    if not dec.triggered and dec.new_next != dec.old_next:
        out.append(_v("R2_REOPT_DISCIPLINE", path,
                      f"checkpoint did not trigger yet changed the "
                      f"continuation (next build {dec.old_next!r} -> "
                      f"{dec.new_next!r})"))
    return out


# ---------------------------------------------------------------------------
# Pass 3: cost-model audit over emitted decisions.
# ---------------------------------------------------------------------------

_REL_TOL = 1e-6

#: Shuffle-family methods whose per-side exchanges are elidable.
_ELIDABLE = (JoinMethod.SHUFFLE_HASH, JoinMethod.SHUFFLE_SORT)


def _close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=_REL_TOL, abs_tol=1e-9)


def audit_selection(sel: Selection, left: TableStats, right: TableStats,
                    props: JoinProperties, params: CostParams,
                    path: str = "join") -> List[Violation]:
    """C1 + C2 + S1 over one selection, *before* it runs.

    C2 reproduces Algorithm 1 on the recorded statistics and properties
    and demands the same method at the same quoted cost. Hinted,
    fallback, and quote-free (absolute-size / forced) selections have no
    quotes to audit — C1 still applies to their statistics.
    """
    out: List[Violation] = []
    for label, st in (("left", left), ("right", right)):
        if (st.size_bytes < 0 or st.cardinality < 0
                or math.isnan(st.size_bytes) or math.isnan(st.cardinality)):
            out.append(_v("C1_NEGATIVE_COST_TERM", path,
                          f"{label} statistics have negative/NaN terms "
                          f"(size={st.size_bytes}, "
                          f"card={st.cardinality})"))
    for m, c in sel.costs.items():
        if math.isnan(c) or c < 0:
            out.append(_v("C1_NEGATIVE_COST_TERM", path,
                          f"quoted cost of {m.value} is {c}"))
    if sel.method is JoinMethod.SALTED_SHUFFLE_HASH and sel.swapped_sides:
        out.append(_v("S1_SALT_UNREPLICABLE_BUILD", path,
                      "salted shuffle selected with swapped sides — the "
                      "build (replicated) side is the larger one"))
    if props.hint is not None or sel.used_fallback or not sel.costs:
        return out
    if sel.method is JoinMethod.HYPERCUBE_SHUFFLE:
        # Multi-way selections are quoted by the hypercube planner against
        # the best binary tree's cost, not by the binary Algorithm 1 on a
        # (left, right) pair — there is no two-sided reference to replay.
        # C1/S1 above still apply.
        return out
    if out:
        return out  # corrupted inputs make the reference run meaningless
    ref = select_join_method(left, right,
                             dataclasses.replace(props, hint=None), params)
    if ref.used_fallback or not ref.costs:
        return out
    expect_method, expect_cost = ref.method, ref.cost
    if "engine:" in sel.reason:
        # §4.4-style engine degrade: broadcast premise void, shuffle runs.
        expect_method = JoinMethod.SHUFFLE_HASH
        expect_cost = ref.costs.get(expect_method, ref.cost)
    if sel.method is not expect_method:
        out.append(_v(
            "C2_NONMINIMAL_METHOD", path,
            f"selected {sel.method.value} "
            f"(quoted {sel.costs.get(sel.method, float('nan')):.1f}) but "
            f"Algorithm 1 picks {expect_method.value} "
            f"(quoted {expect_cost:.1f}) on the recorded statistics"))
    elif not _close(sel.cost, expect_cost):
        out.append(_v(
            "C2_NONMINIMAL_METHOD", path,
            f"{sel.method.value} quoted at {sel.cost:.1f}, but its "
            f"minimal quote on the recorded statistics is "
            f"{expect_cost:.1f}"))
    return out


def audit_exchanges(sel: Selection, props: JoinProperties, report,
                    path: str = "join") -> List[Violation]:
    """E1 + E2 over one executed join's exchange reports.

    The necessity proof: an elided exchange is legal only where the
    distribution property says the side is already hash-partitioned on
    its join key (shuffle family, per-side flags) — anything else is a
    missing exchange. The sufficiency proof: a side with a proven hash
    distribution must have had its shuffle elided, not re-paid.
    """
    out: List[Violation] = []
    exchanges = list(report.exchanges)
    if sel.method is JoinMethod.HYPERCUBE_SHUFFLE:
        # Multi-way: every relation pays its hypercube exchange — the cube
        # distribution (hash on owned axes x replication along free axes)
        # is never provable from any input property, so an elision is
        # always a missing exchange.
        for ex in exchanges:
            if getattr(ex, "elided", False):
                out.append(_v(
                    "E1_MISSING_EXCHANGE", path,
                    f"{ex.kind} exchange of the multi-way join elided — "
                    f"cube distributions are never provably redundant"))
        return out
    if sel.method in _ELIDABLE and len(exchanges) == 2:
        sides = (("probe", props.left_partitioned, exchanges[0]),
                 ("build", props.right_partitioned, exchanges[1]))
        for label, proven, ex in sides:
            elided = bool(getattr(ex, "elided", False))
            if elided and not proven:
                out.append(_v(
                    "E1_MISSING_EXCHANGE", path,
                    f"{label}-side shuffle elided without a proven "
                    f"hash-on-key distribution"))
            if proven and not elided:
                out.append(_v(
                    "E2_REDUNDANT_EXCHANGE", path,
                    f"{label} side is hash-partitioned on its join key "
                    f"but re-shuffled {ex.network_bytes:.0f} bytes"))
        return out
    # Broadcast-family and salted exchanges establish distributions that
    # depend on more than the join key (full replication; key+salt
    # partitioning) — no input property can prove them skippable.
    for ex in exchanges:
        if getattr(ex, "elided", False):
            out.append(_v(
                "E1_MISSING_EXCHANGE", path,
                f"{ex.kind} exchange of {sel.method.value} elided — this "
                f"exchange kind is never provably redundant"))
    return out


def audit_join_decision(decision, params: CostParams,
                        path: str = "join") -> List[Violation]:
    """Full audit of one ``JoinDecision``: selection (C1/C2/S1) plus
    exchanges (E1/E2). E-rules need the decision's recorded
    ``JoinProperties`` (partition flags) — decisions without them get the
    selection audit only."""
    props = getattr(decision, "props", None)
    out = audit_selection(decision.selection, decision.left_stats,
                          decision.right_stats, props or JoinProperties(),
                          params, path)
    if props is not None:
        out += audit_exchanges(decision.selection, props, decision.report,
                               path)
    return out


def audit_filter_decision(decision, path: str = "filter") -> List[Violation]:
    """C1 + F2 over one executed ``FilterDecision``."""
    out: List[Violation] = []
    if decision.rows_before < 0 or decision.rows_after < 0:
        out.append(_v("C1_NEGATIVE_COST_TERM", path,
                      f"negative row counts ({decision.rows_before} -> "
                      f"{decision.rows_after})"))
    if decision.rows_after > decision.rows_before:
        out.append(_v("C1_NEGATIVE_COST_TERM", path,
                      f"filter grew the probe side ({decision.rows_before} "
                      f"-> {decision.rows_after} rows)"))
    if decision.broadcast_bytes < 0 or decision.reduce_bytes < 0:
        out.append(_v("C1_NEGATIVE_COST_TERM", path,
                      f"negative filter wire bytes "
                      f"(broadcast={decision.broadcast_bytes}, "
                      f"reduce={decision.reduce_bytes})"))
    out += check_filter_quote(decision.plan, path)
    return out


def verify_execution(result, params: CostParams) -> List[Violation]:
    """Post-hoc audit of a full ``ExecutionResult``: every join and filter
    decision through the pass-3 rules. The executor's ``verify=True``
    gates run the same audits inline — this entry point serves the CLI
    and tests."""
    out: List[Violation] = []
    for i, d in enumerate(result.decisions):
        out += audit_join_decision(d, params, path=f"join#{i}")
    for i, f in enumerate(result.filters):
        out += audit_filter_decision(f, path=f"filter#{i}[{f.plan.kind}]")
    for i, r in enumerate(getattr(result, "reopts", ()) or ()):
        out += check_reopt_decision(r, path=f"reopt#{i}")
    return out


# ---------------------------------------------------------------------------
# Standalone CI pass: every golden query x every strategy, gates armed.
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    """``python -m repro_torch.sql.plan_analysis``: run all golden queries
    (q1-q37, including the text-only SQL suite and the cyclic hypercube
    targets) under every strategy with the debug gates armed, plus the
    static pass and the optimizer's P2 gate per query, on the CUDA card
    unless ``--device`` names another. Exits non-zero on any violation."""
    import argparse

    from .datagen import generate
    from .executor import Executor
    from .planner import catalog_schema, optimize
    from .queries import (cyclic_queries, every_query, filtered_queries,
                          skewed_queries, text_queries)
    from .strategies import (FilteredStrategy, RelJoinStrategy,
                             ReorderingStrategy, SkewAwareStrategy,
                             default_strategies)

    ap = argparse.ArgumentParser(
        description="static plan verification over the golden query suite")
    ap.add_argument("--scale", type=float, default=0.05,
                    help="catalog scale factor (default 0.05)")
    ap.add_argument("--p", type=int, default=4,
                    help="partition count (default 4)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--queries", default="",
                    help="comma-separated subset of query names")
    ap.add_argument("--device", default=None,
                    help="torch device of the catalog (default: the CUDA "
                         "card; there is no fallback when none is found)")
    args = ap.parse_args(argv)

    catalog = generate(scale=args.scale, p=args.p, seed=args.seed,
                       device=args.device)
    schema = catalog_schema(catalog)
    dtypes = catalog_dtypes(catalog)
    queries = {**every_query(), **skewed_queries(), **filtered_queries(),
               **text_queries(), **cyclic_queries()}
    if args.queries:
        names = args.queries.split(",")
        unknown = [n for n in names if n not in queries]
        if unknown:
            ap.error(f"unknown queries {unknown}; "
                     f"known: {sorted(queries)}")
        queries = {n: queries[n] for n in names}
    strategies = default_strategies() + [
        ReorderingStrategy(RelJoinStrategy()),
        # Checkpoint re-optimization arm: every boundary's ReoptDecision
        # runs through the R2 gate inline (verify=True below).
        ReorderingStrategy(RelJoinStrategy(), reopt=True),
        FilteredStrategy(RelJoinStrategy()),
        FilteredStrategy(ReorderingStrategy(RelJoinStrategy())),
        SkewAwareStrategy(),
    ]

    failures: List[str] = []
    checked = 0
    for qname in sorted(queries):
        plan = queries[qname]
        for violation in analyze_plan(plan, schema, dtypes):
            failures.append(f"{qname} [static]: {violation}")
        try:
            optimize(plan, catalog, verify=True)
        except PlanVerificationError as e:
            failures.extend(f"{qname} [optimize]: {v}" for v in e.violations)
        for strat in strategies:
            checked += 1
            try:
                Executor(catalog, strat, verify=True).execute(plan)
            except PlanVerificationError as e:
                failures.extend(f"{qname} [{strat.name}]: {v}"
                                for v in e.violations)
        status = "FAIL" if any(f.startswith(qname) for f in failures) else "ok"
        print(f"{qname}: {status}")
    for f in failures:
        print(f"VIOLATION {f}", file=sys.stderr)
    print(f"checked {len(queries)} plans x {len(strategies)} strategies "
          f"({checked} gated executions): "
          f"{len(failures)} violation(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
