"""Logical plan optimizer: rewrites, cost-based join reordering, hypercube
planning and runtime-filter placement.

The paper (§4.2-§4.3) selects the physical method *per logical join* but
takes the logical join order as given. This module supplies the missing
plan-space search so that relative-cost selection composes into a globally
optimal physical plan:

  1. **Predicate pushdown** — filters sink through projections, inner joins
     and group-by keys to the scans they constrain.
  2. **Projection pruning** — scans are narrowed to the columns the plan
     actually consumes (smaller row_bytes -> lower |A|,|B| -> lower k).
  3. **System-R join ordering** — a left-deep dynamic program over each
     inner-join region, scoring every candidate order with the RelJoin cost
     model (Eqs. 4/8/10 via Algorithm 1's best feasible method) and
     propagating intermediate sizes with ``estimate_join``. A bushy-plan
     extension sits behind the ``bushy`` flag.
  4. **Hypercube planning** — a cyclic region (its closing column
     equalities written above it) is quoted as one multi-way shuffle
     against the best binary tree.
  5. **Runtime-filter placement** (sideways information passing).

The DP only ever *replaces* the written order when its modeled workload is
strictly lower, so enabling reordering can't regress a well-written plan
under the model. ``Executor`` re-runs the same DP at every exchange
boundary with runtime-measured statistics (adaptive re-planning), via
``enumerate_join_order(..., start=...)``. ``PlanCache`` keeps compiled
plans across queries, and ``optimize(verify=True)`` arms the
plan-verification gate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from ..core.cost_model import (BLOOM_DEFAULT_BITS_PER_KEY, CostParams,
                               JoinMethod, cached_filter_cost, cube_shares,
                               method_cost)
from ..core.selection import (JoinProperties, JoinType, Selection,
                              select_hypercube, select_join_method)
from ..core.stats import (DEFAULT_WATERMARK_BYTES, ColumnStats, TableStats,
                          estimate_filter, estimate_group_by, estimate_join,
                          estimate_project)
from .datagen import Catalog, catalog_fingerprint
from .logical import (Aggregate, Filter, Join, JoinGraph, Node, Project,
                      RuntimeFilter, Scan, Schema, augment_edges,
                      cyclic_core, extract_join_graph, filter_chain,
                      key_band_fraction, leaf_columns, signature)
from .runtime_filters import (DEFAULT_FILTER_KINDS, FILTER_KINDS,
                              FilterCache, filter_cache_key)
from .selectivity import derive_selectivity

#: Static guess for an aggregate's group count as a fraction of input rows
#: (used only when no runtime statistic exists yet; exchange boundaries
#: replace it with the measured cardinality).
DEFAULT_GROUP_FRACTION = 0.1


# ---------------------------------------------------------------------------
# Schema / statistics helpers
# ---------------------------------------------------------------------------

def catalog_schema(catalog: Catalog) -> Schema:
    return {name: tuple(t.columns) for name, t in catalog.tables.items()}


def catalog_base_stats(catalog: Catalog) -> Dict[str, TableStats]:
    """Exact base-table statistics (the catalog's header stats)."""
    return {name: t.measure() for name, t in catalog.tables.items()}


def estimate_leaf_stats(node: Node, base_stats: Dict[str, TableStats],
                        schema: Schema,
                        key_domains: Optional[Dict[str, float]] = None,
                        column_stats: Optional[Dict[str, ColumnStats]] = None
                        ) -> TableStats:
    """Statically propagate (size, cardinality) through a leaf subtree.

    Filter selectivity is op-aware: a per-column histogram
    (``column_stats``, e.g. ``Catalog.column_stats``) wins when it covers
    the filter's column; otherwise a declared ``Filter.selectivity`` wins,
    and underived filters (parsed SQL) get ``derive_selectivity``'s
    schema-derived fraction — ``between``/``eq``/``in`` on columns with
    known domains estimate their true kept fraction instead of a blanket
    0.5. ``key_domains`` (e.g. ``Catalog.key_domains``) refines key-column
    lookups; the static schema domains are the fallback. With histograms,
    aggregate group counts come from the group key's NDV and join output
    cardinalities from histogram-backed retain fractions instead of the
    fixed ``DEFAULT_GROUP_FRACTION`` / declared-only retains."""
    if isinstance(node, Scan):
        return base_stats[node.table]
    if isinstance(node, Filter):
        return estimate_filter(
            estimate_leaf_stats(node.child, base_stats, schema, key_domains,
                                column_stats),
            derive_selectivity(node, key_domains, column_stats))
    if isinstance(node, Project):
        child = estimate_leaf_stats(node.child, base_stats, schema,
                                    key_domains, column_stats)
        n_child = max(len(leaf_columns(node.child, schema)), 1)
        return estimate_project(child, len(node.columns) / n_child)
    if isinstance(node, Aggregate):
        child = estimate_leaf_stats(node.child, base_stats, schema,
                                    key_domains, column_stats)
        groups = max(child.cardinality * DEFAULT_GROUP_FRACTION, 1.0)
        if column_stats is not None:
            cs = column_stats.get(node.key)
            if cs is not None and cs.count > 0:
                groups = max(cs.ndv, 1.0)
        return estimate_group_by(child, groups)
    if isinstance(node, Join):
        left = estimate_leaf_stats(node.left, base_stats, schema,
                                   key_domains, column_stats)
        right = estimate_leaf_stats(node.right, base_stats, schema,
                                    key_domains, column_stats)
        retain = stats_retain_fraction(node.right, key_domains, column_stats)
        if node.join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            # Output keeps probe columns only; anti is the complement. The
            # match fraction is domain coverage: the build side's distinct
            # keys (its cardinality, by the unique-build-key contract —
            # histogram NDV for aggregate builds) over the probe key's
            # domain. A full-table build then correctly predicts the anti
            # residue of never-referenced keys, which no filter-retain
            # product can see.
            sigma = semi_match_fraction(right, node.left_key, key_domains,
                                        retain)
            frac = (sigma if node.join_type is JoinType.LEFT_SEMI
                    else max(1.0 - sigma, 0.0))
            card = left.cardinality * frac
            return TableStats(card * left.row_bytes, card)
        if node.join_type in (JoinType.LEFT_OUTER, JoinType.RIGHT_OUTER,
                              JoinType.FULL_OUTER):
            # Outer joins keep (at least) every probe row.
            return estimate_join(left, right)
        return estimate_join(left, right, fk_selectivity=retain)
    raise TypeError(f"unknown plan node {type(node)}")


def stats_retain_fraction(node: Node,
                          key_domains: Optional[Dict[str, float]] = None,
                          column_stats: Optional[Dict[str, ColumnStats]]
                          = None) -> float:
    """Histogram-aware twin of ``logical.leaf_retain_fraction``: the
    fraction of a build leaf's key domain surviving its filter chain,
    with each filter's fraction taken from the column's histogram when one
    exists. Without ``column_stats`` it reproduces the declared/derived
    fractions exactly."""
    base, filters = filter_chain(node)
    frac = 1.0
    for f in filters:
        frac *= min(max(derive_selectivity(f, key_domains, column_stats),
                        0.0), 1.0)
    if isinstance(base, Project):
        frac *= stats_retain_fraction(base.child, key_domains, column_stats)
    return frac


def semi_match_fraction(build: TableStats, probe_key: str,
                        key_domains: Optional[Dict[str, float]],
                        retain: float) -> float:
    """Fraction of probe rows a semi join keeps: the build side's distinct
    keys (its estimated cardinality — the engine's unique-build-key
    contract makes cardinality ≈ NDV) over the probe key's domain. Falls
    back to the build chain's filter-retain fraction when the probe key
    has no known domain."""
    domain = key_domains.get(probe_key) if key_domains else None
    if domain is not None and domain > 0:
        return min(max(build.cardinality, 0.0) / domain, 1.0)
    return min(max(retain, 0.0), 1.0)


def _step(probe: TableStats, build: TableStats, params: CostParams,
          ) -> Tuple[JoinMethod, float]:
    """Method + modeled workload of one candidate join (Algorithm 1 on the
    candidate's statistics; Eq. 4/8/10 dispatch when selection fell back)."""
    sel = select_join_method(probe, build, JoinProperties(), params)
    cost = sel.cost
    if not math.isfinite(cost):
        a, b = ((probe, build) if probe.size_bytes >= build.size_bytes
                else (build, probe))
        cost = method_cost(sel.method, a.size_bytes, b.size_bytes,
                           max(a.cardinality, 1.0), max(b.cardinality, 1.0),
                           params)
    return sel.method, cost


# ---------------------------------------------------------------------------
# System-R dynamic program
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JoinStep:
    """One executed join of a left-deep order: intermediate |><| leaf."""

    build: int
    probe_key: str
    build_key: str
    method: JoinMethod
    cost: float


@dataclasses.dataclass
class JoinOrder:
    """A complete order over a region. ``tree`` generalizes to bushy shapes:
    a leaf index or ``(left_tree, right_tree, probe_key, build_key)``."""

    first: int
    steps: Tuple[JoinStep, ...]
    cost: float
    stats: TableStats
    tree: object

    def order(self) -> List[int]:
        """Leaf indices in join sequence (derived from the tree so bushy
        shapes are covered too; for left-deep orders this is
        [first, step1.build, step2.build, ...])."""

        def leaves(t):
            if isinstance(t, int):
                return [t]
            return leaves(t[0]) + leaves(t[1])

        return leaves(self.tree)


@dataclasses.dataclass
class _State:
    cost: float
    stats: TableStats
    retain: float      # product of member retain fractions (build-side role)
    root: int          # probe root (its unique key survives the joins)
    first: int
    steps: tuple
    tree: object


def enumerate_join_order(leaf_stats: List[TableStats],
                         retain: List[float],
                         edges,
                         params: CostParams,
                         bushy: bool = False,
                         start: Optional[int] = None) -> Optional[JoinOrder]:
    """System-R DP over a join region.

    Left-deep by default: states are relation subsets; a leaf ``r`` extends
    subset ``S`` iff an edge oriented toward ``r`` has its probe endpoint in
    ``S`` (so ``r`` always joins through its unique key — the engine's
    BuildRight contract is preserved under any enumerated order). With
    ``bushy=True``, two disjoint subsets may also be merged when the edge
    lands on the build subset's probe root, whose key stays unique through
    FK->PK joins.

    ``start`` pins the first (probe-root) relation — the executor's adaptive
    re-planning hook uses it to extend a partially-executed order.
    Returns None when no feasible complete order exists.
    """
    n = len(leaf_stats)
    if n == 0:
        return None
    seeds = range(n) if start is None else (start,)
    dp: Dict[frozenset, _State] = {}
    for i in seeds:
        dp[frozenset((i,))] = _State(0.0, leaf_stats[i], retain[i], i, i,
                                     (), i)

    by_build: Dict[int, list] = {}
    for e in edges:
        by_build.setdefault(e.build, []).append(e)

    for size in range(1, n):
        layer = [s for s in dp if len(s) == size]
        for S in sorted(layer, key=sorted):
            st = dp[S]
            # Left-deep extension: S |><| {r}.
            for r in range(n):
                if r in S:
                    continue
                usable = [e for e in by_build.get(r, []) if e.probe in S]
                if not usable:
                    continue
                e = usable[0]
                method, cost = _step(st.stats, leaf_stats[r], params)
                total = st.cost + cost
                T = S | {r}
                if T in dp and dp[T].cost <= total:
                    continue
                stats = estimate_join(st.stats, leaf_stats[r],
                                      fk_selectivity=retain[r])
                step = JoinStep(r, e.probe_key, e.build_key, method, cost)
                dp[T] = _State(total, stats, st.retain * retain[r], st.root,
                               st.first, st.steps + (step,),
                               (st.tree, r, e.probe_key, e.build_key))
        if bushy:
            # Merge disjoint subsets: S1 (probe) |><| S2 (build via root).
            subsets = sorted((s for s in dp if len(s) <= size), key=sorted)
            for S1 in subsets:
                for S2 in subsets:
                    if len(S1) + len(S2) > n or S1 & S2:
                        continue
                    s1, s2 = dp[S1], dp[S2]
                    usable = [e for e in by_build.get(s2.root, [])
                              if e.probe in S1]
                    if not usable:
                        continue
                    e = usable[0]
                    method, cost = _step(s1.stats, s2.stats, params)
                    total = s1.cost + s2.cost + cost
                    T = S1 | S2
                    if T in dp and dp[T].cost <= total:
                        continue
                    stats = estimate_join(s1.stats, s2.stats,
                                          fk_selectivity=s2.retain)
                    step = JoinStep(s2.root, e.probe_key, e.build_key,
                                    method, cost)
                    dp[T] = _State(total, stats, s1.retain * s2.retain,
                                   s1.root, s1.first,
                                   s1.steps + s2.steps + (step,),
                                   (s1.tree, s2.tree, e.probe_key,
                                    e.build_key))

    full = dp.get(frozenset(range(n)))
    if full is None:
        return None
    return JoinOrder(full.first, full.steps, full.cost, full.stats, full.tree)


def modeled_tree_cost(graph: JoinGraph, leaf_stats: List[TableStats],
                      retain: List[float], params: CostParams) -> float:
    """Modeled workload (Eq. 4/8/10 sum) of executing the region in its
    *written* order, with the same estimation rules the DP uses."""

    def go(t):
        if isinstance(t, int):
            return leaf_stats[t], retain[t], 0.0
        ls, lr, lc = go(t[0])
        rs, rr, rc = go(t[1])
        _, cost = _step(ls, rs, params)
        out = estimate_join(ls, rs, fk_selectivity=rr)
        return out, lr * rr, lc + rc + cost

    return go(graph.tree)[2]


# ---------------------------------------------------------------------------
# Hypercube multi-way planning (cyclic join cores)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HypercubePlan:
    """Physical plan of one hypercube multi-way join over a cyclic region.

    ``order`` lists the region's leaf indices with the probe relation
    first; all positional fields below index into that order. ``links``
    are the local probe chain as ``(build_position, probe_col,
    build_col)`` triples; ``checks`` the residual column equalities
    (unused binary edges + the closing eqcol predicates). ``selection``
    is the winning HYPERCUBE_SHUFFLE quote against ``binary_cost``."""

    order: Tuple[int, ...]
    dims: Tuple[int, ...]
    axis_keys: Tuple[Tuple[Tuple[int, str], ...], ...]
    links: Tuple[Tuple[int, str, str], ...]
    checks: Tuple[Tuple[str, str], ...]
    selection: Selection
    binary_cost: float


def plan_hypercube(graph: JoinGraph, closing,
                   leaf_stats: List[TableStats], binary_cost: float,
                   params: CostParams,
                   watermark_bytes: float = DEFAULT_WATERMARK_BYTES
                   ) -> Optional[HypercubePlan]:
    """Quote the hypercube multi-way shuffle against the best binary plan.

    ``closing`` is the list of column-equality predicates written above
    the region, as ``((leaf_u, col_u), (leaf_v, col_v))`` pairs — with the
    graph's equi-join edges they form the (possibly cyclic) join graph.
    Returns a plan only when (1) the region plus closing edges is one
    cyclic core covering every leaf, (2) the shape is hypercube-executable
    (a unique probe relation, every build reachable through the accumulated
    probe row), and (3) Algorithm 1's multi-way extension prices it
    *strictly cheaper* than ``binary_cost`` (the best binary tree's quote).
    Anything else returns None and the binary plan stands.
    """
    n = graph.n
    pairs = [(e.probe, e.build) for e in graph.edges]
    pairs += [(a[0], b[0]) for a, b in closing]
    if n < 3 or len(cyclic_core(n, pairs)) != n:
        return None

    # Join variables: key equivalence classes over equi + closing edges.
    parent: Dict[tuple, tuple] = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for e in graph.edges:
        parent[find((e.probe, e.probe_key))] = find((e.build, e.build_key))
    for a, b in closing:
        parent[find(tuple(a))] = find(tuple(b))
    classes: Dict[tuple, set] = {}
    for x in list(parent):
        classes.setdefault(find(x), set()).add(x)
    axes = sorted((sorted(c) for c in classes.values()
                   if len({leaf for leaf, _ in c}) > 1))
    if not axes:
        return None

    # Probe relation: the unique leaf never used as a build side.
    builds = {e.build for e in graph.edges}
    probes = [i for i in range(n) if i not in builds]
    if len(probes) != 1:
        return None
    order = [probes[0]]
    links: List[Tuple[int, str, str]] = []
    used = set()
    remaining = set(range(n)) - {probes[0]}
    progress = True
    while remaining and progress:
        progress = False
        for ei, e in enumerate(graph.edges):
            if ei in used or e.build not in remaining or e.probe not in order:
                continue
            order.append(e.build)
            links.append((len(order) - 1, e.probe_key, e.build_key))
            used.add(ei)
            remaining.discard(e.build)
            progress = True
    if remaining:
        return None
    checks = [(graph.edges[ei].probe_key, graph.edges[ei].build_key)
              for ei in range(len(graph.edges)) if ei not in used]
    checks += [(cu, cv) for (u, cu), (v, cv) in closing]

    memberships: List[Tuple[int, ...]] = []
    axis_keys: List[Tuple[Tuple[int, str], ...]] = []
    for leaf in order:
        keys = []
        for ax, members in enumerate(axes):
            cols = [c for (l, c) in members if l == leaf]
            if cols:
                keys.append((ax, cols[0]))
        memberships.append(tuple(ax for ax, _ in keys))
        axis_keys.append(tuple(keys))

    stats = [leaf_stats[i] for i in order]
    sel = select_hypercube(stats, memberships, len(axes), binary_cost,
                           params, watermark_bytes)
    if sel is None:
        return None
    dims = cube_shares(params.p, len(axes), memberships,
                       [s.size_bytes for s in stats], params)
    return HypercubePlan(tuple(order), tuple(dims), tuple(axis_keys),
                         tuple(links), tuple(checks), sel, binary_cost)


# ---------------------------------------------------------------------------
# Runtime bloom-filter placement (sideways information passing)
# ---------------------------------------------------------------------------

def leaf_key_domain(node: Node, base_stats: Dict[str, TableStats]
                    ) -> Optional[float]:
    """Cardinality of the key domain a leaf's unique key spans: the base
    scan's row count (dimension PKs cover [0, n)). None when the leaf is
    not rooted in a scan (e.g. an aggregated subquery) — the filter planner
    then falls back to the leaf's static retain fraction."""
    base, _ = filter_chain(node)
    if isinstance(base, Project):
        return leaf_key_domain(base.child, base_stats)
    if isinstance(base, Scan):
        st = base_stats.get(base.table)
        return st.cardinality if st is not None else None
    return None


def plan_runtime_filters(edges, leaf_stats: List[TableStats],
                         sigmas: List[float], params: CostParams,
                         bits_per_key: int = BLOOM_DEFAULT_BITS_PER_KEY,
                         leaves: Optional[List[Node]] = None,
                         kinds=DEFAULT_FILTER_KINDS,
                         cache: Optional[FilterCache] = None
                         ) -> List[RuntimeFilter]:
    """Decide runtime-filter placement + kind per join-graph edge.

    ``sigmas[i]`` is leaf i's estimated match fraction when it plays the
    build role: the share of the probe side's key domain its surviving keys
    cover (measured build cardinality / domain when the executor calls
    this, the static retain fraction in the planner). Every kind in
    ``kinds`` quotes the edge (bloom always; zone map only when ``leaves``
    lets the band test see a range predicate on the build key; semi-join
    always, priced by its exact key list) and the strictly cheapest quote
    wins — ties resolve to the earliest kind in ``kinds``, which keeps the
    bloom-only behaviour bit-stable under the default order. An edge gets
    its winning filter iff the filtered join plus the filter's build +
    broadcast cost is *strictly* cheaper under the RelJoin cost model than
    the unfiltered join — so at sigma = 1 (unfiltered build) nothing is
    ever planned and selections are byte-identical to the paper's. Edges
    derived through key equivalence classes participate too: that is what
    pushes a dimension's filter below exchanges of relations it never
    directly joins.

    With a ``cache`` (cross-query ``FilterCache``), a kind whose payload
    is already cached for the edge's build leaf is quoted at
    ``cached_filter_cost`` instead — broadcast only, the build + reduce
    terms drop — so warm filters clear the gate on edges a cold build
    would not. An empty or absent cache changes no quote: cold-cache
    decisions are byte-identical to the uncached planner's.
    """
    out: List[RuntimeFilter] = []
    seen = set()
    for e in edges:
        ident = (e.probe, e.build, e.probe_key, e.build_key)
        if ident in seen:
            continue
        seen.add(ident)
        a, b = leaf_stats[e.probe], leaf_stats[e.build]
        if a.cardinality <= 0:
            continue
        n = max(b.cardinality, 0.0)
        band = (key_band_fraction(leaves[e.build], e.build_key)
                if leaves is not None else None)
        _, unfiltered = _step(a, b, params)
        best = None          # (total, quote, filtered_cost, cached, cost)
        for kname in kinds:
            quote = FILTER_KINDS[kname].quote(n, sigmas[e.build], band,
                                              bits_per_key, params)
            if quote is None or quote.keep_est >= 1.0:
                continue
            cached = (cache is not None and leaves is not None
                      and cache.contains(filter_cache_key(
                          leaves[e.build], e.build_key, quote.kind,
                          quote.bits, quote.k)))
            cost = (cached_filter_cost(quote.bits, params) if cached
                    else quote.cost)
            _, filtered = _step(a.scaled(quote.keep_est), b, params)
            total = filtered + cost
            if best is None or total < best[0]:
                best = (total, quote, filtered, cached, cost)
        if best is None:
            continue
        total, quote, filtered, cached, cost = best
        if total < unfiltered * (1 - 1e-9):
            out.append(RuntimeFilter(e.probe, e.build, e.probe_key,
                                     e.build_key, quote.bits, quote.k,
                                     sigmas[e.build], quote.keep_est,
                                     unfiltered - filtered, cost,
                                     derived=e.derived, kind=quote.kind,
                                     cached=cached))
    return out


# ---------------------------------------------------------------------------
# Rewrites: predicate pushdown + projection pruning
# ---------------------------------------------------------------------------

def push_down_filters(node: Node, schema: Schema) -> Node:
    """Sink every filter as close to its scan as semantics allow."""
    if isinstance(node, Filter):
        child = push_down_filters(node.child, schema)
        return _sink(dataclasses.replace(node, child=child), schema)
    if isinstance(node, Join):
        return dataclasses.replace(
            node, left=push_down_filters(node.left, schema),
            right=push_down_filters(node.right, schema))
    if isinstance(node, (Project, Aggregate)):
        return dataclasses.replace(
            node, child=push_down_filters(node.child, schema))
    return node


#: join types whose probe (left) side accepts pushed filters.
_LEFT_PUSHABLE = (JoinType.INNER, JoinType.LEFT_OUTER, JoinType.LEFT_SEMI,
                  JoinType.LEFT_ANTI)


def _sink(f: Filter, schema: Schema) -> Node:
    c = f.child
    if f.op == "eqcol":
        # Column-to-column predicates reference two leaves of the region
        # (the closing edge of a cyclic join core) — only evaluable where
        # both columns coexist, i.e. exactly where they are written.
        return f
    if isinstance(c, Join):
        try:
            lcols = leaf_columns(c.left, schema)
            rcols = leaf_columns(c.right, schema)
        except (KeyError, TypeError):
            return f
        in_l, in_r = f.column in lcols, f.column in rcols
        if in_l and not in_r and c.join_type in _LEFT_PUSHABLE:
            return dataclasses.replace(
                c, left=_sink(dataclasses.replace(f, child=c.left), schema))
        if in_r and not in_l and c.join_type is JoinType.INNER:
            return dataclasses.replace(
                c, right=_sink(dataclasses.replace(f, child=c.right), schema))
        return f
    if isinstance(c, Filter):
        # Conjunctive filters commute: slide past a stuck sibling so a
        # pushable predicate stacked above an unpushable one still sinks.
        return dataclasses.replace(
            c, child=_sink(dataclasses.replace(f, child=c.child), schema))
    if isinstance(c, Project) and f.column in c.columns:
        return dataclasses.replace(
            c, child=_sink(dataclasses.replace(f, child=c.child), schema))
    if isinstance(c, Aggregate) and f.column == c.key:
        # Filtering on the group key commutes with grouping.
        return dataclasses.replace(
            c, child=_sink(dataclasses.replace(f, child=c.child), schema))
    return f


def prune_projections(node: Node, schema: Schema,
                      required=None) -> Node:
    """Narrow scans to the columns the plan consumes (top-down required-set
    propagation). The root's output columns are always preserved, so the
    rewrite never changes query results."""
    try:
        cols = leaf_columns(node, schema)
    except (KeyError, TypeError):
        return node
    if required is None:
        required = set(cols)
    required = set(required) & set(cols)

    if isinstance(node, Scan):
        keep = tuple(c for c in schema[node.table] if c in required)
        if keep and len(keep) < len(schema[node.table]):
            return Project(node, keep)
        return node
    if isinstance(node, Filter):
        need = required | {node.column}
        if node.column2 is not None:
            need |= {node.column2}
        return dataclasses.replace(
            node, child=prune_projections(node.child, schema, need))
    if isinstance(node, Project):
        keep = tuple(c for c in node.columns if c in required)
        if not keep:
            keep = node.columns
        child = prune_projections(node.child, schema, set(keep))
        return dataclasses.replace(node, child=child, columns=keep)
    if isinstance(node, Aggregate):
        need = {node.key} | {col for col, _ in node.aggs}
        return dataclasses.replace(
            node, child=prune_projections(node.child, schema, need))
    if isinstance(node, Join):
        try:
            lcols = set(leaf_columns(node.left, schema))
            rcols = set(leaf_columns(node.right, schema))
        except (KeyError, TypeError):
            return node
        if lcols & rcols:
            # Colliding names get order-dependent ``_r`` renames — pruning
            # could silently change output naming. Recurse with full sets.
            return dataclasses.replace(
                node, left=prune_projections(node.left, schema),
                right=prune_projections(node.right, schema))
        lneed = (required & lcols) | {node.left_key}
        rneed = (required & rcols) | {node.right_key}
        return dataclasses.replace(
            node, left=prune_projections(node.left, schema, lneed),
            right=prune_projections(node.right, schema, rneed))
    return node


# ---------------------------------------------------------------------------
# Whole-plan optimization
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RegionDecision:
    """Audit of one region's ordering decision."""

    n_relations: int
    plan_order_cost: float   # modeled workload of the written order
    chosen_cost: float       # modeled workload of the emitted order
    reordered: bool


@dataclasses.dataclass
class OptimizedPlan:
    plan: Node
    regions: List[RegionDecision]

    @property
    def plan_order_cost(self) -> float:
        return sum(r.plan_order_cost for r in self.regions)

    @property
    def chosen_cost(self) -> float:
        return sum(r.chosen_cost for r in self.regions)

    @property
    def reordered(self) -> bool:
        return any(r.reordered for r in self.regions)


class PlanCache:
    """Cross-query compiled-plan cache, mirroring ``FilterCache``'s key
    discipline.

    Entries are keyed on ``logical.signature(plan)`` plus every
    ``optimize()`` knob that changes the emitted plan (pushdown / prune /
    reorder / bushy / min_region and the cost parameters ``p`` / ``w``),
    and the whole cache is bound to one catalog identity fingerprint
    (version + generation uid) via ``sync`` — a catalog change invalidates
    everything, exactly like ``FilterCache.sync``. A warm hit returns the
    stored ``OptimizedPlan`` and skips the rewrite + DP work entirely;
    ``signature()`` covers filter literals and aggregate specs, so two
    queries share an entry only when their logical plans are identical.
    """

    def __init__(self) -> None:
        self._entries: Dict[tuple, OptimizedPlan] = {}
        self._catalog_fingerprint: Optional[tuple] = None
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def __len__(self) -> int:
        return len(self._entries)

    def sync(self, catalog: Catalog) -> None:
        """Bind the cache to ``catalog``; drop every entry if it is not
        the catalog the current plans were optimized against."""
        fingerprint = catalog_fingerprint(catalog)
        if fingerprint != self._catalog_fingerprint:
            if self._entries:
                self.invalidations += 1
            self._entries.clear()
            self._catalog_fingerprint = fingerprint

    @staticmethod
    def key(plan: Node, params: CostParams, *, pushdown: bool, prune: bool,
            reorder: bool, bushy: bool, min_region: int) -> tuple:
        return (signature(plan), pushdown, prune, reorder, bushy,
                min_region, params.p, params.w)

    def lookup(self, key: tuple) -> Optional[OptimizedPlan]:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
        else:
            self.hits += 1
        return entry

    def store(self, key: tuple, optimized: OptimizedPlan) -> None:
        self._entries[key] = optimized


def modeled_plan_cost(plan: Node, base_stats: Dict[str, TableStats],
                      schema: Schema, params: CostParams,
                      key_domains: Optional[Dict[str, float]] = None,
                      column_stats: Optional[Dict[str, ColumnStats]] = None
                      ) -> float:
    """Modeled workload of a whole plan: the Eq. 4/8/10 sum of Algorithm 1's
    best feasible method over every join, with statistics statically
    propagated by ``estimate_leaf_stats`` (histogram-backed when
    ``column_stats`` is given). This is the admission controller's cost
    quote — a dimensionless relative workload comparable across queries
    against the same catalog, not a latency prediction."""
    total = 0.0
    for node in (plan, *_descendants(plan)):
        if isinstance(node, Join):
            probe = estimate_leaf_stats(node.left, base_stats, schema,
                                        key_domains, column_stats)
            build = estimate_leaf_stats(node.right, base_stats, schema,
                                        key_domains, column_stats)
            total += _step(probe, build, params)[1]
    return total


def _descendants(node: Node):
    for child in node.children():
        yield child
        yield from _descendants(child)


def build_join_tree(tree, leaves: List[Node]) -> Node:
    """Materialize a DP order tree back into logical Join nodes. A node is
    a leaf index or ``(left_tree, right_tree, probe_key, build_key)`` —
    left-deep steps are simply the case where the right subtree is a leaf."""
    if isinstance(tree, int):
        return leaves[tree]
    left, right, pk, bk = tree
    return Join(build_join_tree(left, leaves),
                build_join_tree(right, leaves), pk, bk)


def optimize(plan: Node, catalog: Optional[Catalog] = None, *,
             schema: Optional[Schema] = None,
             base_stats: Optional[Dict[str, TableStats]] = None,
             params: Optional[CostParams] = None,
             pushdown: bool = True, prune: bool = True,
             reorder: bool = True, bushy: bool = False,
             min_region: int = 3, verify: bool = False,
             plan_cache: Optional[PlanCache] = None) -> OptimizedPlan:
    """Full logical optimization pass.

    Statistics come from ``catalog`` (exact base stats) unless ``base_stats``
    is given. Regions smaller than ``min_region`` relations are left in plan
    order (a 2-relation region has nothing to reorder — side roles are
    already assigned by Algorithm 1).

    ``verify=True`` arms the plan-analysis debug gate: the input plan is
    statically analyzed, and the rewritten plan must pass the same
    analysis *and* preserve the output schema (rule P2) — any violation
    raises ``PlanVerificationError``.

    ``plan_cache`` (used only when ``catalog`` is given, since the cache
    binds to a catalog fingerprint) short-circuits the whole pass on a
    warm hit: the cache is synced to the catalog, keyed on the input
    plan's signature + every rewrite knob, and a stored ``OptimizedPlan``
    is returned as-is. Misses run the normal pass and store the result.
    """
    if schema is None:
        if catalog is None:
            raise ValueError("optimize() needs a catalog or an explicit "
                             "schema")
        schema = catalog_schema(catalog)
    if base_stats is None:
        base_stats = catalog_base_stats(catalog) if catalog else {}
    if params is None:
        params = CostParams(p=catalog.p if catalog else 8, w=1.0)
    cache_key = None
    if plan_cache is not None and catalog is not None:
        plan_cache.sync(catalog)
        cache_key = PlanCache.key(plan, params, pushdown=pushdown,
                                  prune=prune, reorder=reorder, bushy=bushy,
                                  min_region=min_region)
        cached = plan_cache.lookup(cache_key)
        if cached is not None:
            return cached
    original = plan
    if verify:
        # Imported here: plan_analysis is optimizer-independent, but
        # keeping the planner import-light avoids pulling the analyzer
        # into every planner consumer.
        from .plan_analysis import PlanVerificationError, analyze_plan
        violations = analyze_plan(plan, schema)
        if violations:
            raise PlanVerificationError(violations)

    if pushdown:
        plan = push_down_filters(plan, schema)
    if prune:
        plan = prune_projections(plan, schema)

    regions: List[RegionDecision] = []
    key_domains = catalog.key_domains if catalog is not None else None
    column_stats = catalog.column_stats if catalog is not None else None

    def rewrite(node: Node) -> Node:
        if reorder and isinstance(node, Join):
            graph = extract_join_graph(node, schema)
            if graph is not None and graph.n >= min_region:
                # Region leaves may hold nested reorderable regions (e.g.
                # under an Aggregate): rewrite them first.
                leaves = [rewrite(l) for l in graph.leaves]
                try:
                    stats = [estimate_leaf_stats(l, base_stats, schema,
                                                 key_domains, column_stats)
                             for l in leaves]
                except KeyError:
                    stats = None
                if stats is not None:
                    retain = [stats_retain_fraction(l, key_domains,
                                                    column_stats)
                              for l in leaves]
                    plan_cost = modeled_tree_cost(graph, stats, retain,
                                                  params)
                    order = enumerate_join_order(stats, retain,
                                                 augment_edges(graph),
                                                 params, bushy=bushy)
                    if (order is not None
                            and order.cost < plan_cost * (1 - 1e-9)):
                        regions.append(RegionDecision(graph.n, plan_cost,
                                                      order.cost, True))
                        return build_join_tree(order.tree, leaves)
                    regions.append(RegionDecision(graph.n, plan_cost,
                                                  plan_cost, False))
                return build_region_plan_order(
                    JoinGraph(leaves, graph.edges, graph.tree))
        if isinstance(node, Join):
            return dataclasses.replace(node, left=rewrite(node.left),
                                       right=rewrite(node.right))
        if isinstance(node, (Filter, Project, Aggregate)):
            return dataclasses.replace(node, child=rewrite(node.child))
        return node

    rewritten = rewrite(plan)
    if verify:
        from .plan_analysis import (PlanVerificationError, analyze_plan,
                                    check_schema_preserved)
        violations = (check_schema_preserved(original, rewritten, schema)
                      + analyze_plan(rewritten, schema))
        if violations:
            raise PlanVerificationError(violations)
    optimized = OptimizedPlan(rewritten, regions)
    if cache_key is not None:
        plan_cache.store(cache_key, optimized)
    return optimized


def build_region_plan_order(graph: JoinGraph) -> Node:
    """Rebuild a region's written order from its extracted tree."""

    def go(t):
        if isinstance(t, int):
            return graph.leaves[t]
        e = graph.edges[t[2]]
        return Join(go(t[0]), go(t[1]), e.probe_key, e.build_key)

    return go(graph.tree)
