"""Logical query plans (paper §2.2): operator trees that determine the
result but not the physical methods. Joins and aggregations are the
exchange boundaries that split the plan into query stages (§2.3)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..core.cost_model import JoinMethod
from ..core.selection import JoinType


@dataclasses.dataclass(frozen=True)
class Node:
    """Base logical operator."""

    def children(self) -> tuple:
        return ()


@dataclasses.dataclass(frozen=True)
class Scan(Node):
    table: str


@dataclasses.dataclass(frozen=True)
class Filter(Node):
    """Single-column predicate. ``op`` is one of ``eq | ne | lt | le | gt |
    ge | between | in | eqcol``; ``value2`` is BETWEEN's upper bound and
    ``values`` IN's literal list (both ignored by the other ops).
    ``eqcol`` is the one column-to-column op: it keeps rows where
    ``column == column2`` — the closing edge of a cyclic join core, which
    the binary engine can only evaluate as a post-join residual predicate.
    ``selectivity`` is the declared static estimate — ``None`` means
    *underived*, and every consumer goes through
    :func:`effective_selectivity`, which falls back to the schema-derived
    estimate (``sql.selectivity.derive_selectivity``).
    """

    child: Node
    column: str
    op: str
    value: float = 0.0
    value2: float = 0.0
    values: Tuple[float, ...] = ()
    selectivity: Optional[float] = None
    column2: Optional[str] = None  # eqcol's right-hand column

    def children(self):
        return (self.child,)


def effective_selectivity(f: Filter) -> float:
    """The selectivity estimate a plan consumer should use: the declared
    value when present, else the op/domain-derived one (declared wins)."""
    if f.selectivity is not None:
        return f.selectivity
    from .selectivity import derive_selectivity
    return derive_selectivity(f)


@dataclasses.dataclass(frozen=True)
class Project(Node):
    child: Node
    columns: Tuple[str, ...]

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Join(Node):
    """Logical equi-join; left is the plan-order probe side."""

    left: Node
    right: Node
    left_key: str
    right_key: str
    join_type: JoinType = JoinType.INNER
    hint: Optional[JoinMethod] = None

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class Aggregate(Node):
    """Group-by aggregation (an exchange boundary, like Join)."""

    child: Node
    key: str                              # group key column
    aggs: Tuple[Tuple[str, str], ...]     # (column, op) pairs

    def children(self):
        return (self.child,)


def _fmt_literal(v: float) -> str:
    """Compact literal rendering for signatures (``6`` not ``6.0``)."""
    return f"{v:g}"


def filter_literal(f: Filter) -> str:
    """The literal part of a Filter's signature tag: BETWEEN's two bounds,
    IN's value list, eqcol's right-hand column, or the single comparison
    constant."""
    if f.op == "between":
        return f"{_fmt_literal(f.value)}:{_fmt_literal(f.value2)}"
    if f.op == "in":
        return ",".join(_fmt_literal(v) for v in f.values)
    if f.op == "eqcol":
        return str(f.column2)
    return _fmt_literal(f.value)


def signature(plan: Node) -> str:
    """Canonical one-line structural signature of a logical plan. Captures
    join order, join keys/types, filter predicates *including their
    literals*, aggregate specs, and operator nesting — what the golden-plan
    snapshots pin so optimizer edits can't silently reorder a plan.
    (Literals and agg specs matter: two plans differing only in a constant
    or in which column they sum are different plans, and signature-keyed
    consumers — the plan cache, cross-query CSE — must never collide
    them.)"""
    if isinstance(plan, Scan):
        return plan.table
    if isinstance(plan, Filter):
        return (f"filter[{plan.column} {plan.op} {filter_literal(plan)}]"
                f"({signature(plan.child)})")
    if isinstance(plan, Project):
        return f"project[{','.join(plan.columns)}]({signature(plan.child)})"
    if isinstance(plan, Aggregate):
        specs = ",".join(f"{op}:{col}" for col, op in plan.aggs)
        return f"agg[{plan.key};{specs}]({signature(plan.child)})"
    if isinstance(plan, Join):
        tag = f"{plan.left_key}={plan.right_key}"
        if plan.join_type is not JoinType.INNER:
            tag += f",{plan.join_type.value}"
        return f"join[{tag}]({signature(plan.left)},{signature(plan.right)})"
    raise TypeError(f"unknown plan node {type(plan)}")


def count_joins(plan: Node) -> int:
    n = 1 if isinstance(plan, Join) else 0
    return n + sum(count_joins(c) for c in plan.children())


def walk(plan: Node):
    yield plan
    for c in plan.children():
        yield from walk(c)


def walk_paths(plan: Node, path: str = "root"):
    """Pre-order walk yielding ``(path, node)`` pairs, where ``path`` is a
    dotted locator like ``root.left.child`` — the plan path the static
    analyzer attaches to every violation so a failing rule names the exact
    operator, not just the plan."""
    yield path, plan
    if isinstance(plan, Join):
        yield from walk_paths(plan.left, path + ".left")
        yield from walk_paths(plan.right, path + ".right")
    else:
        for c in plan.children():
            yield from walk_paths(c, path + ".child")


# ---------------------------------------------------------------------------
# Distribution property lattice (plan analysis support): how an operator's
# output is laid out across the engine's p partitions — Spark
# EnsureRequirements-style physical properties, used by the plan analyzer
# to prove every exchange of a chosen join method necessary (no missing
# shuffle) and sufficient (no redundant re-shuffle of a side already
# hash-partitioned on its join key).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Distribution:
    """Physical data-distribution property of an operator's output.

    ``kind`` is one of:

      * ``"hash"`` — rows are hash-partitioned by column ``key`` (the
        output-partitioning property a shuffle on ``key`` establishes;
        ``Table.partitioned_by`` is its runtime shadow),
      * ``"broadcast"`` — every partition holds a full replica,
      * ``"singleton"`` — all rows live in one partition,
      * ``"cube"`` — hypercube layout: hash-partitioned by ``key`` along
        one cube axis and *replicated* along the others (the state a
        ``hypercube_shuffle`` establishes). Replication means a plain
        shuffle on ``key`` can NOT be elided — rows exist on several
        partitions — so the property never satisfies ``partitioned_on``,
      * ``"arbitrary"`` — no guarantee (round-robin placement, salted
        shuffles, or any layout the analyzer cannot prove stronger).

    The lattice order is arbitrary < {hash(key), broadcast, singleton}:
    ``arbitrary`` is the sound fallback whenever inference loses track.
    """

    kind: str
    key: Optional[str] = None

    def partitioned_on(self, key: str) -> bool:
        """True iff rows are provably hash-partitioned by ``key`` — the
        condition under which a shuffle on ``key`` may be elided."""
        return self.kind == "hash" and self.key == key


#: The bottom of the lattice: no layout guarantee.
ARBITRARY = Distribution("arbitrary")
BROADCAST = Distribution("broadcast")
SINGLETON = Distribution("singleton")


def hash_dist(key: str) -> Distribution:
    """Hash-partitioned-on-``key`` distribution."""
    return Distribution("hash", key)


def cube_dist(key: str) -> Distribution:
    """Cube-partitioned distribution: hashed on ``key`` along one hypercube
    axis, replicated along the rest. Strictly weaker than ``hash(key)`` for
    exchange elision (see the class docstring)."""
    return Distribution("cube", key)


def infer_distribution(node: Node) -> Distribution:
    """Static bottom-up distribution inference over a logical plan.

    Mirrors the engine's output-partitioning rules where the logical plan
    determines them (scans land round-robin; filters preserve placement;
    a projection keeps the hash property only while the key survives;
    a group-by shuffles by its group key) and falls back to ARBITRARY for
    joins, whose output distribution depends on the physical method —
    :func:`join_output_distribution` resolves those once a method is known.
    """
    if isinstance(node, Scan):
        return ARBITRARY
    if isinstance(node, Filter):
        return infer_distribution(node.child)
    if isinstance(node, Project):
        d = infer_distribution(node.child)
        if d.kind == "hash" and d.key not in node.columns:
            return ARBITRARY
        return d
    if isinstance(node, Aggregate):
        return hash_dist(node.key)
    if isinstance(node, Join):
        return ARBITRARY
    raise TypeError(f"unknown plan node {type(node)}")


def join_output_distribution(method: JoinMethod, probe: Distribution,
                             probe_key: str) -> Distribution:
    """Output distribution of one physical join, given the probe (plan
    left) side's input distribution — the engine's rules in
    ``joins/methods.py``: broadcast-family joins leave the probe side in
    place (its distribution survives), shuffle hash/sort co-partition both
    sides by the probe key, and salted or cartesian placement is
    key-independent."""
    if method in (JoinMethod.BROADCAST_HASH, JoinMethod.BROADCAST_NL):
        return probe
    if method in (JoinMethod.SHUFFLE_HASH, JoinMethod.SHUFFLE_SORT):
        return hash_dist(probe_key)
    return ARBITRARY


# ---------------------------------------------------------------------------
# Join-graph extraction (planner support): a *join region* is a maximal
# subtree of hint-free INNER joins. Its leaves are the region's base
# relations (scans, filter chains, projections, aggregates, or non-inner
# join subtrees); its edges carry the equi-join keys, oriented probe ->
# build (the build side's key is unique by the engine contract).
# ---------------------------------------------------------------------------

#: table name -> ordered column names; the planner derives it from a Catalog.
Schema = dict


def leaf_columns(node: Node, schema: Schema) -> Tuple[str, ...]:
    """Output column names of a subtree (mirrors executor semantics,
    including the ``_r`` rename of colliding build columns and the
    ``_matched`` flag of left-outer joins)."""
    if isinstance(node, Scan):
        return tuple(schema[node.table])
    if isinstance(node, Filter):
        return leaf_columns(node.child, schema)
    if isinstance(node, Project):
        return tuple(node.columns)
    if isinstance(node, Aggregate):
        return (node.key,) + tuple(f"{op}_{col}" for col, op in node.aggs)
    if isinstance(node, Join):
        left = leaf_columns(node.left, schema)
        if node.join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            return left
        out = list(left)
        for c in leaf_columns(node.right, schema):
            out.append(c if c not in out else f"{c}_r")
        if node.join_type is JoinType.LEFT_OUTER:
            out.append(f"{node.right_key}_matched")
        return tuple(out)
    raise TypeError(f"unknown plan node {type(node)}")


def filter_chain(node: Node):
    """Split the conjunctive filter list off the top of a subtree.

    Returns ``(base, filters)`` where ``filters`` is the outermost-first
    list of Filter specs and ``base`` is the first non-Filter descendant.
    """
    filters = []
    while isinstance(node, Filter):
        filters.append(node)
        node = node.child
    return node, filters


def leaf_retain_fraction(node: Node) -> float:
    """Fraction of the leaf's key domain surviving its filter chain —
    the fk_selectivity a probe side experiences when joining this leaf
    (key-uniformity assumption; 1.0 for unfiltered leaves)."""
    base, filters = filter_chain(node)
    frac = 1.0
    for f in filters:
        frac *= min(max(effective_selectivity(f), 0.0), 1.0)
    if isinstance(base, Project):
        frac *= leaf_retain_fraction(base.child)
    return frac


def key_retain_fraction(node: Node, key: str) -> float:
    """Fraction of ``key``'s domain surviving the leaf's filters, looking
    *through* aggregates: a group key survives grouping, so a filter on it
    below the Aggregate still thins the key set the leaf exposes.
    Below an Aggregate only filters on the group key itself count — a
    predicate on any other input column thins groups sub-proportionally
    (a group survives if any of its rows does), so assuming full retention
    there is the conservative choice."""
    base, filters = filter_chain(node)
    frac = 1.0
    for f in filters:
        frac *= min(max(effective_selectivity(f), 0.0), 1.0)
    if isinstance(base, Project):
        frac *= key_retain_fraction(base.child, key)
    elif isinstance(base, Aggregate) and base.key == key:
        frac *= _key_filter_fraction(base.child, key)
    return frac


def _key_filter_fraction(node: Node, key: str) -> float:
    """Product of selectivities of filters *on ``key`` itself* in a
    subtree, descending through projections and same-key aggregates."""
    base, filters = filter_chain(node)
    frac = 1.0
    for f in filters:
        if f.column == key:
            frac *= min(max(effective_selectivity(f), 0.0), 1.0)
    if isinstance(base, Project):
        frac *= _key_filter_fraction(base.child, key)
    elif isinstance(base, Aggregate) and base.key == key:
        frac *= _key_filter_fraction(base.child, key)
    return frac


#: Filter ops whose survivors form one contiguous interval of the column.
_BAND_OPS = ("eq", "lt", "le", "gt", "ge", "between")


def key_band_fraction(node: Node, key: str) -> Optional[float]:
    """Zone-map applicability test: the estimated width of the interval
    the leaf's surviving ``key`` values span, as a fraction of the domain.

    A leaf is *band-shaped* in its key iff its filter chain constrains the
    key **itself** with range predicates (TPC-DS date windows filter
    ``d_date_sk`` between two dates): the surviving key set is then one
    contiguous interval whose width is the product of those predicates'
    selectivities — the zone map's kept fraction, exactly. Filters on
    other columns thin the key set *within* the band but cannot shrink
    its min/max span, so they do not tighten the estimate. Returns None
    when no range predicate on the key exists (min/max would span ~the
    whole domain — a zone map has nothing to cut)."""
    base, filters = filter_chain(node)
    frac = None
    for f in filters:
        if f.column == key and f.op in _BAND_OPS:
            s = min(max(effective_selectivity(f), 0.0), 1.0)
            frac = s if frac is None else frac * s
    child = None
    if isinstance(base, Project):
        child = key_band_fraction(base.child, key)
    elif isinstance(base, Aggregate) and base.key == key:
        child = key_band_fraction(base.child, key)
    if child is not None:
        frac = child if frac is None else frac * child
    return frac


@dataclasses.dataclass(frozen=True)
class JoinEdge:
    """One equi-join predicate, oriented probe -> build (unique-key side)."""

    probe: int       # leaf index of the probe-side relation
    build: int       # leaf index of the build-side (unique key) relation
    probe_key: str
    build_key: str
    derived: bool = False  # inferred through a key equivalence class


@dataclasses.dataclass
class JoinGraph:
    """A join region: leaves + oriented equi-join edges + the plan's tree.

    ``tree`` is the written join order: either a leaf index or a tuple
    ``(left_tree, right_tree, edge_index)``.
    """

    leaves: list
    edges: list
    tree: object

    @property
    def n(self) -> int:
        return len(self.leaves)


class _ExtractionBailout(Exception):
    """Region not safely reorderable (ambiguous or missing key ownership)."""


def _is_region_join(node: Node) -> bool:
    return (isinstance(node, Join) and node.join_type is JoinType.INNER
            and node.hint is None)


def extract_join_graph(root: Node, schema: Schema) -> Optional[JoinGraph]:
    """Extract the join region rooted at ``root``.

    Returns None when ``root`` is not a reorderable join, when key ownership
    is ambiguous (a join key appearing in several leaves), or when leaves
    share column names (the executor's collision renames would be
    order-dependent).
    """
    if not _is_region_join(root):
        return None
    leaves: list = []
    cols: list = []
    edges: list = []

    def owner(leaf_set, key):
        found = [i for i in leaf_set if key in cols[i]]
        if len(found) != 1:
            raise _ExtractionBailout(key)
        return found[0]

    def leaf_set(tree):
        if isinstance(tree, int):
            return (tree,)
        return leaf_set(tree[0]) + leaf_set(tree[1])

    def go(n):
        if _is_region_join(n):
            lt = go(n.left)
            rt = go(n.right)
            e = JoinEdge(owner(leaf_set(lt), n.left_key),
                         owner(leaf_set(rt), n.right_key),
                         n.left_key, n.right_key)
            edges.append(e)
            return (lt, rt, len(edges) - 1)
        i = len(leaves)
        leaves.append(n)
        cols.append(frozenset(leaf_columns(n, schema)))
        return i

    try:
        tree = go(root)
    except (_ExtractionBailout, KeyError, TypeError):
        return None
    total = sum(len(c) for c in cols)
    if len(frozenset().union(*cols)) != total:  # cross-leaf name collision
        return None
    return JoinGraph(leaves, edges, tree)


def subtree_size(plan: Node) -> int:
    """Operator count of a subtree — the size order cross-query CSE uses
    to execute nested shared subtrees before the subtrees containing them."""
    return 1 + sum(subtree_size(c) for c in plan.children())


def shared_subtree_candidates(plan: Node):
    """Enumerate the subtree occurrences cross-query CSE may dedupe, as
    ``(signature, node)`` pairs (one pair per occurrence — a signature
    appearing twice in one plan yields two pairs).

    A candidate must be *worth sharing* and *safe to share*:

      * **Exchange-rooted** (Join or Aggregate): only subtrees containing
        at least one exchange save network bytes when deduped; scans and
        filter chains are free to re-evaluate.
      * **Region-atomic**: solo execution must evaluate the occurrence as
        a unit for an injected result to be byte-identical. The executor
        flattens maximal hint-free INNER-join regions for reordering and
        leaf-level filter placement (``extract_join_graph``), so an inner
        hint-free join nested *directly under* another inner hint-free
        join is not a unit — it dissolves into its parent's region and
        would be re-ordered/filtered across its own boundary. Every other
        position (under a Filter/Project/Aggregate, under a hinted or
        non-inner join, or at the root) is a region leaf or a region root,
        which the executor evaluates via a single ``_eval`` call.

    Exclusion is conservative: a non-atomic occurrence is merely not
    shared, never shared wrongly.
    """

    def go(node: Node, parent: Optional[Node]):
        if isinstance(node, (Join, Aggregate)):
            dissolves = (_is_region_join(node) and parent is not None
                         and _is_region_join(parent))
            if not dissolves:
                yield signature(node), node
        for child in node.children():
            yield from go(child, node)

    yield from go(plan, None)


def cyclic_core(n: int, pairs) -> frozenset:
    """Cycle detection over a join region: the 2-core of the undirected
    simple graph on ``n`` leaves with the given ``(u, v)`` edge pairs —
    join-graph edges plus the closing column-equality (eqcol) edges.

    Iteratively strips degree-<=1 vertices; whatever survives lies on at
    least one cycle. Returns the surviving leaf set (empty for acyclic
    regions). A triangle or clique query's relations all survive; a star
    or chain strips to nothing — exactly the shapes where the hypercube
    multi-way plan is (resp. is not) worth quoting."""
    adj: dict = {i: set() for i in range(n)}
    for u, v in pairs:
        if u != v:
            adj[u].add(v)
            adj[v].add(u)
    alive = set(range(n))
    changed = True
    while changed:
        changed = False
        for v in list(alive):
            deg = sum(1 for u in adj[v] if u in alive)
            if deg <= 1:
                alive.remove(v)
                changed = True
    return frozenset(alive)


def key_equivalence_classes(graph: JoinGraph):
    """Union-find over (leaf, column) pairs: keys equated by the region's
    equi-join predicates, transitively (paper §2.2's equivalence of join
    attributes across a multi-join query)."""
    parent = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        parent[find(a)] = find(b)

    for e in graph.edges:
        union((e.probe, e.probe_key), (e.build, e.build_key))
    classes = {}
    for x in list(parent):
        classes.setdefault(find(x), set()).add(x)
    return [c for c in classes.values() if len(c) > 1]


def unique_key_sides(graph: JoinGraph):
    """(leaf, column) pairs whose values are unique within the leaf: build
    sides of the written joins (engine contract) plus aggregate group keys."""
    unique = {(e.build, e.build_key) for e in graph.edges}
    for i, leaf in enumerate(graph.leaves):
        base, _ = filter_chain(leaf)
        if isinstance(base, Aggregate):
            unique.add((i, base.key))
    return unique


@dataclasses.dataclass(frozen=True)
class RuntimeFilter:
    """A planned runtime-filter pushdown on one join-graph edge.

    The filter is built over the build leaf's join-key column and applied
    to the probe leaf's key column *at the leaf* — below every exchange the
    probe side subsequently goes through, which is what makes it sideways
    information passing rather than an ordinary join predicate. Edges
    derived through key equivalence classes (``derived=True``) push a
    dimension's filter onto relations it is never directly joined with.

    ``kind`` names the physical filter the planner priced cheapest for the
    edge — ``"bloom"`` (m-bit array, k hashes), ``"zone_map"`` (min/max
    interval) or ``"semi_join"`` (exact sorted key list). ``m_bits`` is the
    *serialized wire size in bits* for every kind (the quantity the cost
    model broadcasts); ``k`` is bloom's hash count, 0 for the others.
    """

    probe: int          # leaf index whose rows are filtered
    build: int          # leaf index whose keys define membership
    probe_key: str
    build_key: str
    m_bits: int         # serialized filter size in bits
    k: int              # hash count (bloom) — 0 for other kinds
    sigma_est: float    # estimated true match fraction of probe rows
    keep_est: float     # planned kept fraction (kind-specific floor)
    benefit: float      # modeled workload saved on the filtered join
    cost: float         # modeled workload of building + shipping the filter
    derived: bool = False
    kind: str = "bloom"
    #: True when the planner found the payload in the cross-query
    #: ``FilterCache`` and quoted the edge at ``cached_filter_cost``
    #: (broadcast only — no build, no reduce tree).
    cached: bool = False


def augment_edges(graph: JoinGraph):
    """Original edges + edges derived through key equivalence classes.

    Any leaf pair (u, v) whose columns fall in one equivalence class may be
    joined directly, provided v's column is unique in v (valid build side).
    This is what lets the DP join e.g. a dimension to an aggregated fact
    before the probe fact arrives.
    """
    seen = {(e.probe, e.build, e.probe_key, e.build_key)
            for e in graph.edges}
    unique = unique_key_sides(graph)
    out = list(graph.edges)
    for cls in key_equivalence_classes(graph):
        members = sorted(cls)
        for u, cu in members:
            for v, cv in members:
                if u == v or (v, cv) not in unique:
                    continue
                if (u, v, cu, cv) not in seen:
                    seen.add((u, v, cu, cv))
                    out.append(JoinEdge(u, v, cu, cv, derived=True))
    return out
