"""SQL text front end, part 2: the binder.

Lowers a parsed :class:`~.parser.SelectStmt` onto the plan algebra
(``sql.logical``), resolving every column reference against the catalog
schema (``datagen.TABLE_COLUMNS`` by default, or any table -> ordered
column tuple mapping):

  * FROM items lower first: tables become :class:`Scan`, derived tables
    bind recursively (a ``SELECT *`` derived table adds no node), explicit
    ``JOIN ... ON`` chains become :class:`Join` nodes with the ON keys
    oriented by column ownership (written order is kept; sides swap only
    when the text lists them build-first),
  * WHERE conjuncts apply in textual order: single-column predicates wrap
    the owning tree in :class:`Filter` (so the last conjunct is outermost),
    column = column equalities merge two FROM trees into an inner
    :class:`Join` (the tree owning the left column probes), and
    ``[NOT] IN (subquery)`` replaces the owning tree with a LEFT_SEMI /
    LEFT_ANTI join against the bound subquery, keyed on the subquery's
    first select item,
  * ``GROUP BY k`` requires the select list ``k, AGG(...), ...`` and
    becomes :class:`Aggregate`; without it a plain column list becomes
    :class:`Project` and ``*`` adds nothing.

Every Filter the binder creates gets its selectivity *baked in* from
:func:`~.selectivity.derive_selectivity`, so parsed plans carry
the same static estimates a hand-built plan would declare.

The port's copy of the JAX package's binder: the same plans (by
``signature``), the same baked selectivities and the same errors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Set, Tuple, Union

from ..core.selection import JoinType
from . import datagen
from .logical import (Aggregate, Filter, Join, Node, Project, Scan,
                      leaf_columns)
from .parser import (AggCall, ColRef, ColumnEquals, Comparison, DerivedRef,
                     FromTree, InList, InSubquery, SelectStmt, TableRef,
                     parse)
from .selectivity import derive_selectivity

__all__ = ["SqlBindError", "bind", "parse_sql"]


class SqlBindError(ValueError):
    """Raised when a parsed statement cannot be resolved against the
    schema: unknown tables/columns, ambiguous references, aggregates
    outside GROUP BY, or FROM items left unjoined."""


#: SQL aggregate name -> Aggregate op name (AVG is the algebra's "mean").
_AGG_MAP = {"SUM": "sum", "COUNT": "count", "MIN": "min", "MAX": "max",
            "AVG": "mean"}


@dataclasses.dataclass
class _Tree:
    """One bound FROM item: its plan subtree, output columns, and the
    relation names (tables / aliases) that qualify into it."""

    node: Node
    columns: Tuple[str, ...]
    names: Set[str]

    def resolves(self, ref: ColRef) -> bool:
        if ref.qualifier is not None and ref.qualifier not in self.names:
            return False
        return ref.name in self.columns


def _stmt_names(stmt: SelectStmt) -> Set[str]:
    """Relation names a statement exposes for qualified references."""
    names: Set[str] = set()
    for tree in stmt.froms:
        for ref in (tree.primary,) + tuple(j.ref for j in tree.joins):
            if isinstance(ref, TableRef):
                names.add(ref.alias or ref.table)
            elif ref.alias is not None:
                names.add(ref.alias)
            else:
                names |= _stmt_names(ref.query)
    return names


class _Binder:
    def __init__(self, schema: Mapping[str, Tuple[str, ...]],
                 key_domains: Optional[Mapping[str, float]]):
        self.schema: Dict[str, Tuple[str, ...]] = {
            t: tuple(cols) for t, cols in schema.items()}
        self.key_domains = key_domains

    # -- helpers ------------------------------------------------------------

    def columns_of(self, node: Node) -> Tuple[str, ...]:
        return tuple(leaf_columns(node, self.schema))

    def make_filter(self, child: Node, column: str, op: str,
                    value: float = 0.0, value2: float = 0.0,
                    values: Tuple[float, ...] = ()) -> Filter:
        f = Filter(child, column, op, value, value2, values)
        return dataclasses.replace(
            f, selectivity=derive_selectivity(f, self.key_domains))

    def lower_ref(self, ref: Union[TableRef, DerivedRef]) -> _Tree:
        if isinstance(ref, TableRef):
            if ref.table not in self.schema:
                raise SqlBindError(f"unknown table {ref.table!r}")
            node: Node = Scan(ref.table)
            names = {ref.alias or ref.table}
        else:
            node = self.bind_stmt(ref.query)
            names = ({ref.alias} if ref.alias is not None
                     else _stmt_names(ref.query))
        return _Tree(node, self.columns_of(node), names)

    def owner(self, trees: List[_Tree], ref: ColRef) -> int:
        found = [i for i, t in enumerate(trees) if t.resolves(ref)]
        if not found:
            raise SqlBindError(f"unknown column {_ref_str(ref)}")
        if len(found) > 1:
            raise SqlBindError(f"ambiguous column {_ref_str(ref)}")
        return found[0]

    # -- FROM ---------------------------------------------------------------

    def lower_from_tree(self, tree: FromTree) -> _Tree:
        acc = self.lower_ref(tree.primary)
        for jc in tree.joins:
            right = self.lower_ref(jc.ref)
            if acc.resolves(jc.left_col) and right.resolves(jc.right_col):
                probe_key, build_key = jc.left_col.name, jc.right_col.name
            elif acc.resolves(jc.right_col) and right.resolves(jc.left_col):
                probe_key, build_key = jc.right_col.name, jc.left_col.name
            else:
                raise SqlBindError(
                    f"ON {_ref_str(jc.left_col)} = {_ref_str(jc.right_col)}"
                    " does not link the joined relations")
            jt = (JoinType.LEFT_OUTER if jc.kind == "left"
                  else JoinType.INNER)
            node = Join(acc.node, right.node, probe_key, build_key,
                        join_type=jt)
            acc = _Tree(node, self.columns_of(node), acc.names | right.names)
        return acc

    # -- WHERE --------------------------------------------------------------

    def apply_where(self, trees: List[_Tree], preds) -> None:
        for pred in preds:
            if isinstance(pred, Comparison):
                i = self.owner(trees, pred.col)
                node = self.make_filter(trees[i].node, pred.col.name,
                                        pred.op, pred.value, pred.value2)
                trees[i] = _Tree(node, trees[i].columns, trees[i].names)
            elif isinstance(pred, InList):
                i = self.owner(trees, pred.col)
                node = self.make_filter(trees[i].node, pred.col.name, "in",
                                        values=pred.values)
                trees[i] = _Tree(node, trees[i].columns, trees[i].names)
            elif isinstance(pred, InSubquery):
                i = self.owner(trees, pred.col)
                sub = self.bind_stmt(pred.query, as_subquery=True)
                key = _subquery_key(pred.query)
                jt = (JoinType.LEFT_ANTI if pred.negated
                      else JoinType.LEFT_SEMI)
                node = Join(trees[i].node, sub, pred.col.name, key,
                            join_type=jt)
                # Semi/anti output keeps only the probe side's columns.
                trees[i] = _Tree(node, trees[i].columns, trees[i].names)
            elif isinstance(pred, ColumnEquals):
                li = self.owner(trees, pred.left)
                ri = self.owner(trees, pred.right)
                if li == ri:
                    raise SqlBindError(
                        f"{_ref_str(pred.left)} = {_ref_str(pred.right)}"
                        " relates columns of one relation; only"
                        " cross-relation join predicates are supported")
                node = Join(trees[li].node, trees[ri].node, pred.left.name,
                            pred.right.name)
                merged = _Tree(node, self.columns_of(node),
                               trees[li].names | trees[ri].names)
                trees[li] = merged
                del trees[ri]
            else:  # pragma: no cover - parser emits no other predicate
                raise SqlBindError(f"unsupported predicate {pred!r}")

    # -- SELECT / GROUP BY --------------------------------------------------

    def bind_stmt(self, stmt: SelectStmt, as_subquery: bool = False) -> Node:
        trees = [self.lower_from_tree(t) for t in stmt.froms]
        self.apply_where(trees, stmt.where)
        if len(trees) != 1:
            raise SqlBindError(
                f"{len(trees)} FROM items remain unjoined — comma-listed"
                " relations must be linked by WHERE equality predicates")
        tree = trees[0]

        if stmt.group_by is not None:
            return self.bind_group_by(stmt, tree)

        if stmt.star:
            return tree.node
        cols = []
        for item in stmt.items:
            if isinstance(item, AggCall):
                raise SqlBindError(
                    f"{item.func}({item.column}) requires GROUP BY")
            if not tree.resolves(item):
                raise SqlBindError(f"unknown column {_ref_str(item)}")
            cols.append(item.name)
        if as_subquery:
            # Dialect rule: an IN-subquery's select list only names its
            # key; no Project is planted around the subquery tree.
            return tree.node
        return Project(tree.node, tuple(cols))

    def bind_group_by(self, stmt: SelectStmt, tree: _Tree) -> Node:
        key = stmt.group_by
        assert key is not None
        if key not in tree.columns:
            raise SqlBindError(f"unknown group-by column {key!r}")
        if stmt.star or not stmt.items:
            raise SqlBindError("GROUP BY requires an explicit select list")
        first = stmt.items[0]
        if not isinstance(first, ColRef) or first.name != key:
            raise SqlBindError(
                f"the first select item must be the group key {key!r}")
        aggs = []
        for item in stmt.items[1:]:
            if not isinstance(item, AggCall):
                raise SqlBindError(
                    "select items after the group key must be aggregates")
            if item.column not in tree.columns:
                raise SqlBindError(
                    f"unknown aggregate column {item.column!r}")
            aggs.append((item.column, _AGG_MAP[item.func]))
        if not aggs:
            raise SqlBindError("GROUP BY requires at least one aggregate")
        return Aggregate(tree.node, key, tuple(aggs))


def _ref_str(ref: ColRef) -> str:
    return f"{ref.qualifier}.{ref.name}" if ref.qualifier else ref.name


def _subquery_key(stmt: SelectStmt) -> str:
    """The join key an IN-subquery exposes: its first select item."""
    if stmt.star or not stmt.items:
        raise SqlBindError(
            "an IN subquery must name its key as the first select item")
    first = stmt.items[0]
    if not isinstance(first, ColRef):
        raise SqlBindError(
            "an IN subquery's first select item must be a plain column")
    return first.name


def bind(stmt: SelectStmt,
         schema: Optional[Mapping[str, Tuple[str, ...]]] = None,
         key_domains: Optional[Mapping[str, float]] = None) -> Node:
    """Lower a parsed statement to a logical plan.

    ``schema`` maps table name -> ordered output columns (defaults to the
    synthetic catalog's ``datagen.TABLE_COLUMNS``); ``key_domains``
    optionally overrides the FK/PK domain sizes used when baking filter
    selectivities (e.g. a live ``Catalog.key_domains``).
    """
    return _Binder(schema or datagen.TABLE_COLUMNS,
                   key_domains).bind_stmt(stmt)


def parse_sql(text: str,
              schema: Optional[Mapping[str, Tuple[str, ...]]] = None,
              key_domains: Optional[Mapping[str, float]] = None) -> Node:
    """Parse SQL text and bind it to a logical plan in one step."""
    return bind(parse(text), schema, key_domains)
