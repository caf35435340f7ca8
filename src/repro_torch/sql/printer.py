"""SQL pretty-printer: render a logical plan back to dialect text.

The inverse of the front end for binder-producible plans: for any plan the
binder can emit, ``parse_sql(to_sql(plan))`` binds to a plan with the same
signature (and the same execution result — the property test pins both).
Declared filter selectivities are the one lossy part: SQL has no syntax for
them, so a reparse bakes the schema-derived estimate instead.

Rendering rules mirror the binder's lowering in reverse:

  * a top-of-tree Filter chain becomes the WHERE clause (innermost filter
    printed first, so textual re-application nests identically),
  * LEFT_SEMI / LEFT_ANTI joins become ``[NOT] IN (subquery)`` predicates,
  * INNER / LEFT_OUTER chains become explicit ``JOIN ... ON`` lists, with
    any non-Scan side parenthesized as a derived table,
  * Aggregate becomes ``SELECT key, AGG(col), ... GROUP BY key`` and
    Project a plain column list.

Literals render via ``repr`` (shortest exact float round-trip), so parsed
constants — and therefore plan signatures — are preserved bit-for-bit.
The port's copy of the JAX package's printer: the same text for the same
plan.
"""

from __future__ import annotations

from typing import List, Tuple

from ..core.selection import JoinType
from .logical import Aggregate, Filter, Join, Node, Project, Scan, filter_chain

__all__ = ["to_sql"]

_OP_SQL = {"eq": "=", "ne": "<>", "lt": "<", "le": "<=", "gt": ">",
           "ge": ">="}
_AGG_SQL = {"sum": "SUM", "count": "COUNT", "min": "MIN", "max": "MAX",
            "mean": "AVG"}


def _lit(v: float) -> str:
    return repr(float(v))


def _pred_sql(f: Filter) -> str:
    if f.op == "between":
        return f"{f.column} BETWEEN {_lit(f.value)} AND {_lit(f.value2)}"
    if f.op == "in":
        if not f.values:
            raise ValueError("cannot print an IN filter with no values")
        return f"{f.column} IN ({', '.join(_lit(v) for v in f.values)})"
    return f"{f.column} {_OP_SQL[f.op]} {_lit(f.value)}"


def _from_and_where(node: Node) -> Tuple[str, List[str]]:
    """Split a subtree into a FROM clause and its WHERE conjuncts, in the
    textual order whose re-binding rebuilds this exact subtree."""
    base, filters = filter_chain(node)  # outermost-first
    preds = [_pred_sql(f) for f in reversed(filters)]
    if isinstance(base, Join) and base.join_type in (JoinType.LEFT_SEMI,
                                                     JoinType.LEFT_ANTI):
        from_sql, inner = _from_and_where(base.left)
        op = "NOT IN" if base.join_type is JoinType.LEFT_ANTI else "IN"
        sub = _subquery_sql(base.right, base.right_key)
        return from_sql, inner + [f"{base.left_key} {op} ({sub})"] + preds
    return _chain_sql(base), preds


def _chain_sql(node: Node) -> str:
    """An INNER / LEFT OUTER join chain as explicit JOIN ... ON text."""
    if isinstance(node, Join) and node.join_type in (JoinType.INNER,
                                                     JoinType.LEFT_OUTER):
        kw = "LEFT JOIN" if node.join_type is JoinType.LEFT_OUTER else "JOIN"
        return (f"{_chain_sql(node.left)} {kw} {_rel_sql(node.right)}"
                f" ON {node.left_key} = {node.right_key}")
    return _rel_sql(node)


def _rel_sql(node: Node) -> str:
    """One FROM relation: a bare table name or a derived table."""
    if isinstance(node, Scan):
        return node.table
    return f"({to_sql(node)})"


def _subquery_sql(node: Node, key: str) -> str:
    """The text of an IN-subquery exposing ``key`` as its first item."""
    if isinstance(node, Aggregate) and node.key == key:
        return to_sql(node)
    from_sql, preds = _from_and_where(node)
    return f"SELECT {key} FROM {from_sql}{_where_sql(preds)}"


def _where_sql(preds: List[str]) -> str:
    return f" WHERE {' AND '.join(preds)}" if preds else ""


def to_sql(plan: Node) -> str:
    """Render a logical plan as one SELECT statement of the dialect."""
    if isinstance(plan, Aggregate):
        if not plan.aggs:
            raise ValueError("cannot print an Aggregate with no aggregates")
        from_sql, preds = _from_and_where(plan.child)
        items = ", ".join([plan.key] + [f"{_AGG_SQL[op]}({col})"
                                        for col, op in plan.aggs])
        return (f"SELECT {items} FROM {from_sql}{_where_sql(preds)}"
                f" GROUP BY {plan.key}")
    if isinstance(plan, Project):
        from_sql, preds = _from_and_where(plan.child)
        return (f"SELECT {', '.join(plan.columns)} FROM {from_sql}"
                f"{_where_sql(preds)}")
    from_sql, preds = _from_and_where(plan)
    return f"SELECT * FROM {from_sql}{_where_sql(preds)}"
