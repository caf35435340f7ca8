"""SQL text front end, part 1: hand-written tokenizer + recursive-descent
parser producing a small AST (``SelectStmt``). The binder (``sql.binder``)
lowers the AST to the ``logical.py`` plan algebra.

The port's copy of the JAX package's parser (pure Python, no tensors): the
same dialect, the same AST fields and the same error messages, positions
included. Supported surface (see docs/sql_frontend.md for the full
grammar):

  * ``SELECT`` list: ``*``, plain columns, aggregate calls
    (``SUM/COUNT/MIN/MAX/AVG``),
  * ``FROM``: tables, derived tables ``(SELECT ...) [AS alias]``, explicit
    ``JOIN ... ON a = b`` / ``LEFT JOIN ... ON`` chains, and implicit
    comma joins,
  * ``WHERE``: conjunctions (``AND``) of single-column comparisons
    (``= <> < <= > >=``), ``BETWEEN x AND y``, ``IN (literal list)``,
    ``[NOT] IN (subquery)`` (semi/anti joins), and column = column
    equality (implicit join predicates),
  * ``GROUP BY`` a single column.

The dialect is deliberately small — exactly the plan algebra's expressive
range — and everything outside it raises ``SqlSyntaxError`` with the
offending position rather than mis-parsing.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple, Union

__all__ = ["AGG_FUNCS", "AggCall", "ColRef", "ColumnEquals", "Comparison",
           "DerivedRef", "FromTree", "InList", "InSubquery", "JoinClause",
           "KEYWORDS", "SelectStmt", "SqlSyntaxError", "TableRef", "Token",
           "parse", "tokenize"]


class SqlSyntaxError(ValueError):
    """Raised on any text the dialect does not cover."""


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ColRef:
    """A (possibly qualified) column reference: ``col`` or ``tab.col``."""

    name: str
    qualifier: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class AggCall:
    """One aggregate select item. ``func`` is the SQL name (upper-cased)."""

    func: str
    column: str


@dataclasses.dataclass(frozen=True)
class Comparison:
    """``col op literal`` (op in eq/ne/lt/le/gt/ge/between)."""

    col: ColRef
    op: str
    value: float
    value2: float = 0.0


@dataclasses.dataclass(frozen=True)
class InList:
    """``col IN (v1, v2, ...)`` over literals."""

    col: ColRef
    values: Tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class InSubquery:
    """``col [NOT] IN (SELECT ...)`` — lowers to a semi/anti join."""

    col: ColRef
    query: "SelectStmt"
    negated: bool


@dataclasses.dataclass(frozen=True)
class ColumnEquals:
    """``col1 = col2`` — an implicit equi-join predicate."""

    left: ColRef
    right: ColRef


@dataclasses.dataclass(frozen=True)
class TableRef:
    table: str
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DerivedRef:
    query: "SelectStmt"
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class JoinClause:
    """One ``[LEFT] JOIN ref ON left = right`` link in a FROM chain."""

    kind: str  # "inner" | "left"
    ref: Union[TableRef, DerivedRef]
    left_col: ColRef
    right_col: ColRef


@dataclasses.dataclass(frozen=True)
class FromTree:
    """One comma-separated FROM item: a primary plus its JOIN chain."""

    primary: Union[TableRef, DerivedRef]
    joins: Tuple[JoinClause, ...] = ()


Predicate = Union[Comparison, InList, InSubquery, ColumnEquals]
SelectItem = Union[ColRef, AggCall]


@dataclasses.dataclass(frozen=True)
class SelectStmt:
    """One parsed SELECT statement (the AST root)."""

    items: Tuple[SelectItem, ...]   # empty iff star
    star: bool
    froms: Tuple[FromTree, ...]
    where: Tuple[Predicate, ...] = ()
    group_by: Optional[str] = None


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Token:
    kind: str   # "ident" | "number" | "symbol" | "eof"
    text: str
    pos: int


_TOKEN_RE = re.compile(r"""
    \s+
  | (?P<number>-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<symbol><>|<=|>=|[(),.*=<>])
""", re.VERBOSE)

KEYWORDS = frozenset({
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "JOIN", "LEFT", "OUTER",
    "ON", "AND", "BETWEEN", "IN", "NOT", "AS",
})

#: SQL aggregate function names the select list accepts.
AGG_FUNCS = ("SUM", "COUNT", "MIN", "MAX", "AVG")

_COMPARISON_OPS = {"=": "eq", "<>": "ne", "<": "lt", "<=": "le",
                   ">": "gt", ">=": "ge"}


def tokenize(text: str) -> list:
    """Scan ``text`` into tokens; raises on any unrecognized character."""
    out = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise SqlSyntaxError(
                f"unrecognized character {text[pos]!r} at position {pos}")
        if m.lastgroup == "number":
            out.append(Token("number", m.group("number"), pos))
        elif m.lastgroup == "ident":
            out.append(Token("ident", m.group("ident"), pos))
        elif m.lastgroup == "symbol":
            out.append(Token("symbol", m.group("symbol"), pos))
        pos = m.end()
    out.append(Token("eof", "", len(text)))
    return out


# ---------------------------------------------------------------------------
# Recursive-descent parser
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.tokens = tokenize(text)
        self.i = 0

    # -- token plumbing -----------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        return self.tokens[min(self.i + ahead, len(self.tokens) - 1)]

    def advance(self) -> Token:
        tok = self.tokens[self.i]
        if tok.kind != "eof":
            self.i += 1
        return tok

    def error(self, message: str) -> SqlSyntaxError:
        tok = self.peek()
        at = f"{tok.text!r}" if tok.kind != "eof" else "end of input"
        return SqlSyntaxError(f"{message} (at {at}, position {tok.pos})")

    def at_keyword(self, word: str) -> bool:
        tok = self.peek()
        return tok.kind == "ident" and tok.text.upper() == word

    def accept_keyword(self, word: str) -> bool:
        if self.at_keyword(word):
            self.advance()
            return True
        return False

    def expect_keyword(self, word: str) -> None:
        if not self.accept_keyword(word):
            raise self.error(f"expected {word}")

    def accept_symbol(self, sym: str) -> bool:
        tok = self.peek()
        if tok.kind == "symbol" and tok.text == sym:
            self.advance()
            return True
        return False

    def expect_symbol(self, sym: str) -> None:
        if not self.accept_symbol(sym):
            raise self.error(f"expected {sym!r}")

    def expect_ident(self, what: str) -> str:
        tok = self.peek()
        if tok.kind != "ident" or tok.text.upper() in KEYWORDS:
            raise self.error(f"expected {what}")
        return self.advance().text

    def expect_number(self) -> float:
        tok = self.peek()
        if tok.kind != "number":
            raise self.error("expected a numeric literal")
        return float(self.advance().text)

    # -- grammar ------------------------------------------------------------

    def parse(self) -> SelectStmt:
        stmt = self.select_stmt()
        if self.peek().kind != "eof":
            raise self.error("trailing input after statement")
        return stmt

    def select_stmt(self) -> SelectStmt:
        self.expect_keyword("SELECT")
        star, items = False, []
        if self.accept_symbol("*"):
            star = True
        else:
            items.append(self.select_item())
            while self.accept_symbol(","):
                items.append(self.select_item())
        self.expect_keyword("FROM")
        froms = [self.from_tree()]
        while self.accept_symbol(","):
            froms.append(self.from_tree())
        where: list = []
        if self.accept_keyword("WHERE"):
            where.append(self.predicate())
            while self.accept_keyword("AND"):
                where.append(self.predicate())
        group_by = None
        if self.accept_keyword("GROUP"):
            self.expect_keyword("BY")
            group_by = self.expect_ident("a group-by column")
        return SelectStmt(tuple(items), star, tuple(froms), tuple(where),
                          group_by)

    def select_item(self) -> SelectItem:
        tok = self.peek()
        if (tok.kind == "ident" and tok.text.upper() in AGG_FUNCS
                and self.peek(1).kind == "symbol"
                and self.peek(1).text == "("):
            func = self.advance().text.upper()
            self.expect_symbol("(")
            col = self.expect_ident("an aggregate argument column")
            self.expect_symbol(")")
            return AggCall(func, col)
        return self.col_ref()

    def col_ref(self) -> ColRef:
        first = self.expect_ident("a column name")
        if self.accept_symbol("."):
            return ColRef(self.expect_ident("a column name"), first)
        return ColRef(first)

    def from_tree(self) -> FromTree:
        primary = self.primary()
        joins = []
        while True:
            if self.accept_keyword("JOIN"):
                kind = "inner"
            elif self.at_keyword("LEFT"):
                self.advance()
                self.accept_keyword("OUTER")
                self.expect_keyword("JOIN")
                kind = "left"
            else:
                break
            ref = self.primary()
            self.expect_keyword("ON")
            left = self.col_ref()
            self.expect_symbol("=")
            right = self.col_ref()
            joins.append(JoinClause(kind, ref, left, right))
        return FromTree(primary, tuple(joins))

    def primary(self) -> Union[TableRef, DerivedRef]:
        if self.accept_symbol("("):
            stmt = self.select_stmt()
            self.expect_symbol(")")
            return DerivedRef(stmt, self.maybe_alias())
        table = self.expect_ident("a table name")
        return TableRef(table, self.maybe_alias())

    def maybe_alias(self) -> Optional[str]:
        if self.accept_keyword("AS"):
            return self.expect_ident("an alias")
        tok = self.peek()
        if tok.kind == "ident" and tok.text.upper() not in KEYWORDS:
            return self.advance().text
        return None

    def predicate(self) -> Predicate:
        col = self.col_ref()
        negated = self.accept_keyword("NOT")
        if self.accept_keyword("IN"):
            return self.in_predicate(col, negated)
        if negated:
            raise self.error("NOT is only supported as NOT IN")
        if self.accept_keyword("BETWEEN"):
            lo = self.expect_number()
            self.expect_keyword("AND")
            hi = self.expect_number()
            return Comparison(col, "between", lo, hi)
        tok = self.peek()
        if tok.kind == "symbol" and tok.text in _COMPARISON_OPS:
            op = _COMPARISON_OPS[self.advance().text]
            if self.peek().kind == "number":
                return Comparison(col, op, self.expect_number())
            if op == "eq":
                return ColumnEquals(col, self.col_ref())
            raise self.error("column-to-column predicates support only =")
        raise self.error("expected a comparison operator, BETWEEN or IN")

    def in_predicate(self, col: ColRef, negated: bool) -> Predicate:
        self.expect_symbol("(")
        if self.at_keyword("SELECT"):
            stmt = self.select_stmt()
            self.expect_symbol(")")
            return InSubquery(col, stmt, negated)
        if negated:
            raise self.error("NOT IN is only supported with a subquery")
        values = [self.expect_number()]
        while self.accept_symbol(","):
            values.append(self.expect_number())
        self.expect_symbol(")")
        return InList(col, tuple(values))


def parse(text: str) -> SelectStmt:
    """Parse one SELECT statement into its AST."""
    return _Parser(text).parse()
