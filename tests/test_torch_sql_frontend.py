"""The port's SQL text front end against the JAX package's, on the CPU.

For every one of the 34 ``SQL_TEXTS``: the same tokens, the same AST (the
two packages' dataclasses compared field by field, under their class
names), the same plan signature and effective selectivities after binding,
and the same ``to_sql`` text. The reference's tokenizer, parser and binder
units and error cases run on the port, and every error message equals the
reference's, positions included. The registries (``all_queries`` and the
rest) come from the texts, as the reference's do; q1-q23 stay
signature-identical to their hand-built plans. The printer's reparse
property runs on the port's ``Executor``.
"""

import dataclasses
import random

import numpy as np
import pytest

from helpers.hypothesis_compat import given, settings
from helpers.hypothesis_compat import strategies as st
from repro import sql as jsql
from repro.sql import parser as jparser
from repro.sql.logical import effective_selectivity as j_effective_selectivity
from repro.sql.logical import signature as j_signature
from repro.sql.logical import walk as j_walk
from repro.sql.queries import HAND_BUILT as J_HAND_BUILT
from repro.sql.queries import SQL_TEXTS as J_SQL_TEXTS
from repro_torch import sql as tsql
from repro_torch.sql import (Executor, RelJoinStrategy, generate, parse,
                             parse_sql, to_sql, tokenize)
from repro_torch.sql.binder import SqlBindError
from repro_torch.sql.datagen import COLUMN_DOMAINS, TABLE_COLUMNS
from repro_torch.sql.logical import (Aggregate, Filter, Join, Scan,
                                     effective_selectivity, signature, walk)
from repro_torch.sql.parser import (AggCall, ColRef, ColumnEquals,
                                    Comparison, InList, InSubquery,
                                    SqlSyntaxError)
from repro_torch.sql.queries import HAND_BUILT, SQL_TEXTS

TEXTS = sorted(SQL_TEXTS)


def ast(x):
    """A package-neutral form of a parsed statement: each dataclass as its
    class name and its fields, recursively."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, ast(getattr(x, f.name))) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(ast(v) for v in x)
    return x


def selectivities(plan, is_filter, eff, walker):
    return [eff(f) for f in walker(plan) if is_filter(f)]


def port_sel(plan):
    return selectivities(plan, lambda f: isinstance(f, Filter),
                         effective_selectivity, walk)


def ref_sel(plan):
    return selectivities(plan, lambda f: type(f).__name__ == "Filter",
                         j_effective_selectivity, j_walk)


# ---------------------------------------------------------------------------
# The 34 texts against the reference
# ---------------------------------------------------------------------------

def test_sql_texts_and_hand_built_names_equal_reference():
    assert SQL_TEXTS == J_SQL_TEXTS
    assert len(SQL_TEXTS) == 34
    assert sorted(HAND_BUILT) == sorted(J_HAND_BUILT)
    assert len(HAND_BUILT) == 23


@pytest.mark.parametrize("qname", TEXTS)
def test_tokens_and_ast_equal_reference(qname):
    text = SQL_TEXTS[qname]
    assert ([(t.kind, t.text, t.pos) for t in tokenize(text)]
            == [(t.kind, t.text, t.pos) for t in jparser.tokenize(text)])
    assert ast(parse(text)) == ast(jparser.parse(text))


@pytest.mark.parametrize("qname", TEXTS)
def test_bound_plan_equals_reference(qname):
    got, want = parse_sql(SQL_TEXTS[qname]), jsql.parse_sql(SQL_TEXTS[qname])
    assert signature(got) == j_signature(want)
    assert port_sel(got) == pytest.approx(ref_sel(want))
    assert len(port_sel(got)) == len(ref_sel(want))


@pytest.mark.parametrize("qname", TEXTS)
def test_to_sql_prints_the_reference_text(qname):
    got = to_sql(parse_sql(SQL_TEXTS[qname]))
    assert got == jsql.to_sql(jsql.parse_sql(SQL_TEXTS[qname]))
    assert signature(parse_sql(got)) == signature(parse_sql(SQL_TEXTS[qname]))


@pytest.mark.parametrize("qname", sorted(HAND_BUILT))
def test_hand_built_prints_the_reference_text(qname):
    assert to_sql(HAND_BUILT[qname]()) == jsql.to_sql(J_HAND_BUILT[qname]())


# ---------------------------------------------------------------------------
# The registries come from the texts
# ---------------------------------------------------------------------------

REGISTRIES = ("all_queries", "misordered_queries", "skewed_queries",
              "filtered_queries", "text_queries", "service_queries",
              "every_query", "cyclic_queries")


@pytest.mark.parametrize("registry", REGISTRIES)
def test_registry_equals_reference(registry):
    got, want = getattr(tsql, registry)(), getattr(jsql, registry)()
    assert list(got) == list(want)
    for name, plan in got.items():
        assert signature(plan) == j_signature(want[name]), name
        assert port_sel(plan) == pytest.approx(ref_sel(want[name])), name


@pytest.mark.parametrize("registry", [r for r in REGISTRIES
                                      if r != "cyclic_queries"])
def test_registry_plans_are_parsed_from_the_texts(registry):
    """Each plan is ``parse_sql`` of its text: derived selectivities, not
    the hand-built plans' hand-set ones."""
    for name, plan in getattr(tsql, registry)().items():
        parsed = parse_sql(SQL_TEXTS[name])
        assert plan == parsed, name


def test_suite_sizes():
    assert len(tsql.text_queries()) == 11
    assert set(tsql.text_queries()) == set(SQL_TEXTS) - set(HAND_BUILT)
    assert sorted(tsql.skewed_queries()) == [
        "q16_hot_customer", "q17_hot_customer_star",
        "q18_hot_catalog_customer"]
    assert len(tsql.service_queries()) == 7
    every = {**tsql.all_queries(), **tsql.misordered_queries(),
             **tsql.skewed_queries(), **tsql.filtered_queries(),
             **tsql.text_queries(), **tsql.cyclic_queries()}
    assert len(every) == 37


# ---------------------------------------------------------------------------
# q1-q23 round trip: the texts and the hand-built constructors are the same
# plans — same signature, same effective selectivities.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qname", sorted(HAND_BUILT))
def test_sql_matches_hand_built(qname):
    hand = HAND_BUILT[qname]()
    parsed = parse_sql(SQL_TEXTS[qname])
    assert signature(parsed) == signature(hand)
    assert port_sel(parsed) == pytest.approx(port_sel(hand))
    assert signature(hand) == j_signature(J_HAND_BUILT[qname]())


# ---------------------------------------------------------------------------
# Tokenizer and parser units
# ---------------------------------------------------------------------------

def test_tokenize_kinds_and_positions():
    toks = tokenize("SELECT x FROM t WHERE a <= -1.5e2")
    kinds = [(t.kind, t.text) for t in toks]
    assert ("symbol", "<=") in kinds
    assert ("number", "-1.5e2") in kinds
    assert kinds[-1] == ("eof", "")
    assert toks[0].pos == 0 and toks[1].pos == 7


def test_parse_select_items_and_group_by():
    stmt = parse("SELECT k, SUM(v), AVG(w) FROM t GROUP BY k")
    assert stmt.items == (ColRef("k"), AggCall("SUM", "v"),
                          AggCall("AVG", "w"))
    assert stmt.group_by == "k" and not stmt.star


def test_parse_where_predicates():
    stmt = parse("SELECT * FROM t WHERE a = 1 AND b BETWEEN 2 AND 3"
                 " AND c IN (4, 5) AND t.d = u.e")
    a, b, c, d = stmt.where
    assert a == Comparison(ColRef("a"), "eq", 1.0)
    assert b == Comparison(ColRef("b"), "between", 2.0, 3.0)
    assert c == InList(ColRef("c"), (4.0, 5.0))
    assert d == ColumnEquals(ColRef("d", "t"), ColRef("e", "u"))


def test_parse_in_subquery_and_not_in():
    stmt = parse("SELECT * FROM t WHERE a NOT IN (SELECT b FROM u)")
    (pred,) = stmt.where
    assert isinstance(pred, InSubquery) and pred.negated
    assert pred.query.items == (ColRef("b"),)


def test_parse_join_kinds_and_aliases():
    stmt = parse("SELECT * FROM t AS x LEFT OUTER JOIN u y ON a = b JOIN"
                 " (SELECT * FROM v) AS z ON c = d")
    (tree,) = stmt.froms
    assert tree.primary.alias == "x"
    assert [j.kind for j in tree.joins] == ["left", "inner"]
    assert tree.joins[1].ref.alias == "z"


def _message(fn, text, error):
    with pytest.raises(error) as info:
        fn(text)
    return str(info.value)


@pytest.mark.parametrize("bad, msg", [
    ("SELECT @ FROM t", "unrecognized character"),
    ("SELECT * FROM t extra garbage ON", "trailing input"),
    ("SELECT * FROM t WHERE a NOT = 1", "NOT is only supported"),
    ("SELECT * FROM t WHERE a < b", "support only ="),
    ("SELECT * FROM t WHERE a NOT IN (1, 2)", "only supported with a"),
    ("SELECT FROM t", "expected a column name"),
    ("SELECT * FROM t WHERE a BETWEEN 1", "expected AND"),
    ("SELECT * FROM t WHERE a IN (1, )", "expected a numeric literal"),
    ("SELECT * FROM", "expected a table name"),
    ("SELECT * FROM (SELECT * FROM t", "expected ')'"),
    ("SELECT * FROM t GROUP k", "expected BY"),
    ("SELECT * FROM t WHERE a", "expected a comparison operator"),
])
def test_parse_errors_equal_reference(bad, msg):
    got = _message(parse, bad, SqlSyntaxError)
    assert msg in got
    assert got == _message(jparser.parse, bad, jparser.SqlSyntaxError)


@pytest.mark.parametrize("bad, msg", [
    ("SELECT * FROM nope", "unknown table"),
    ("SELECT nope FROM item", "unknown column"),
    ("SELECT * FROM item WHERE nope = 1", "unknown column"),
    ("SELECT SUM(i_price) FROM item", "requires GROUP BY"),
    ("SELECT * FROM item, store", "unjoined"),
    ("SELECT * FROM item WHERE i_item_sk = i_brand", "one relation"),
    ("SELECT i_brand FROM item GROUP BY i_category",
     "first select item must be the group key"),
    ("SELECT i_category, i_brand FROM item GROUP BY i_category",
     "must be aggregates"),
    ("SELECT i_category FROM item GROUP BY i_category",
     "at least one aggregate"),
    ("SELECT * FROM item WHERE i_item_sk IN (SELECT * FROM store_sales)",
     "first select item"),
    ("SELECT * FROM store_sales, store_sales WHERE ss_quantity = 1",
     "ambiguous column"),
    ("SELECT * FROM store_sales JOIN item ON ss_item_sk = s_store_sk",
     "does not link"),
    ("SELECT i_category, SUM(nope) FROM item GROUP BY i_category",
     "unknown aggregate column"),
    ("SELECT i_category, SUM(i_price) FROM item GROUP BY nope",
     "unknown group-by column"),
])
def test_bind_errors_equal_reference(bad, msg):
    got = _message(parse_sql, bad, SqlBindError)
    assert msg in got
    assert got == _message(jsql.parse_sql, bad, jsql.SqlBindError)


def test_bind_qualified_columns_and_on_swap():
    plan = parse_sql("SELECT * FROM store_sales"
                     " JOIN item ON item.i_item_sk = store_sales.ss_item_sk")
    assert isinstance(plan, Join)
    # written build-first; the binder re-orients probe -> build
    assert (plan.left_key, plan.right_key) == ("ss_item_sk", "i_item_sk")


def test_bind_bakes_derived_selectivity_and_maps_avg_to_mean():
    plan = parse_sql("SELECT * FROM date_dim WHERE d_month = 6")
    assert isinstance(plan, Filter)
    assert plan.selectivity == pytest.approx(1 / 12)
    agg = parse_sql("SELECT i_brand, AVG(i_price) FROM item GROUP BY i_brand")
    assert isinstance(agg, Aggregate) and agg.aggs == (("i_price", "mean"),)


def test_bind_lowers_left_join_and_in_subqueries():
    from repro_torch.core.selection import JoinType
    q = tsql.text_queries()
    outer = q["q26_outer_agg"].child
    assert isinstance(outer, Join) and outer.join_type is JoinType.LEFT_OUTER
    semi = q["q27_semi_rich"].child
    assert isinstance(semi, Join) and semi.join_type is JoinType.LEFT_SEMI
    assert isinstance(semi.right, Aggregate)
    anti = q["q28_anti_catalog"].child
    assert isinstance(anti, Join) and anti.join_type is JoinType.LEFT_ANTI


def test_schema_tables_equal_generate():
    catalog = generate(scale=0.02, p=2, seed=7, device="cpu")
    got = {name: tuple(t.columns) for name, t in catalog.tables.items()}
    assert got == dict(TABLE_COLUMNS)
    for col, (lo, hi, integral) in COLUMN_DOMAINS.items():
        table = next(t for t, cols in TABLE_COLUMNS.items() if col in cols)
        t = catalog.tables[table]
        vals = t.column(col)[t.valid].numpy()
        assert vals.min() >= lo and vals.max() < hi, col
        if integral:
            assert np.all(vals == np.floor(vals)), col


# ---------------------------------------------------------------------------
# Printer property test: random valid plans -> SQL -> reparse gives the
# same signature and the same executed rows on the port's Executor.
# ---------------------------------------------------------------------------

_FACT_DIMS = [("ss_item_sk", "item", "i_item_sk"),
              ("ss_store_sk", "store", "s_store_sk"),
              ("ss_customer_sk", "customer", "c_customer_sk"),
              ("ss_sold_date_sk", "date_dim", "d_date_sk"),
              ("ss_promo_sk", "promotion", "p_promo_sk")]
_FILTER_COLS = {"store_sales": ("ss_quantity", 1, 100),
                "item": ("i_category", 0, 10),
                "store": ("s_state", 0, 12),
                "customer": ("c_region", 0, 8),
                "date_dim": ("d_moy", 0, 30),
                "promotion": ("p_channel", 0, 4)}
_GROUP_KEYS = {"store_sales": "ss_quantity", "item": "i_brand",
               "store": "s_state", "customer": "c_region",
               "date_dim": "d_month", "promotion": "p_channel"}
_AGG_COLS = ("ss_sales_price", "ss_net_profit", "ss_quantity")
_OPS = ("eq", "ne", "lt", "le", "gt", "ge", "between", "in")

_prop_catalog = None


def _property_catalog():
    global _prop_catalog
    if _prop_catalog is None:
        _prop_catalog = generate(scale=0.02, p=2, seed=7, device="cpu")
    return _prop_catalog


def _random_leaf(table, rng):
    node = Scan(table)
    if rng.random() < 0.6:
        col, lo, hi = _FILTER_COLS[table]
        op = rng.choice(_OPS)
        if op == "between":
            a, b = sorted((rng.randint(lo, hi - 1), rng.randint(lo, hi - 1)))
            node = Filter(node, col, "between", a, b)
        elif op == "in":
            vals = tuple(sorted(rng.sample(range(lo, hi),
                                           rng.randint(1, 3))))
            node = Filter(node, col, "in", values=vals)
        else:
            node = Filter(node, col, op, rng.randint(lo, hi - 1))
    return node


def _random_plan(rng):
    dims = rng.sample(_FACT_DIMS, rng.randint(0, 2))
    node = _random_leaf("store_sales", rng)
    for fk, dim, pk in dims:
        node = Join(node, _random_leaf(dim, rng), fk, pk)
    if rng.random() < 0.7:
        key = _GROUP_KEYS[rng.choice(["store_sales"]
                                     + [d[1] for d in dims])]
        agg_op = rng.choice(("sum", "count", "min", "max", "mean"))
        node = Aggregate(node, key, ((rng.choice(_AGG_COLS), agg_op),))
    return node


@settings(max_examples=6, deadline=None)
@given(st.integers(min_value=0, max_value=10**9))
def test_print_reparse_preserves_signature_and_result(seed):
    rng = random.Random(seed)
    plan = _random_plan(rng)
    text = to_sql(plan)
    reparsed = parse_sql(text)
    assert signature(reparsed) == signature(plan)
    assert j_signature(jsql.parse_sql(text)) == signature(reparsed)

    catalog = _property_catalog()
    r1 = Executor(catalog, RelJoinStrategy()).execute(plan)
    r2 = Executor(catalog, RelJoinStrategy()).execute(reparsed)
    rows1, rows2 = r1.table.to_numpy(), r2.table.to_numpy()
    assert rows1.keys() == rows2.keys()
    for col in rows1:
        np.testing.assert_allclose(rows1[col], rows2[col], rtol=1e-6,
                                   err_msg=col)
