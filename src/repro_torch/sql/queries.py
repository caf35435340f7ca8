"""TPC-DS-shaped query suite, as in the JAX package.

Every query is **SQL text** (``SQL_TEXTS``), lowered through the text front
end (``sql.parser`` -> ``sql.binder``) into a logical plan over the
synthetic star schema. q1-q23 additionally keep their original hand-built
plan constructors (``HAND_BUILT``) as a structural reference: the round-trip
test pins ``signature(parse_sql(text)) == signature(hand_built())`` for each,
so the front end can never silently drift from the plans the rest of the
suite was engineered around. q24+ exist only as text — the front end is
their sole producer. The cyclic hypercube targets q35-q37 are hand-built
only: their closing edges have no SQL form.

The texts, the hand-built plans and the registries are the JAX package's
(pure Python, no tensors); the port's tests hold every parsed plan's
signature and selectivities against the reference's.

The suite covers the decision space the paper evaluates:

  * deep dimension chains (q72's shape) with tiny build sides,
  * joins whose build side is < Spark's 10MB absolute threshold but NOT
    relatively small (k < k0) — where AQE over-broadcasts (paper §5.4),
  * joins of aggregated intermediates (q39's shape, a ~ p),
  * fact-to-large-dim joins (shuffle territory), semi/anti joins and outer
    joins.

Engine contract: probe side on the LEFT, unique-key build side on the RIGHT
(Spark's BuildRight).
"""

from __future__ import annotations

from typing import Callable, Dict

from ..core.selection import JoinType
from .binder import parse_sql
from .logical import Aggregate, Filter, Join, Node, Project, Scan


def _ss() -> Node:
    return Scan("store_sales")


def _cs() -> Node:
    return Scan("catalog_sales")


def q1_star3() -> Node:
    """Fact x 3 small dims with filters (classic reporting star)."""
    j = Join(_ss(), Filter(Scan("item"), "i_category", "lt", 3,
                           selectivity=0.3), "ss_item_sk", "i_item_sk")
    j = Join(j, Scan("store"), "ss_store_sk", "s_store_sk")
    j = Join(j, Filter(Scan("date_dim"), "d_month", "eq", 6,
                       selectivity=1 / 12), "ss_sold_date_sk", "d_date_sk")
    return Aggregate(j, "i_brand", (("ss_sales_price", "sum"),
                                    ("ss_quantity", "sum")))


def q2_chain7() -> Node:
    """q72-shaped chain: fact joined to 6 dimensions in sequence."""
    j = Join(_ss(), Scan("date_dim"), "ss_sold_date_sk", "d_date_sk")
    j = Join(j, Scan("item"), "ss_item_sk", "i_item_sk")
    j = Join(j, Scan("customer"), "ss_customer_sk", "c_customer_sk")
    j = Join(j, Scan("household"), "c_hdemo_sk", "hd_demo_sk")
    j = Join(j, Scan("promotion"), "ss_promo_sk", "p_promo_sk")
    j = Join(j, Scan("store"), "ss_store_sk", "s_store_sk")
    return Aggregate(j, "i_category", (("ss_net_profit", "sum"),))


def q3_cross_channel() -> Node:
    """Fact joined to the aggregate of another fact (q14 shape)."""
    cs_by_item = Aggregate(_cs(), "cs_item_sk",
                           (("cs_sales_price", "sum"),
                            ("cs_quantity", "count")))
    j = Join(_ss(), cs_by_item, "ss_item_sk", "cs_item_sk")
    return Aggregate(j, "ss_store_sk", (("ss_sales_price", "sum"),))


def q4_agg_agg() -> Node:
    """q39 shape: join of two aggregated subqueries (a ~ p territory)."""
    inv1 = Aggregate(Filter(Scan("inventory"), "inv_date_sk", "lt", 180,
                            selectivity=0.5),
                     "inv_item_sk", (("inv_quantity_on_hand", "mean"),))
    inv2 = Aggregate(Filter(Scan("inventory"), "inv_date_sk", "ge", 180,
                            selectivity=0.5),
                     "inv_item_sk", (("inv_quantity_on_hand", "mean"),))
    return Join(inv1, inv2, "inv_item_sk", "inv_item_sk")


def q5_dim_chain_first() -> Node:
    """Dim-dim join feeding a fact join (bushy shape)."""
    cust = Join(Scan("customer"), Scan("household"), "c_hdemo_sk",
                "hd_demo_sk")
    j = Join(_ss(), cust, "ss_customer_sk", "c_customer_sk")
    return Aggregate(j, "hd_buy_potential", (("ss_net_profit", "sum"),))


def q6_catalog_star() -> Node:
    j = Join(_cs(), Scan("warehouse"), "cs_warehouse_sk", "w_warehouse_sk")
    j = Join(j, Filter(Scan("date_dim"), "d_year", "eq", 2000,
                       selectivity=1.0), "cs_ship_date_sk", "d_date_sk")
    j = Join(j, Scan("item"), "cs_item_sk", "i_item_sk")
    return Aggregate(j, "w_state", (("cs_sales_price", "sum"),))


def q7_filtered_fact() -> Node:
    """Hard-filtered fact x large dim: small absolute sizes but k ~ 1 —
    AQE broadcasts (under 10MB), RelJoin correctly shuffles (k < k0)."""
    f = Filter(_ss(), "ss_quantity", "lt", 10, selectivity=9 / 99)
    j = Join(f, Scan("customer"), "ss_customer_sk", "c_customer_sk")
    return Aggregate(j, "c_region", (("ss_sales_price", "sum"),))


def q8_semi() -> Node:
    """Semi join: customers with at least one purchase."""
    buyers = Aggregate(_ss(), "ss_customer_sk", (("ss_quantity", "count"),))
    return Join(Scan("customer"), buyers, "c_customer_sk", "ss_customer_sk",
                join_type=JoinType.LEFT_SEMI)


def q9_inventory_star() -> Node:
    j = Join(Scan("inventory"), Scan("item"), "inv_item_sk", "i_item_sk")
    j = Join(j, Scan("warehouse"), "inv_warehouse_sk", "w_warehouse_sk")
    return Aggregate(j, "i_category", (("inv_quantity_on_hand", "sum"),))


def q10_promo_window() -> Node:
    j = Join(_ss(), Filter(Scan("date_dim"), "d_moy", "between", 10,
                           value2=20, selectivity=11 / 30),
             "ss_sold_date_sk", "d_date_sk")
    j = Join(j, Scan("promotion"), "ss_promo_sk", "p_promo_sk")
    return Aggregate(j, "p_channel", (("ss_net_profit", "sum"),))


def q11_projected() -> Node:
    """Column pruning ahead of the exchange (smaller row bytes -> lower k)."""
    slim = Project(_ss(), ("ss_item_sk", "ss_customer_sk",
                           "ss_sales_price"))
    j = Join(slim, Scan("customer"), "ss_customer_sk", "c_customer_sk")
    j = Join(j, Scan("item"), "ss_item_sk", "i_item_sk")
    return Aggregate(j, "i_brand", (("ss_sales_price", "sum"),))


def q12_anti() -> Node:
    """Anti join: items never sold through the catalog channel."""
    sold = Aggregate(_cs(), "cs_item_sk", (("cs_quantity", "count"),))
    return Join(Scan("item"), sold, "i_item_sk", "cs_item_sk",
                join_type=JoinType.LEFT_ANTI)


# ---------------------------------------------------------------------------
# Deliberately mis-ordered queries (planner targets): the written join order
# is provably suboptimal under the cost model — the System-R DP must find a
# strictly cheaper order. Kept out of all_queries() so the baseline suite's
# shape is unchanged; use misordered_queries() / every_query().
# ---------------------------------------------------------------------------


def q13_fact_fact_first() -> Node:
    """Fact x aggregated-fact runs BEFORE the selective dim filters.

    Optimal order joins the 10%-filtered item (then the 1/12 date window)
    first, shrinking the probe side ~120x before the expensive
    fact-aggregate join."""
    cs_by_item = Aggregate(_cs(), "cs_item_sk", (("cs_sales_price", "sum"),))
    j = Join(_ss(), cs_by_item, "ss_item_sk", "cs_item_sk")
    j = Join(j, Filter(Scan("item"), "i_category", "lt", 1, selectivity=0.1),
             "ss_item_sk", "i_item_sk")
    j = Join(j, Filter(Scan("date_dim"), "d_month", "eq", 3,
                       selectivity=1 / 12), "ss_sold_date_sk", "d_date_sk")
    return Aggregate(j, "i_brand", (("ss_sales_price", "sum"),))


def q14_big_dim_first() -> Node:
    """The shuffle-heavy customer join (k < k0) runs BEFORE the 1/12
    date filter that would shrink the fact side it shuffles."""
    j = Join(_ss(), Scan("customer"), "ss_customer_sk", "c_customer_sk")
    j = Join(j, Scan("store"), "ss_store_sk", "s_store_sk")
    j = Join(j, Filter(Scan("date_dim"), "d_month", "eq", 6,
                       selectivity=1 / 12), "ss_sold_date_sk", "d_date_sk")
    return Aggregate(j, "c_region", (("ss_net_profit", "sum"),))


def q15_late_filter() -> Node:
    """Mis-placed AND mis-ordered: the selective item predicate is written
    above both joins. Pushdown sinks it to the item scan; reordering then
    joins the slimmed item ahead of the expensive customer join."""
    j = Join(_ss(), Scan("customer"), "ss_customer_sk", "c_customer_sk")
    j = Join(j, Scan("item"), "ss_item_sk", "i_item_sk")
    f = Filter(j, "i_category", "lt", 1, selectivity=0.1)
    return Aggregate(f, "c_region", (("ss_sales_price", "sum"),))


# ---------------------------------------------------------------------------
# Skewed queries (skew-aware selection targets): each centers on a
# fact x large-dim join in shuffle territory (k < k0) whose fact-side FK is
# Zipf-hot when the catalog is generated with skew > 0. Under uniform keys
# these are ordinary shuffle-hash joins; under Zipf >= ~1.2 the straggler
# cost makes SkewAwareStrategy switch them to SALTED_SHUFFLE_HASH. Run them
# against ``generate(..., skew=z)`` catalogs. (SkewAwareStrategy and the
# salted join come with a later slice of the port; until then they run
# under the four default strategies on uniform keys.)
# ---------------------------------------------------------------------------


def q16_hot_customer() -> Node:
    """The canonical skew target: fact x customer (k ~ 1.7 << k0) with a
    Zipf-hot ss_customer_sk — one hot customer draws ~20% of the fact."""
    j = Join(_ss(), Scan("customer"), "ss_customer_sk", "c_customer_sk")
    return Aggregate(j, "c_region", (("ss_net_profit", "sum"),))


def q17_hot_customer_star() -> Node:
    """Skewed shuffle join feeding a reporting star: the hot customer join
    runs first (maximum straggler exposure), then two broadcast dims whose
    skew-invariant costs must NOT change under skew."""
    j = Join(_ss(), Scan("customer"), "ss_customer_sk", "c_customer_sk")
    j = Join(j, Scan("store"), "ss_store_sk", "s_store_sk")
    j = Join(j, Filter(Scan("date_dim"), "d_month", "eq", 6,
                       selectivity=1 / 12), "ss_sold_date_sk", "d_date_sk")
    return Aggregate(j, "c_region", (("ss_sales_price", "sum"),))


def q18_hot_catalog_customer() -> Node:
    """Catalog-channel variant: the date join first widens the fact rows
    (so the probe side is the larger one at every scale), then the
    Zipf-hot cs_bill_customer_sk shuffle join hits the straggler."""
    j = Join(_cs(), Scan("date_dim"), "cs_ship_date_sk", "d_date_sk")
    j = Join(j, Scan("customer"), "cs_bill_customer_sk", "c_customer_sk")
    return Aggregate(j, "c_region", (("cs_sales_price", "sum"),))


# ---------------------------------------------------------------------------
# Filter-friendly queries (runtime bloom-filter targets): star shapes whose
# selective dimension predicate makes the probe side mostly dead weight at
# its shuffle — a bloom filter over the surviving dimension keys, applied
# to the fact below its exchanges, cuts the shipped bytes by ~1/sigma.
# Selectivities are tuned so the big fact x customer joins stay in shuffle
# territory (k < k0) with filters on AND off, so the saving shows up as
# probe-side shuffle bytes rather than a method flip.
# ---------------------------------------------------------------------------


def q19_filtered_customer() -> Node:
    """Fact x 30%-filtered customer (k ~ 3 << k0, shuffle both ways): the
    canonical single-edge filter — ~70% of the fact never ships."""
    f = Filter(Scan("customer"), "c_income", "lt", 74_000,
               selectivity=0.3)
    j = Join(_ss(), f, "ss_customer_sk", "c_customer_sk")
    return Aggregate(j, "c_region", (("ss_net_profit", "sum"),))


def q20_filter_below_earlier_exchange() -> Node:
    """The *unfiltered* customer shuffle runs first in plan order; the
    selective item predicate joins later. Leaf-level placement pushes the
    item filter below the customer exchange, so the first shuffle already
    ships only the ~10% of fact rows with surviving items."""
    j = Join(_ss(), Scan("customer"), "ss_customer_sk", "c_customer_sk")
    j = Join(j, Filter(Scan("item"), "i_category", "lt", 1, selectivity=0.1),
             "ss_item_sk", "i_item_sk")
    return Aggregate(j, "c_region", (("ss_sales_price", "sum"),))


def q21_catalog_filtered_dates() -> Node:
    """Catalog channel: the date predicate (1 quarter ~ 25%) sits on a tiny
    broadcast dimension, yet its filter — pushed onto the fact leaf —
    quarters the later customer join's shuffled bytes."""
    j = Join(_cs(), Scan("customer"), "cs_bill_customer_sk", "c_customer_sk")
    j = Join(j, Filter(Scan("date_dim"), "d_month", "between", 0, value2=2,
                       selectivity=0.25), "cs_ship_date_sk", "d_date_sk")
    return Aggregate(j, "c_region", (("cs_sales_price", "sum"),))


# ---------------------------------------------------------------------------
# Filter-kind targets (runtime-filter *framework*): queries whose cheapest
# reducer is provably not a bloom filter, exercising the per-edge kind
# selection. q22's dimension predicate is a range on the join key itself
# (a TPC-DS date window filters d_date_sk between two dates), so the
# surviving keys are one contiguous band — the 8-byte min/max zone map
# keeps the same fraction as a bloom filter at a fraction of its broadcast
# cost. q23's build side survives as a handful of stores, so the exact
# sorted key list (32n bits, n ~ 5) undercuts even the minimum-size bloom
# array (256 bits) with zero false positives — the semi-join reducer wins.
# ---------------------------------------------------------------------------


def q22_zone_map_window() -> Node:
    """Date-window star: range predicate on the join key itself -> the
    dimension's surviving keys form one band and the zone map is the
    cheapest reducer. The unfiltered customer shuffle runs *first* in plan
    order, so only the leaf-level zone map — pushed below that exchange —
    can thin it to 25% of the fact (a 90-day window of the 360-day year)."""
    f = Filter(Scan("date_dim"), "d_date_sk", "lt", 90,
               selectivity=90 / 360)
    j = Join(_ss(), Scan("customer"), "ss_customer_sk", "c_customer_sk")
    j = Join(j, f, "ss_sold_date_sk", "d_date_sk")
    return Aggregate(j, "c_region", (("ss_net_profit", "sum"),))


def q23_semi_join_stores() -> Node:
    """Tiny exact key set: ~5 of 60 stores survive the state predicate, so
    the semi-join reducer's key list is smaller than the minimum bloom
    array. Like q22, the customer shuffle runs first: the semi-join filter
    on the store key, applied at the fact leaf, ships only ~8% of it. How
    many stores survive depends on the catalog's seed: from 9 on, the key
    list outweighs the 256-bit bloom filter and bloom wins (seed 0)."""
    f = Filter(Scan("store"), "s_state", "eq", 0, selectivity=1 / 12)
    j = Join(_ss(), Scan("customer"), "ss_customer_sk", "c_customer_sk")
    j = Join(j, f, "ss_store_sk", "s_store_sk")
    return Aggregate(j, "c_region", (("ss_sales_price", "sum"),))


# ---------------------------------------------------------------------------
# Cyclic join cores (hypercube multi-way targets): the closing edge of each
# cycle is a column-to-column equality between two *build-side* columns —
# inexpressible in the suite's SQL dialect (single-equality ON, literal-only
# WHERE), so q35-q37 exist only as hand-built plans. The binary engine
# evaluates the closing edge as a post-join eqcol residual; the hypercube
# planner recognizes the cycle and quotes one multi-way shuffle against the
# DP's best binary tree. Build sides are aggregates (unique group keys — the
# engine's build contract) sized *relatively large* (> probe/k0), so the
# binary plan pays real shuffles and re-ships its wide intermediate, which
# is exactly the traffic the cube partitioning never creates.
# ---------------------------------------------------------------------------


def q35_triangle() -> Node:
    """Triangle on fact tables: store_sales x (catalog_sales by customer) x
    (inventory by item), closed on the item variable (the customer's
    max catalog item must be this sale's item). The item axis spans all
    three relations, so the best cube pure-hashes every relation —
    replication-free — while the binary plan re-ships its wide
    fact-sized intermediate at the second join."""
    s = Aggregate(_cs(), "cs_bill_customer_sk", (("cs_item_sk", "max"),))
    t = Aggregate(Scan("inventory"), "inv_item_sk",
                  (("inv_warehouse_sk", "max"),
                   ("inv_quantity_on_hand", "sum")))
    j = Join(_ss(), s, "ss_customer_sk", "cs_bill_customer_sk")
    j = Join(j, t, "ss_item_sk", "inv_item_sk")
    f = Filter(j, "max_cs_item_sk", "eqcol", column2="inv_item_sk")
    return Aggregate(f, "ss_store_sk", (("ss_sales_price", "sum"),))


def q36_triangle_shared_axis() -> Node:
    """The q35 rotation: catalog_sales probes (store_sales by customer) and
    (inventory by item), closed on the item variable via store_sales'
    max-item aggregate column. Same replication-free two-axis cube, with
    the probe and both builds drawn from the other fact pairing."""
    s = Aggregate(_ss(), "ss_customer_sk",
                  (("ss_item_sk", "max"), ("ss_sales_price", "sum")))
    t = Aggregate(Scan("inventory"), "inv_item_sk",
                  (("inv_quantity_on_hand", "sum"),
                   ("inv_warehouse_sk", "max")))
    j = Join(_cs(), s, "cs_bill_customer_sk", "ss_customer_sk")
    j = Join(j, t, "cs_item_sk", "inv_item_sk")
    f = Filter(j, "max_ss_item_sk", "eqcol", column2="inv_item_sk")
    return Aggregate(f, "cs_warehouse_sk", (("cs_sales_price", "sum"),))


def q37_four_clique() -> Node:
    """4-clique: every pair of relations shares a variable (customer, item,
    date, warehouse). Three closing eqcol edges ride above the join tree;
    the date variable spans all four relations, so the best cube
    concentrates the whole budget on the date axis."""
    r = _ss()
    s = Aggregate(_cs(), "cs_bill_customer_sk",
                  (("cs_warehouse_sk", "max"), ("cs_ship_date_sk", "max")))
    t = Aggregate(Scan("inventory"), "inv_item_sk",
                  (("inv_warehouse_sk", "max"), ("inv_date_sk", "max"),
                   ("inv_quantity_on_hand", "sum")))
    u = Aggregate(_cs(), "cs_ship_date_sk",
                  (("cs_quantity", "count"), ("cs_sales_price", "sum")))
    j = Join(r, s, "ss_customer_sk", "cs_bill_customer_sk")
    j = Join(j, t, "ss_item_sk", "inv_item_sk")
    j = Join(j, u, "ss_sold_date_sk", "cs_ship_date_sk")
    f = Filter(j, "max_cs_warehouse_sk", "eqcol",
               column2="max_inv_warehouse_sk")
    f = Filter(f, "max_cs_ship_date_sk", "eqcol", column2="cs_ship_date_sk")
    f = Filter(f, "max_inv_date_sk", "eqcol", column2="cs_ship_date_sk")
    return Aggregate(f, "ss_store_sk", (("ss_net_profit", "sum"),))


#: q1-q23's hand-built constructors — the structural reference the SQL
#: round-trip test pins against SQL_TEXTS.
HAND_BUILT: Dict[str, Callable[[], Node]] = {
    "q1_star3": q1_star3,
    "q2_chain7": q2_chain7,
    "q3_cross_channel": q3_cross_channel,
    "q4_agg_agg": q4_agg_agg,
    "q5_dim_chain_first": q5_dim_chain_first,
    "q6_catalog_star": q6_catalog_star,
    "q7_filtered_fact": q7_filtered_fact,
    "q8_semi": q8_semi,
    "q9_inventory_star": q9_inventory_star,
    "q10_promo_window": q10_promo_window,
    "q11_projected": q11_projected,
    "q12_anti": q12_anti,
    "q13_fact_fact_first": q13_fact_fact_first,
    "q14_big_dim_first": q14_big_dim_first,
    "q15_late_filter": q15_late_filter,
    "q16_hot_customer": q16_hot_customer,
    "q17_hot_customer_star": q17_hot_customer_star,
    "q18_hot_catalog_customer": q18_hot_catalog_customer,
    "q19_filtered_customer": q19_filtered_customer,
    "q20_filter_below_earlier_exchange": q20_filter_below_earlier_exchange,
    "q21_catalog_filtered_dates": q21_catalog_filtered_dates,
    "q22_zone_map_window": q22_zone_map_window,
    "q23_semi_join_stores": q23_semi_join_stores,
}


# ---------------------------------------------------------------------------
# The SQL texts. These are the queries: every registry below lowers its
# plans from this dict through parse_sql(). Filters written inside derived
# tables sit on the leaf scans (the hand-built shapes); q15/q29 deliberately
# leave predicates above the joins for the optimizer's pushdown to sink.
# ---------------------------------------------------------------------------

SQL_TEXTS: Dict[str, str] = {
    "q1_star3": """
        SELECT i_brand, SUM(ss_sales_price), SUM(ss_quantity)
        FROM store_sales
        JOIN (SELECT * FROM item WHERE i_category < 3)
          ON ss_item_sk = i_item_sk
        JOIN store ON ss_store_sk = s_store_sk
        JOIN (SELECT * FROM date_dim WHERE d_month = 6)
          ON ss_sold_date_sk = d_date_sk
        GROUP BY i_brand
    """,
    "q2_chain7": """
        SELECT i_category, SUM(ss_net_profit)
        FROM store_sales
        JOIN date_dim ON ss_sold_date_sk = d_date_sk
        JOIN item ON ss_item_sk = i_item_sk
        JOIN customer ON ss_customer_sk = c_customer_sk
        JOIN household ON c_hdemo_sk = hd_demo_sk
        JOIN promotion ON ss_promo_sk = p_promo_sk
        JOIN store ON ss_store_sk = s_store_sk
        GROUP BY i_category
    """,
    "q3_cross_channel": """
        SELECT ss_store_sk, SUM(ss_sales_price)
        FROM store_sales
        JOIN (SELECT cs_item_sk, SUM(cs_sales_price), COUNT(cs_quantity)
              FROM catalog_sales GROUP BY cs_item_sk)
          ON ss_item_sk = cs_item_sk
        GROUP BY ss_store_sk
    """,
    "q4_agg_agg": """
        SELECT *
        FROM (SELECT inv_item_sk, AVG(inv_quantity_on_hand) FROM inventory
              WHERE inv_date_sk < 180 GROUP BY inv_item_sk)
        JOIN (SELECT inv_item_sk, AVG(inv_quantity_on_hand) FROM inventory
              WHERE inv_date_sk >= 180 GROUP BY inv_item_sk)
          ON inv_item_sk = inv_item_sk
    """,
    "q5_dim_chain_first": """
        SELECT hd_buy_potential, SUM(ss_net_profit)
        FROM store_sales
        JOIN (SELECT * FROM customer
              JOIN household ON c_hdemo_sk = hd_demo_sk)
          ON ss_customer_sk = c_customer_sk
        GROUP BY hd_buy_potential
    """,
    "q6_catalog_star": """
        SELECT w_state, SUM(cs_sales_price)
        FROM catalog_sales
        JOIN warehouse ON cs_warehouse_sk = w_warehouse_sk
        JOIN (SELECT * FROM date_dim WHERE d_year = 2000)
          ON cs_ship_date_sk = d_date_sk
        JOIN item ON cs_item_sk = i_item_sk
        GROUP BY w_state
    """,
    "q7_filtered_fact": """
        SELECT c_region, SUM(ss_sales_price)
        FROM (SELECT * FROM store_sales WHERE ss_quantity < 10)
        JOIN customer ON ss_customer_sk = c_customer_sk
        GROUP BY c_region
    """,
    "q8_semi": """
        SELECT * FROM customer
        WHERE c_customer_sk IN (SELECT ss_customer_sk, COUNT(ss_quantity)
                                FROM store_sales GROUP BY ss_customer_sk)
    """,
    "q9_inventory_star": """
        SELECT i_category, SUM(inv_quantity_on_hand)
        FROM inventory
        JOIN item ON inv_item_sk = i_item_sk
        JOIN warehouse ON inv_warehouse_sk = w_warehouse_sk
        GROUP BY i_category
    """,
    "q10_promo_window": """
        SELECT p_channel, SUM(ss_net_profit)
        FROM store_sales
        JOIN (SELECT * FROM date_dim WHERE d_moy BETWEEN 10 AND 20)
          ON ss_sold_date_sk = d_date_sk
        JOIN promotion ON ss_promo_sk = p_promo_sk
        GROUP BY p_channel
    """,
    "q11_projected": """
        SELECT i_brand, SUM(ss_sales_price)
        FROM (SELECT ss_item_sk, ss_customer_sk, ss_sales_price
              FROM store_sales)
        JOIN customer ON ss_customer_sk = c_customer_sk
        JOIN item ON ss_item_sk = i_item_sk
        GROUP BY i_brand
    """,
    "q12_anti": """
        SELECT * FROM item
        WHERE i_item_sk NOT IN (SELECT cs_item_sk, COUNT(cs_quantity)
                                FROM catalog_sales GROUP BY cs_item_sk)
    """,
    "q13_fact_fact_first": """
        SELECT i_brand, SUM(ss_sales_price)
        FROM store_sales
        JOIN (SELECT cs_item_sk, SUM(cs_sales_price) FROM catalog_sales
              GROUP BY cs_item_sk)
          ON ss_item_sk = cs_item_sk
        JOIN (SELECT * FROM item WHERE i_category < 1)
          ON ss_item_sk = i_item_sk
        JOIN (SELECT * FROM date_dim WHERE d_month = 3)
          ON ss_sold_date_sk = d_date_sk
        GROUP BY i_brand
    """,
    "q14_big_dim_first": """
        SELECT c_region, SUM(ss_net_profit)
        FROM store_sales
        JOIN customer ON ss_customer_sk = c_customer_sk
        JOIN store ON ss_store_sk = s_store_sk
        JOIN (SELECT * FROM date_dim WHERE d_month = 6)
          ON ss_sold_date_sk = d_date_sk
        GROUP BY c_region
    """,
    "q15_late_filter": """
        SELECT c_region, SUM(ss_sales_price)
        FROM store_sales
        JOIN customer ON ss_customer_sk = c_customer_sk
        JOIN item ON ss_item_sk = i_item_sk
        WHERE i_category < 1
        GROUP BY c_region
    """,
    "q16_hot_customer": """
        SELECT c_region, SUM(ss_net_profit)
        FROM store_sales
        JOIN customer ON ss_customer_sk = c_customer_sk
        GROUP BY c_region
    """,
    "q17_hot_customer_star": """
        SELECT c_region, SUM(ss_sales_price)
        FROM store_sales
        JOIN customer ON ss_customer_sk = c_customer_sk
        JOIN store ON ss_store_sk = s_store_sk
        JOIN (SELECT * FROM date_dim WHERE d_month = 6)
          ON ss_sold_date_sk = d_date_sk
        GROUP BY c_region
    """,
    "q18_hot_catalog_customer": """
        SELECT c_region, SUM(cs_sales_price)
        FROM catalog_sales
        JOIN date_dim ON cs_ship_date_sk = d_date_sk
        JOIN customer ON cs_bill_customer_sk = c_customer_sk
        GROUP BY c_region
    """,
    "q19_filtered_customer": """
        SELECT c_region, SUM(ss_net_profit)
        FROM store_sales
        JOIN (SELECT * FROM customer WHERE c_income < 74000)
          ON ss_customer_sk = c_customer_sk
        GROUP BY c_region
    """,
    "q20_filter_below_earlier_exchange": """
        SELECT c_region, SUM(ss_sales_price)
        FROM store_sales
        JOIN customer ON ss_customer_sk = c_customer_sk
        JOIN (SELECT * FROM item WHERE i_category < 1)
          ON ss_item_sk = i_item_sk
        GROUP BY c_region
    """,
    "q21_catalog_filtered_dates": """
        SELECT c_region, SUM(cs_sales_price)
        FROM catalog_sales
        JOIN customer ON cs_bill_customer_sk = c_customer_sk
        JOIN (SELECT * FROM date_dim WHERE d_month BETWEEN 0 AND 2)
          ON cs_ship_date_sk = d_date_sk
        GROUP BY c_region
    """,
    "q22_zone_map_window": """
        SELECT c_region, SUM(ss_net_profit)
        FROM store_sales
        JOIN customer ON ss_customer_sk = c_customer_sk
        JOIN (SELECT * FROM date_dim WHERE d_date_sk < 90)
          ON ss_sold_date_sk = d_date_sk
        GROUP BY c_region
    """,
    "q23_semi_join_stores": """
        SELECT c_region, SUM(ss_sales_price)
        FROM store_sales
        JOIN customer ON ss_customer_sk = c_customer_sk
        JOIN (SELECT * FROM store WHERE s_state = 0)
          ON ss_store_sk = s_store_sk
        GROUP BY c_region
    """,
    # -- text-only queries (q24+): no hand-built twin, the front end is
    # -- their sole producer. Each widens the parsed surface: multi-
    # -- conjunct WHEREs, IN lists, LEFT JOIN, semi/anti under aggregates,
    # -- implicit comma joins, ne predicates, nested derived aggregates.
    "q24_multi_predicate": """
        SELECT s_state, SUM(ss_net_profit)
        FROM (SELECT * FROM store_sales
              WHERE ss_quantity < 50 AND ss_sales_price > 100)
        JOIN store ON ss_store_sk = s_store_sk
        GROUP BY s_state
    """,
    "q25_in_dims": """
        SELECT i_brand, SUM(ss_sales_price)
        FROM store_sales
        JOIN (SELECT * FROM item WHERE i_category IN (1, 3, 5))
          ON ss_item_sk = i_item_sk
        JOIN (SELECT * FROM date_dim WHERE d_month = 6)
          ON ss_sold_date_sk = d_date_sk
        GROUP BY i_brand
    """,
    "q26_outer_agg": """
        SELECT c_region, SUM(sum_ss_net_profit)
        FROM customer
        LEFT JOIN (SELECT ss_customer_sk, SUM(ss_net_profit)
                   FROM store_sales GROUP BY ss_customer_sk)
          ON c_customer_sk = ss_customer_sk
        GROUP BY c_region
    """,
    "q27_semi_rich": """
        SELECT c_region, COUNT(c_income)
        FROM customer
        WHERE c_income > 150000
          AND c_customer_sk IN (SELECT cs_bill_customer_sk,
                                       COUNT(cs_quantity)
                                FROM catalog_sales
                                GROUP BY cs_bill_customer_sk)
        GROUP BY c_region
    """,
    "q28_anti_catalog": """
        SELECT i_category, COUNT(i_price)
        FROM item
        WHERE i_item_sk NOT IN (SELECT cs_item_sk, COUNT(cs_quantity)
                                FROM catalog_sales GROUP BY cs_item_sk)
        GROUP BY i_category
    """,
    "q29_implicit_star": """
        SELECT s_state, SUM(ss_sales_price)
        FROM store_sales, store, date_dim
        WHERE ss_store_sk = s_store_sk
          AND ss_sold_date_sk = d_date_sk
          AND d_month = 11
        GROUP BY s_state
    """,
    "q30_zone_window": """
        SELECT p_channel, SUM(ss_net_profit)
        FROM store_sales
        JOIN (SELECT * FROM date_dim WHERE d_date_sk BETWEEN 30 AND 59)
          ON ss_sold_date_sk = d_date_sk
        JOIN promotion ON ss_promo_sk = p_promo_sk
        GROUP BY p_channel
    """,
    "q31_ne_store": """
        SELECT s_state, COUNT(ss_quantity)
        FROM store_sales
        JOIN (SELECT * FROM store WHERE s_state <> 0)
          ON ss_store_sk = s_store_sk
        GROUP BY s_state
    """,
    "q32_inventory_turns": """
        SELECT w_state, SUM(mean_inv_quantity_on_hand)
        FROM (SELECT inv_warehouse_sk, AVG(inv_quantity_on_hand)
              FROM inventory WHERE inv_date_sk BETWEEN 90 AND 179
              GROUP BY inv_warehouse_sk)
        JOIN warehouse ON inv_warehouse_sk = w_warehouse_sk
        GROUP BY w_state
    """,
    # -- service queries (q33/q34): deliberately overlapping with q19/q22 —
    # -- identical FROM/JOIN subtrees under a *different* aggregate, the
    # -- cross-query CSE targets (the shared join executes once per batch).
    "q33_shared_customer_join": """
        SELECT c_region, SUM(ss_sales_price)
        FROM store_sales
        JOIN (SELECT * FROM customer WHERE c_income < 74000)
          ON ss_customer_sk = c_customer_sk
        GROUP BY c_region
    """,
    "q34_shared_window_join": """
        SELECT c_region, SUM(ss_sales_price)
        FROM store_sales
        JOIN customer ON ss_customer_sk = c_customer_sk
        JOIN (SELECT * FROM date_dim WHERE d_date_sk < 90)
          ON ss_sold_date_sk = d_date_sk
        GROUP BY c_region
    """,
}


def _from_sql(names) -> Dict[str, Node]:
    return {name: parse_sql(SQL_TEXTS[name]) for name in names}


def misordered_queries() -> Dict[str, Node]:
    """The mis-ordered planner targets q13-q15 (run them under
    ``ReorderingStrategy``)."""
    return _from_sql(["q13_fact_fact_first", "q14_big_dim_first",
                      "q15_late_filter"])


def skewed_queries() -> Dict[str, Node]:
    """The skew targets q16-q18."""
    return _from_sql(["q16_hot_customer", "q17_hot_customer_star",
                      "q18_hot_catalog_customer"])


def filtered_queries() -> Dict[str, Node]:
    """The runtime-filter targets q19-q23 (run them under
    ``FilteredStrategy``)."""
    return _from_sql(["q19_filtered_customer",
                      "q20_filter_below_earlier_exchange",
                      "q21_catalog_filtered_dates",
                      "q22_zone_map_window",
                      "q23_semi_join_stores"])


def cyclic_queries() -> Dict[str, Node]:
    """The cyclic-core queries (q35-q37): hand-built only — their closing
    eqcol edges are inexpressible in the suite's SQL dialect."""
    return {"q35_triangle": q35_triangle(),
            "q36_triangle_shared_axis": q36_triangle_shared_axis(),
            "q37_four_clique": q37_four_clique()}


def text_queries() -> Dict[str, Node]:
    """The text-only queries (q24+) — plans that exist solely as SQL."""
    return _from_sql([n for n in SQL_TEXTS if n not in HAND_BUILT])


def service_queries() -> Dict[str, Node]:
    """The concurrent-service batch: the filter-friendly q19-q23 plus the
    deliberately-overlapping q33/q34, whose join subtrees duplicate q19's
    and q22's — the cross-query CSE demonstration suite."""
    out = filtered_queries()
    out.update(_from_sql(["q33_shared_customer_join",
                          "q34_shared_window_join"]))
    return out


def every_query() -> Dict[str, Node]:
    """The 12 baseline plans plus the 3 mis-ordered planner targets.
    (The skewed q16-q18, filter-friendly q19-q23 and text-only q24+ are
    separate: they target specific catalogs/strategies — see
    ``skewed_queries()`` / ``filtered_queries()`` / ``text_queries()``.)"""
    out = all_queries()
    out.update(misordered_queries())
    return out


def all_queries() -> Dict[str, Node]:
    """The 12 baseline plans, q1-q12."""
    return _from_sql(["q1_star3", "q2_chain7", "q3_cross_channel",
                      "q4_agg_agg", "q5_dim_chain_first", "q6_catalog_star",
                      "q7_filtered_fact", "q8_semi", "q9_inventory_star",
                      "q10_promo_window", "q11_projected", "q12_anti"])
