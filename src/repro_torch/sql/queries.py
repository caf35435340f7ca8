"""TPC-DS-shaped query suites as hand-built logical plans: the baseline
q1-q12, the mis-ordered planner targets q13-q15, the runtime-filter targets
q19-q23 and the cyclic hypercube targets q35-q37.

Their structural signatures equal those of the JAX package's plans for the
same queries: its SQL texts for q1-q23 (the reference pins
``signature(parse_sql(text)) == signature(hand_built())``), its hand-built
plans for q35-q37, whose closing edges have no SQL form. The SQL text front
end and the skew suite come with later slices of the port.

The suite covers the decision space the paper evaluates:

  * deep dimension chains (q72's shape) with tiny build sides,
  * joins whose build side is < Spark's 10MB absolute threshold but NOT
    relatively small (k < k0) — where AQE over-broadcasts (paper §5.4),
  * joins of aggregated intermediates (q39's shape, a ~ p),
  * fact-to-large-dim joins (shuffle territory), semi and anti joins.

Engine contract: probe side on the LEFT, unique-key build side on the RIGHT
(Spark's BuildRight).
"""

from __future__ import annotations

from typing import Dict

from ..core.selection import JoinType
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
# Mis-ordered queries (join-reordering targets): each is written in an order
# the System-R DP improves on.
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
# cycle is a column-to-column equality between two *build-side* columns. The
# binary engine evaluates it as a post-join eqcol residual; the hypercube
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


HAND_BUILT = {
    "q1_star3": q1_star3, "q2_chain7": q2_chain7,
    "q3_cross_channel": q3_cross_channel, "q4_agg_agg": q4_agg_agg,
    "q5_dim_chain_first": q5_dim_chain_first,
    "q6_catalog_star": q6_catalog_star, "q7_filtered_fact": q7_filtered_fact,
    "q8_semi": q8_semi, "q9_inventory_star": q9_inventory_star,
    "q10_promo_window": q10_promo_window, "q11_projected": q11_projected,
    "q12_anti": q12_anti,
}

MISORDERED = {
    "q13_fact_fact_first": q13_fact_fact_first,
    "q14_big_dim_first": q14_big_dim_first,
    "q15_late_filter": q15_late_filter,
}

FILTERED = {
    "q19_filtered_customer": q19_filtered_customer,
    "q20_filter_below_earlier_exchange": q20_filter_below_earlier_exchange,
    "q21_catalog_filtered_dates": q21_catalog_filtered_dates,
    "q22_zone_map_window": q22_zone_map_window,
    "q23_semi_join_stores": q23_semi_join_stores,
}

CYCLIC = {
    "q35_triangle": q35_triangle,
    "q36_triangle_shared_axis": q36_triangle_shared_axis,
    "q37_four_clique": q37_four_clique,
}


def all_queries() -> Dict[str, Node]:
    """The 12 baseline plans, q1-q12."""
    return {name: build() for name, build in HAND_BUILT.items()}


def filtered_queries() -> Dict[str, Node]:
    """The runtime-filter targets q19-q23 (run them under
    ``FilteredStrategy``)."""
    return {name: build() for name, build in FILTERED.items()}


def misordered_queries() -> Dict[str, Node]:
    """The mis-ordered planner targets q13-q15 (run them under
    ``ReorderingStrategy``)."""
    return {name: build() for name, build in MISORDERED.items()}


def cyclic_queries() -> Dict[str, Node]:
    """The cyclic-core queries q35-q37 (the hypercube targets, under
    ``ReorderingStrategy``)."""
    return {name: build() for name, build in CYCLIC.items()}


def every_query() -> Dict[str, Node]:
    """The 12 baseline plans plus the 3 mis-ordered planner targets."""
    return {**all_queries(), **misordered_queries()}
