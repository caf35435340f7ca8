"""Synthetic TPC-DS-like star schema (the same *shape* of the decision
problem as TPC-DS — fact tables vastly larger than dimensions, FK->PK
equi-joins, multi-join chains, skewable keys).

Scale factor 1.0 ~= 100k fact rows; tables keep TPC-DS-style names so the
query suite reads like the original workload. The columns are drawn from
one ``np.random.default_rng(seed)`` stream in a fixed order, so a seed gives
the same data as the JAX package's ``generate``; the tables are then placed
on the requested device.
"""

from __future__ import annotations

import dataclasses
import itertools
import uuid
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.stats import (ColumnStats, ColumnSummary,
                          column_stats_from_summary)
from ..joins.table import (Table, from_numpy, partition_round_robin,
                           resolve_device)


@dataclasses.dataclass
class Catalog:
    """Named stacked tables + their (exact) base statistics.

    ``key_domains`` maps key columns (FKs and PKs alike) to the cardinality
    of the domain they draw from — the denominator of the selectivity
    estimate sigma = surviving build keys / domain. It is header metadata
    (like the PK contract), not a measurement.

    ``version`` identifies the catalog *contents* (a fresh monotonically
    increasing value per constructed Catalog) and ``uid`` is a generation
    UUID; :func:`catalog_fingerprint` pairs them as the cache-validity
    identity. Data changes must go through a new Catalog object, never by
    mutating ``tables`` in place.
    """

    tables: Dict[str, Table]
    p: int
    key_domains: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: Per-column NDV / MCV / equi-depth-histogram statistics
    #: (``core.stats.ColumnStats``) of the unpartitioned data. Column names
    #: are globally unique across the star schema, so one flat map covers
    #: every table. An estimator treats a missing entry as "no histogram".
    column_stats: Dict[str, ColumnStats] = dataclasses.field(
        default_factory=dict)
    version: int = dataclasses.field(
        default_factory=lambda: next(_CATALOG_VERSIONS))
    uid: str = dataclasses.field(
        default_factory=lambda: uuid.uuid4().hex)

    def table(self, name: str) -> Table:
        return self.tables[name]


#: Source of ``Catalog.version`` values (process-unique, monotonic).
_CATALOG_VERSIONS = itertools.count()


def catalog_fingerprint(catalog) -> Tuple[object, object]:
    """Cache-validity identity of a catalog: ``(version, uid)`` (None
    components for catalog-like objects without the fields)."""
    return (getattr(catalog, "version", None), getattr(catalog, "uid", None))


#: (rows per unit scale) per table. Dimensions are sized to place joins on
#: BOTH sides of k0: fact/item k~25d, fact/store k~2000, fact/customer k~4
#: etc. (with w=1,p=8 -> k0=15).
SCHEMA = {
    "store_sales": 100_000,     # fact
    "catalog_sales": 60_000,    # second fact
    "inventory": 30_000,        # medium fact
    "customer": 12_000,         # large dim (k < k0 vs fact)
    "item": 2_000,              # mid dim
    "date_dim": 360,            # small dim (explicit 360-day year: 12x30)
    "store": 60,                # tiny dim
    "promotion": 40,            # tiny dim
    "warehouse": 12,            # tiny dim
    "household": 3_000,         # mid dim
}


def _zipf_fks(rng, n, n_dim, skew: float):
    """FK draws; skew=0 -> uniform, else Zipf-tilted (hot keys)."""
    if skew <= 0:
        return rng.integers(0, n_dim, n).astype(np.int32)
    ranks = np.arange(1, n_dim + 1, dtype=np.float64)
    probs = ranks ** (-skew)
    probs /= probs.sum()
    return rng.choice(n_dim, size=n, p=probs).astype(np.int32)


#: Only facts scale; dimensions are fixed (TPC-DS dims grow sub-linearly,
#: and e.g. date_dim must always cover whole years).
FACTS = ("store_sales", "catalog_sales", "inventory")


def generate(scale: float = 1.0, p: int = 8, seed: int = 0,
             skew: float = 0.0,
             skew_overrides: Dict[str, float] | None = None, *,
             device=None) -> Catalog:
    """Build the catalog on ``device`` (the CUDA card unless another device
    is named). ``skew`` is the global Zipf exponent of every fact FK column;
    ``skew_overrides`` overrides it per column (e.g.
    ``{"ss_customer_sk": 1.4}`` makes only the customer key hot).
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = {t: max(8, int(r * scale)) if t in FACTS else r
         for t, r in SCHEMA.items()}
    overrides = skew_overrides or {}

    def fks(col: str, nrows: int, dim: str):
        return _zipf_fks(rng, nrows, n[dim], overrides.get(col, skew))

    def dim(name, pk, extra):
        cols = {pk: np.arange(n[name], dtype=np.int32)}
        cols.update(extra)
        return cols

    tables = {}
    tables["customer"] = dim("customer", "c_customer_sk", {
        "c_region": rng.integers(0, 8, n["customer"]).astype(np.int32),
        "c_hdemo_sk": rng.integers(0, n["household"],
                                   n["customer"]).astype(np.int32),
        "c_income": rng.uniform(2e4, 2e5, n["customer"]).astype(np.float32),
    })
    tables["item"] = dim("item", "i_item_sk", {
        "i_category": rng.integers(0, 10, n["item"]).astype(np.int32),
        "i_brand": rng.integers(0, 100, n["item"]).astype(np.int32),
        "i_price": rng.uniform(1, 300, n["item"]).astype(np.float32),
    })
    # Explicit 360-day calendar (12 months x 30 days): every month holds
    # exactly 1/12 of the domain and every day-of-month exactly 1/30.
    tables["date_dim"] = dim("date_dim", "d_date_sk", {
        "d_month": (np.arange(n["date_dim"]) // 30 % 12).astype(np.int32),
        "d_year": (2000 + np.arange(n["date_dim"]) // 360).astype(np.int32),
        "d_moy": (np.arange(n["date_dim"]) % 30).astype(np.int32),
    })
    tables["store"] = dim("store", "s_store_sk", {
        "s_state": rng.integers(0, 12, n["store"]).astype(np.int32),
        "s_floor": rng.uniform(1e3, 1e5, n["store"]).astype(np.float32),
    })
    tables["promotion"] = dim("promotion", "p_promo_sk", {
        "p_channel": rng.integers(0, 4, n["promotion"]).astype(np.int32),
    })
    tables["warehouse"] = dim("warehouse", "w_warehouse_sk", {
        "w_state": rng.integers(0, 12, n["warehouse"]).astype(np.int32),
    })
    tables["household"] = dim("household", "hd_demo_sk", {
        "hd_buy_potential": rng.integers(0, 6,
                                         n["household"]).astype(np.int32),
    })

    nf = n["store_sales"]
    tables["store_sales"] = {
        "ss_item_sk": fks("ss_item_sk", nf, "item"),
        "ss_store_sk": fks("ss_store_sk", nf, "store"),
        "ss_customer_sk": fks("ss_customer_sk", nf, "customer"),
        "ss_sold_date_sk": fks("ss_sold_date_sk", nf, "date_dim"),
        "ss_promo_sk": fks("ss_promo_sk", nf, "promotion"),
        "ss_quantity": rng.integers(1, 100, nf).astype(np.int32),
        "ss_sales_price": rng.uniform(1, 300, nf).astype(np.float32),
        "ss_net_profit": rng.uniform(-50, 150, nf).astype(np.float32),
    }
    nc = n["catalog_sales"]
    tables["catalog_sales"] = {
        "cs_item_sk": fks("cs_item_sk", nc, "item"),
        "cs_ship_date_sk": fks("cs_ship_date_sk", nc, "date_dim"),
        "cs_bill_customer_sk": fks("cs_bill_customer_sk", nc, "customer"),
        "cs_warehouse_sk": fks("cs_warehouse_sk", nc, "warehouse"),
        "cs_quantity": rng.integers(1, 100, nc).astype(np.int32),
        "cs_sales_price": rng.uniform(1, 300, nc).astype(np.float32),
    }
    ni = n["inventory"]
    tables["inventory"] = {
        "inv_item_sk": fks("inv_item_sk", ni, "item"),
        "inv_date_sk": fks("inv_date_sk", ni, "date_dim"),
        "inv_warehouse_sk": fks("inv_warehouse_sk", ni, "warehouse"),
        "inv_quantity_on_hand": rng.integers(0, 1000, ni).astype(np.int32),
    }

    domains = {col: float(n[dim]) for col, dim in FK_DIMENSIONS.items()}
    domains.update({pk: float(n[t]) for t, pk in PRIMARY_KEYS.items()})
    return catalog_from_numpy(tables, p, domains, device)


def catalog_from_numpy(tables: Dict[str, Dict[str, np.ndarray]], p: int,
                       key_domains: Dict[str, float], device=None
                       ) -> Catalog:
    """Build a Catalog from numpy columns: each table goes to ``device``
    (the CUDA card unless another device is named) and is split into ``p``
    partitions, and the column statistics are computed from the data, as
    ``generate`` computes them."""
    device = resolve_device(device)
    flat = {name: from_numpy(cols, device=device)
            for name, cols in tables.items()}
    return Catalog({name: partition_round_robin(t, p)
                    for name, t in flat.items()}, p,
                   key_domains=dict(key_domains),
                   column_stats=compute_column_stats(flat))


def payload_from_numpy(kind: str, arrays, device=None):
    """A runtime-filter payload built elsewhere (numpy arrays, as the JAX
    package's ``build_filter_payload`` returns them) as the port's payload
    on ``device``: bloom uint32 words -> int32 words of the same bits, a
    zone map's int32 ``(2,)`` interval, or a semi-join's ``(sorted_keys,
    n)`` -> int32 keys and a 0-d int64 count."""
    device = resolve_device(device)
    if kind == "bloom":
        words = np.ascontiguousarray(arrays, dtype=np.uint32).view(np.int32)
        return torch.from_numpy(words.copy()).to(device)
    if kind == "zone_map":
        return torch.from_numpy(np.asarray(arrays, dtype=np.int32).copy()
                                ).to(device)
    if kind == "semi_join":
        keys, n = arrays
        return (torch.from_numpy(np.asarray(keys, dtype=np.int32).copy()
                                 ).to(device),
                torch.tensor(int(n), dtype=torch.int64, device=device))
    raise ValueError(f"unknown filter kind {kind!r}")


def compute_column_stats(tables: Dict[str, Table]) -> Dict[str, ColumnStats]:
    """Exact per-column statistics from unpartitioned tables: one
    ``np.unique`` pass per column feeds the compressed-multiset summary,
    finalized into NDV / MCV / equi-depth buckets."""
    stats: Dict[str, ColumnStats] = {}
    for t in tables.values():
        for col, arr in t.to_numpy().items():
            a = np.asarray(arr)
            vals, counts = np.unique(a, return_counts=True)
            summary = ColumnSummary(tuple(float(v) for v in vals),
                                    tuple(float(c) for c in counts))
            stats[col] = column_stats_from_summary(
                summary, integral=bool(np.issubdtype(a.dtype, np.integer)))
    return stats


#: fact FK column -> the dimension whose PK domain it draws from. Feeds
#: ``Catalog.key_domains``.
FK_DIMENSIONS = {
    "ss_item_sk": "item", "ss_store_sk": "store",
    "ss_customer_sk": "customer", "ss_sold_date_sk": "date_dim",
    "ss_promo_sk": "promotion",
    "cs_item_sk": "item", "cs_ship_date_sk": "date_dim",
    "cs_bill_customer_sk": "customer", "cs_warehouse_sk": "warehouse",
    "inv_item_sk": "item", "inv_date_sk": "date_dim",
    "inv_warehouse_sk": "warehouse",
    "c_hdemo_sk": "household",
}

#: primary key of each dimension (build-side uniqueness contract).
PRIMARY_KEYS = {
    "customer": "c_customer_sk", "item": "i_item_sk",
    "date_dim": "d_date_sk", "store": "s_store_sk",
    "promotion": "p_promo_sk", "warehouse": "w_warehouse_sk",
    "household": "hd_demo_sk",
}

#: Static schema: ordered column names per table, exactly as ``generate``
#: builds them.
TABLE_COLUMNS: Dict[str, tuple] = {
    "customer": ("c_customer_sk", "c_region", "c_hdemo_sk", "c_income"),
    "item": ("i_item_sk", "i_category", "i_brand", "i_price"),
    "date_dim": ("d_date_sk", "d_month", "d_year", "d_moy"),
    "store": ("s_store_sk", "s_state", "s_floor"),
    "promotion": ("p_promo_sk", "p_channel"),
    "warehouse": ("w_warehouse_sk", "w_state"),
    "household": ("hd_demo_sk", "hd_buy_potential"),
    "store_sales": ("ss_item_sk", "ss_store_sk", "ss_customer_sk",
                    "ss_sold_date_sk", "ss_promo_sk", "ss_quantity",
                    "ss_sales_price", "ss_net_profit"),
    "catalog_sales": ("cs_item_sk", "cs_ship_date_sk",
                      "cs_bill_customer_sk", "cs_warehouse_sk",
                      "cs_quantity", "cs_sales_price"),
    "inventory": ("inv_item_sk", "inv_date_sk", "inv_warehouse_sk",
                  "inv_quantity_on_hand"),
}

#: Non-key column value domains as ``(lo, hi, integral)`` with half-open
#: ``[lo, hi)`` bounds matching the ``generate`` draws (integers/uniform),
#: plus the computed date columns' exact ranges under the 360-day
#: calendar. ``derive_selectivity`` turns these into op-specific filter
#: fractions.
COLUMN_DOMAINS: Dict[str, tuple] = {
    "c_region": (0, 8, True), "c_income": (2e4, 2e5, False),
    "i_category": (0, 10, True), "i_brand": (0, 100, True),
    "i_price": (1, 300, False),
    "d_month": (0, 12, True), "d_year": (2000, 2001, True),
    "d_moy": (0, 30, True),
    "s_state": (0, 12, True), "s_floor": (1e3, 1e5, False),
    "p_channel": (0, 4, True), "w_state": (0, 12, True),
    "hd_buy_potential": (0, 6, True),
    "ss_quantity": (1, 100, True), "ss_sales_price": (1, 300, False),
    "ss_net_profit": (-50, 150, False),
    "cs_quantity": (1, 100, True), "cs_sales_price": (1, 300, False),
    "inv_quantity_on_hand": (0, 1000, True),
}

#: Static key domains: FK and PK columns -> domain cardinality. Dimensions
#: never scale (only FACTS do), so this is knowable without a catalog.
STATIC_KEY_DOMAINS: Dict[str, float] = {
    **{col: float(SCHEMA[dim]) for col, dim in FK_DIMENSIONS.items()},
    **{pk: float(SCHEMA[t]) for t, pk in PRIMARY_KEYS.items()},
}
