"""The benchmark's catalog, drawn on the device from a schema file and a
configuration's row counts: the facts from the run's seed, the other
tables from a fixed stream.

``schemas/<name>.json`` lists every table's columns in order, each with how
it is drawn (the file's ``doc`` names the kinds); a configuration
(``configs/<name>.json``) names its schema and gives each table's rows.
Everything is drawn with one seeded ``torch.Generator`` on the catalog's
device, a column a call.

``base_tables`` returns the flat columns that both sides read: the program
gets them as its ``Catalog`` (split round-robin over ``p`` partitions, with
the column statistics a metastore would hand the planner), and the plain
reference reads the same tensors.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

#: Statistics kept per column, as ``repro_torch.core.stats`` keeps them.
MCV_TOP_K = 8
HISTOGRAM_BUCKETS = 16

#: The stream the non-fact tables are drawn from, whatever the run's seed:
#: like TPC-DS's dimensions at a scale factor, they are the deployment's
#: fixed reference data. Drawn anew with each seed, the few distinct values
#: of a small dimension's attribute (the states of 5 warehouses) change
#: which group keys meet in a partition, and with them the work of a query.
DIMENSION_SEED = 0x7C0D5
#: Day 0 of ``date_dim``.
EPOCH = np.datetime64("1900-01-02")


def load_schema(name: str, root: Path = HERE) -> dict:
    path = root / "schemas" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no schema named {name!r} ({path})")
    return json.loads(path.read_text())


def table_rows(config: dict, schema: dict, factor: float = 1.0
               ) -> Dict[str, int]:
    """Each table's rows: the configuration's, times ``factor`` (a smaller
    copy for tests on the CPU); calendar tables and those under 1,000 rows
    keep theirs, and a table of ``inv`` columns is the cross product of the
    sales window's weeks, the warehouses and every second item."""
    rows = {t: (n if factor == 1.0 or t in schema["calendar"] or n < 1000
                else max(1000, int(round(n * factor))))
            for t, n in config["rows"].items()}
    lo, hi = schema["sales_window"]
    for t, columns in schema["tables"].items():
        if any(c.split()[1] == "inv" for c in columns):
            rows[t] = ((hi - lo) // 7 + 1) * rows["warehouse"] \
                * (rows["item"] // 2)
    return rows


def _calendar(days: int) -> Dict[str, np.ndarray]:
    """``date_dim``'s fields of day ``i`` after ``EPOCH``, for every day."""
    i = np.arange(days, dtype=np.int64)
    d = EPOCH + i
    year = d.astype("datetime64[Y]").astype(np.int64) + 1970
    month0 = d.astype("datetime64[M]").astype(np.int64)
    moy = month0 % 12 + 1
    first = (d.astype("datetime64[M]") - EPOCH).astype(np.int64)
    nxt = ((d.astype("datetime64[M]") + 1).astype("datetime64[D]")
           - EPOCH).astype(np.int64)
    dom = i - first + 1
    qoy = (moy - 1) // 3 + 1
    dow = (i + 2) % 7                       # 1900-01-02 was a Tuesday
    holiday = (((moy == 1) & (dom == 1)) | ((moy == 7) & (dom == 4))
               | ((moy == 12) & (dom == 25))).astype(np.int64)
    return {
        "date": i, "year": year, "moy": moy, "dom": dom, "qoy": qoy,
        "dow": dow, "month_seq": (year - 1900) * 12 + moy - 1,
        "week_seq": (i + 1) // 7 + 1,
        "quarter_seq": (year - 1900) * 4 + qoy,
        "quarter_name": year * 10 + qoy, "holiday": holiday,
        "weekend": ((dow == 0) | (dow == 6)).astype(np.int64),
        "following_holiday": np.concatenate([[0], holiday[:-1]]),
        "first_dom": first, "last_dom": nxt - 1,
        "same_day_ly": i - 365, "same_day_lq": i - 91,
        "zero": np.zeros_like(i),
    }


def _clock(seconds: int) -> Dict[str, np.ndarray]:
    """``time_dim``'s fields of second ``s`` of the day."""
    s = np.arange(seconds, dtype=np.int64)
    hour = s // 3600
    meal = np.where((hour >= 6) & (hour < 9), 1,
                    np.where((hour >= 11) & (hour < 14), 2,
                             np.where((hour >= 17) & (hour < 20), 3, 0)))
    return {"time": s, "hour": hour, "minute": s // 60 % 60,
            "second": s % 60, "am_pm": (hour >= 12).astype(np.int64),
            "shift": hour // 8, "sub_shift": hour // 6, "meal_time": meal}


class _Drawer:
    """Draws one table's columns, in the schema's order."""

    def __init__(self, g: torch.Generator, device, rows: Dict[str, int],
                 schema: dict, n: int):
        self.g, self.device, self.rows, self.schema, self.n = \
            g, device, rows, schema, n
        self.cols: Dict[str, torch.Tensor] = {}
        self._pricing = None
        self._derived: Dict[str, Dict[str, np.ndarray]] = {}

    def ints(self, lo: int, hi: int) -> torch.Tensor:
        """Uniform over ``lo..hi``, inclusive."""
        return torch.randint(lo, hi + 1, (self.n,), generator=self.g,
                             device=self.device, dtype=torch.int64)

    def uniform(self, lo: float, hi: float) -> torch.Tensor:
        u = torch.rand(self.n, generator=self.g, device=self.device,
                       dtype=torch.float64)
        return u * (hi - lo) + lo

    def row(self) -> torch.Tensor:
        return torch.arange(self.n, device=self.device, dtype=torch.int64)

    def pricing(self) -> Dict[str, torch.Tensor]:
        """One sales line's prices, each drawn once for the table."""
        if self._pricing is None:
            cents = lambda x: torch.round(x * 100) / 100  # noqa: E731
            quantity = self.ints(1, 100)
            q = quantity.double()
            wholesale = cents(self.uniform(1, 100))
            listp = cents(wholesale * (1 + self.uniform(0, 2)))
            sales = cents(listp * (1 - self.uniform(0, 1)))
            coupon_on = self.uniform(0, 1) < 0.2
            coupon = torch.where(coupon_on,
                                 cents(sales * q * self.uniform(0, 1)), 0.0)
            net_paid = sales * q - coupon
            tax = cents(net_paid * self.uniform(0, 0.09))
            ship = cents(listp * q * self.uniform(0, 0.5))
            self._pricing = {
                "quantity": quantity, "wholesale_cost": wholesale,
                "list_price": listp, "sales_price": sales,
                "ext_discount_amt": (listp - sales) * q,
                "ext_sales_price": sales * q,
                "ext_wholesale_cost": wholesale * q,
                "ext_list_price": listp * q, "ext_tax": tax,
                "coupon_amt": coupon, "ext_ship_cost": ship,
                "net_paid": net_paid, "net_paid_inc_tax": net_paid + tax,
                "net_paid_inc_ship": net_paid + ship,
                "net_paid_inc_ship_tax": net_paid + ship + tax,
                "net_profit": net_paid - wholesale * q,
            }
        return self._pricing

    def derived(self, kind: str, field: str) -> torch.Tensor:
        if kind not in self._derived:
            self._derived[kind] = (_calendar if kind == "cal"
                                   else _clock)(self.n)
        return torch.from_numpy(self._derived[kind][field]).to(self.device)

    def column(self, kind: str, args) -> torch.Tensor:
        """One column of ``kind`` (int64 or float64 before the cast)."""
        if kind in ("key", "id"):
            return self.row()
        if kind == "half":
            return self.row() // 2
        if kind == "fk":
            return self.ints(0, self.rows[args[0]] - 1)
        if kind in ("int", "code"):
            lo, hi = ((int(args[0]), int(args[1])) if kind == "int"
                      else (0, int(args[0]) - 1))
            return self.ints(lo, hi)
        if kind == "dec":
            return torch.round(self.uniform(float(args[0]),
                                            float(args[1])) * 100) / 100
        if kind == "flag":
            return (self.uniform(0, 1) < float(args[0])).long()
        if kind == "same":
            return self.cols[args[0]].long()
        if kind == "sold_date":
            return self.ints(*self.schema["sales_window"])
        if kind == "after":
            return self.cols[args[0]].long() + self.ints(int(args[1]),
                                                         int(args[2]))
        if kind == "digit":
            stride, card, offset = (int(a) for a in args[:3])
            times = int(args[3]) if len(args) > 3 else 1
            return (self.row() // stride % card + offset) * times
        if kind in ("cal", "clock"):
            return self.derived(kind, args[0])
        if kind == "price":
            return self.pricing()[args[0]]
        if kind == "inv":
            items, warehouses = self.rows["item"] // 2, self.rows["warehouse"]
            r = self.row()
            return {"item": 2 * (r % items),
                    "warehouse": r // items % warehouses,
                    "date": self.schema["sales_window"][0]
                    + 7 * (r // (items * warehouses))}[args[0]]
        raise ValueError(f"unknown column kind {kind!r}")


def base_tables(config: dict, seed: int, device, factor: float = 1.0,
                root: Path = HERE) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every table's columns (1-D int32 / float32 tensors on ``device``):
    the facts from ``seed``, the rest from ``DIMENSION_SEED``."""
    device = torch.device(device)
    schema = load_schema(config["schema"], root)
    rows = table_rows(config, schema, factor)
    g = torch.Generator(device=device)
    tables = {}
    for facts in (False, True):
        g.manual_seed(int(seed) % (1 << 63) if facts else DIMENSION_SEED)
        for name, columns in schema["tables"].items():
            if (name in schema["facts"]) != facts:
                continue
            d = _Drawer(g, device, rows, schema, rows[name])
            for entry in columns:
                col, kind, *args = entry.split()
                v = d.column(kind, args)
                d.cols[col] = v.to(torch.float32 if v.dtype.is_floating_point
                                   else torch.int32)
            tables[name] = d.cols
    return {name: tables[name] for name in schema["tables"]}


def key_domains(config: dict, factor: float = 1.0,
                root: Path = HERE) -> Dict[str, float]:
    """Each key column's domain: the rows of the table its values name."""
    schema = load_schema(config["schema"], root)
    rows = table_rows(config, schema, factor)
    out = {}
    for name, columns in schema["tables"].items():
        for entry in columns:
            col, kind, *args = entry.split()
            table = {"key": name, "fk": args[0] if args else None,
                     "sold_date": "date_dim", "after": "date_dim",
                     "inv": {"date": "date_dim", "item": "item",
                             "warehouse": "warehouse"}.get(
                                 args[0] if args else "")}.get(kind)
            if table is not None:
                out[col] = float(rows[table])
    return out


def column_stats(col: torch.Tensor):
    """NDV, the top ``MCV_TOP_K`` values by count (ties by value) and
    ``HISTOGRAM_BUCKETS`` equi-depth buckets over the rest, computed on the
    column's device to the definition of
    ``repro_torch.core.stats.column_stats_from_summary``."""
    from repro_torch.core.stats import ColumnStats

    integral = not col.dtype.is_floating_point
    vals, counts = torch.unique(col.to(torch.int64 if integral
                                       else torch.float64),
                                sorted=True, return_counts=True)
    n = float(col.numel())
    if not n:
        return ColumnStats(0.0, 0.0, (), (), integral)
    # A stable sort keeps equal counts in ascending value order.
    top = torch.sort(counts, descending=True, stable=True).indices[:MCV_TOP_K]
    mcv = tuple(zip(vals[top].double().tolist(),
                    counts[top].double().tolist()))
    rest = torch.ones_like(counts, dtype=torch.bool)
    rest[top] = False
    rest_vals = vals[rest].double()
    cum = torch.cumsum(counts[rest], 0)
    buckets = []
    last = cum.numel() - 1
    if last >= 0:
        target = float(cum[-1]) / HISTOGRAM_BUCKETS
        start, base = 0, 0
        while start <= last:
            # The first value at which the bucket holds a share, or the
            # last value.
            need = torch.tensor([math.ceil(base + target)], device=cum.device,
                                dtype=cum.dtype)
            i = min(int(torch.searchsorted(cum, need)), last)
            top_rows = int(cum[i])
            buckets.append((float(rest_vals[start]), float(rest_vals[i]),
                            float(top_rows - base), float(i - start + 1)))
            base, start = top_rows, i + 1
    return ColumnStats(n, float(vals.numel()), mcv, tuple(buckets), integral)


def catalog(tables: Dict[str, Dict[str, torch.Tensor]], p: int,
            domains: Dict[str, float]):
    """The program's ``Catalog`` of these columns: each table split into
    ``p`` partitions, with the key domains and column statistics."""
    from repro_torch.joins.table import Table, partition_round_robin
    from repro_torch.sql.datagen import Catalog

    parts, stats = {}, {}
    for name, cols in tables.items():
        rows = next(iter(cols.values())).numel()
        valid = torch.ones(rows, dtype=torch.bool,
                           device=next(iter(cols.values())).device)
        parts[name] = partition_round_robin(Table(dict(cols), valid), p)
        for col, t in cols.items():
            stats[col] = column_stats(t)
    return Catalog(parts, p, key_domains=domains, column_stats=stats)
