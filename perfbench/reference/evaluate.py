"""Plain evaluation of a declarative query plan over the base tables.

Imports neither ``jax``, nor ``repro``, nor ``repro_torch``: the comparison
that decides ``correct`` holds the program against this alone. Columns are
1-D tensors on the base tables' device; integers are widened to int64 and
floats are computed in ``dtype`` (float64 for the reference, a narrower
type for the lower-precision control).

Semantics, as the engine states them: an equi-join's right side carries
unique keys (a foreign key meets its primary key); an inner join keeps the
left columns and appends the right ones, a right name that is already
taken gaining ``_r``; a left-outer join keeps every left row, fills the
right columns of an unmatched row with 0 and adds ``<right_key>_matched``;
semi and anti joins keep only the left columns. An aggregate groups by one
key and names each result ``<op>_<column>``; ``mean`` is sum / count.

Beside each float column the evaluator carries its *mass*: the sum of the
magnitudes that went into each value (``|x|`` for a base value; summed,
averaged or carried along with it). A float sum computed in any order
errs by at most its precision times that mass, so the comparison measures
each float gap against it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Columns = Dict[str, torch.Tensor]
#: A relation: its columns, and the mass of each float column.
Relation = Tuple[Columns, Columns]

_CMP = {
    "eq": lambda c, f: c == f["value"],
    "ne": lambda c, f: c != f["value"],
    "lt": lambda c, f: c < f["value"],
    "le": lambda c, f: c <= f["value"],
    "gt": lambda c, f: c > f["value"],
    "ge": lambda c, f: c >= f["value"],
    "between": lambda c, f: (c >= f["value"]) & (c <= f["value2"]),
    "in": lambda c, f: torch.isin(
        c, torch.tensor(f["values"], dtype=c.dtype, device=c.device)),
}


def _widen(col: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if col.dtype == torch.bool:
        return col
    return col.to(dtype if col.dtype.is_floating_point else torch.int64)


def _take(rel: Relation, idx: torch.Tensor) -> Relation:
    cols, mass = rel
    return ({n: c[idx] for n, c in cols.items()},
            {n: m[idx] for n, m in mass.items()})


def _scan(node, tables, dtype, need) -> Relation:
    cols = {n: _widen(c, dtype) for n, c in tables[node["table"]].items()
            if need is None or n in need}
    mass = {n: c.abs() for n, c in cols.items() if c.dtype.is_floating_point}
    return cols, mass


def _filter(node, rel: Relation) -> Relation:
    cols = rel[0]
    col = cols[node["column"]]
    if node["cmp"] == "eqcol":
        keep = col == cols[node["column2"]]
    else:
        keep = _CMP[node["cmp"]](col, node)
    return _take(rel, keep)


def _join(node, left: Relation, right: Relation) -> Relation:
    lk, rk = left[0][node["left_key"]], right[0][node["right_key"]]
    sorted_rk, order = torch.sort(rk)
    if sorted_rk.numel() > 1 and bool((sorted_rk[1:] == sorted_rk[:-1]).any()):
        raise ValueError(f"join on {node['right_key']}: right keys repeat")
    if sorted_rk.numel():
        pos = torch.searchsorted(sorted_rk, lk).clamp_(max=rk.numel() - 1)
        found = sorted_rk[pos] == lk
        match = order[pos]
    else:
        found = torch.zeros_like(lk, dtype=torch.bool)
        match = torch.zeros_like(lk)
    kind = node["type"]
    if kind == "left_semi":
        return _take(left, found)
    if kind == "left_anti":
        return _take(left, ~found)
    if kind == "inner":
        left = _take(left, found)
        match = match[found]
    elif kind != "left_outer":
        raise ValueError(f"unknown join type {kind!r}")
    cols, mass = dict(left[0]), dict(left[1])
    for n, c in right[0].items():
        name = n if n not in cols else f"{n}_r"
        if kind == "left_outer":
            got = c[match] if c.numel() else c.new_zeros(match.shape)
            cols[name] = torch.where(found, got, torch.zeros_like(got))
            if n in right[1]:
                m = right[1][n]
                m = m[match] if m.numel() else m.new_zeros(match.shape)
                mass[name] = torch.where(found, m, torch.zeros_like(m))
        else:
            cols[name] = c[match]
            if n in right[1]:
                mass[name] = right[1][n][match]
    if kind == "left_outer":
        cols[f"{node['right_key']}_matched"] = found
    return cols, mass


def _aggregate(node, rel: Relation) -> Relation:
    cols, mass = rel
    keys, inv = torch.unique(cols[node["key"]], sorted=True,
                             return_inverse=True)
    groups = keys.numel()
    count = torch.bincount(inv, minlength=groups)
    out, out_mass = {node["key"]: keys}, {}
    for col, op in node["aggs"]:
        v = cols[col]
        name = f"{op}_{col}"
        if op == "count":
            out[name] = count
            continue
        if op in ("sum", "mean"):
            s = torch.zeros(groups, dtype=v.dtype, device=v.device)
            s.index_add_(0, inv, v)
            if op == "mean":
                s = s / count.clamp(min=1).to(s.dtype if s.dtype.is_floating_point
                                              else torch.float64)
            out[name] = s
            m = mass.get(col, v.abs() if v.dtype.is_floating_point
                         else v.abs().to(torch.float64))
            ms = torch.zeros(groups, dtype=m.dtype, device=m.device)
            ms.index_add_(0, inv, m)
            out_mass[name] = ms / count.clamp(min=1) if op == "mean" else ms
            continue
        if op in ("min", "max"):
            fill = (torch.finfo(v.dtype) if v.dtype.is_floating_point
                    else torch.iinfo(v.dtype))
            init = fill.max if op == "min" else fill.min
            r = torch.full((groups,), init, dtype=v.dtype, device=v.device)
            out[name] = r.scatter_reduce_(0, inv, v, "a" + op,
                                          include_self=False)
            if col in mass:
                m = torch.zeros(groups, dtype=mass[col].dtype, device=v.device)
                out_mass[name] = m.scatter_reduce_(0, inv, mass[col], "amax",
                                                   include_self=False)
            continue
        raise ValueError(f"unknown aggregate {op!r}")
    return out, out_mass


def _union(need, more):
    return None if need is None else need | set(more)


def evaluate(plan: dict, tables: Dict[str, Columns],
             dtype: torch.dtype = torch.float64, need=None) -> Relation:
    """The rows of ``plan`` (its placeholders already bound) over
    ``tables``, with the mass of each float column. ``need``: the columns
    the caller reads of them (``None``: every one); a scan reads no
    other, which keeps a wide table's unread columns off the device."""
    op = plan["op"]
    if op == "scan":
        return _scan(plan, tables, dtype, need)
    if op == "filter":
        more = [plan["column"]] + ([plan["column2"]] if "column2" in plan
                                   else [])
        return _filter(plan, evaluate(plan["child"], tables, dtype,
                                      _union(need, more)))
    if op == "project":
        keep = plan["columns"]
        cols, mass = evaluate(plan["child"], tables, dtype, set(keep))
        return ({n: cols[n] for n in keep},
                {n: mass[n] for n in keep if n in mass})
    if op == "join":
        # A right column that meets a left name is read as ``<name>_r``;
        # both sides keep every name asked for, so the renaming is the
        # same as over every column.
        names = None if need is None else \
            {n[:-2] if n.endswith("_r") else n for n in need}
        keys = [plan["left_key"], plan["right_key"]]
        right_need = set(keys) if plan["type"] in ("left_semi", "left_anti") \
            else _union(names, keys)
        return _join(plan, evaluate(plan["left"], tables, dtype,
                                    _union(names, keys)),
                     evaluate(plan["right"], tables, dtype, right_need))
    if op == "aggregate":
        more = {plan["key"]} | {col for col, _ in plan["aggs"]}
        return _aggregate(plan, evaluate(plan["child"], tables, dtype, more))
    raise ValueError(f"unknown plan operator {op!r}")
