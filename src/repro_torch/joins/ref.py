"""Pure numpy oracle for distributed join semantics (test ground truth)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def ref_equi_join(a_cols: Dict[str, np.ndarray], b_cols: Dict[str, np.ndarray],
                  a_key: str, b_key: str, join_type: str = "inner"
                  ) -> Dict[str, np.ndarray]:
    """FK->PK equi-join oracle (build keys unique). Row order is undefined;
    compare as multisets of rows."""
    bk = b_cols[b_key]
    assert len(np.unique(bk)) == len(bk), "oracle requires unique build keys"
    lookup = {int(k): i for i, k in enumerate(bk)}
    ak = a_cols[a_key]
    # Explicit dtype: an empty probe side would otherwise produce a float64
    # index array, which numpy rejects as an index.
    idx = np.asarray([lookup.get(int(k), -1) for k in ak], dtype=np.int64)
    found = idx >= 0

    if join_type == "left_semi":
        return {n: c[found] for n, c in a_cols.items()}
    if join_type == "left_anti":
        return {n: c[~found] for n, c in a_cols.items()}

    keep = found if join_type == "inner" else np.ones_like(found)
    out = {n: c[keep] for n, c in a_cols.items()}
    sel = idx[keep]
    for n, c in b_cols.items():
        name = n if n not in out else f"{n}_r"
        col = c[np.maximum(sel, 0)]
        if join_type == "left_outer":
            col = np.where(sel >= 0, col, 0)
        out[name] = col
    if join_type == "left_outer":
        out[f"{b_key}_matched"] = sel >= 0
    return out


def ref_multiway_join(tables, links, checks=()) -> Dict[str, np.ndarray]:
    """Multi-way cyclic-join oracle. ``tables[0]`` is the probe; each link
    ``(build_index, probe_col, build_col)`` is an FK->PK lookup into
    ``tables[build_index]`` (build keys unique) whose columns are gathered
    into the output row; ``checks`` are residual ``(col_a, col_b)``
    equalities — the closing edges of the cyclic core — applied to the
    fully gathered row."""
    out = {n: np.asarray(c) for n, c in tables[0].items()}
    for bi, pcol, bcol in links:
        out = ref_equi_join(out, tables[bi], pcol, bcol)
    for ca, cb in checks:
        keep = out[ca] == out[cb]
        out = {n: c[keep] for n, c in out.items()}
    return out


def rows_as_set(cols: Dict[str, np.ndarray]):
    """Multiset-comparable representation of a table's rows."""
    names = sorted(cols)
    n = len(cols[names[0]]) if names else 0
    return sorted(tuple(float(cols[c][i]) for c in names) for i in range(n))


def rows_close(a, b, rel: float = 1e-3) -> bool:
    """Compare two rows_as_set lists; float aggregates may differ in
    summation order across physical plans, so compare with tolerance."""
    if len(a) != len(b):
        return False
    import math
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for va, vb in zip(ra, rb):
            if not math.isclose(va, vb, rel_tol=rel, abs_tol=1e-4):
                return False
    return True
