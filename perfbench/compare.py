"""The comparison that decides ``correct``: an answer against the plain
reference's.

An answer is a dict of host numpy columns (its valid rows); the reference
is ``reference.evaluate``'s relation. Integer and boolean columns (keys,
counts, integer sums, join flags) must be equal, row for row, once both
sides are sorted by them. Each float value's gap is its distance from the
reference's, over the mass behind it (the sum of the magnitudes that went
into it): a float sum in any order errs by its precision times that mass.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np


def relation_to_numpy(rel) -> Tuple[Dict[str, np.ndarray],
                                    Dict[str, np.ndarray]]:
    cols, mass = rel
    return ({n: (c.double() if c.dtype.is_floating_point else c).cpu().numpy()
             for n, c in cols.items()},
            {n: m.double().cpu().numpy() for n, m in mass.items()})


def _exact(a: np.ndarray) -> bool:
    return not np.issubdtype(a.dtype, np.floating)


def _order(cols: Dict[str, np.ndarray], exact, floats) -> np.ndarray:
    keys = [cols[n].astype(np.float64) for n in reversed(floats)]
    keys += [cols[n].astype(np.int64) for n in reversed(exact)]
    return np.lexsort(keys) if keys else np.arange(0)


def gap(answer: Dict[str, np.ndarray], ref) -> Tuple[bool, float, str]:
    """(rows equal, widest float gap, what differs) of one answer against
    the reference's relation (numpy, from ``relation_to_numpy``)."""
    ref_cols, ref_mass = ref
    if set(answer) != set(ref_cols):
        return False, math.inf, (f"columns {sorted(answer)} against "
                                 f"{sorted(ref_cols)}")
    names = sorted(ref_cols)
    n_ref = len(ref_cols[names[0]]) if names else 0
    n_ans = len(answer[names[0]]) if names else 0
    if n_ref != n_ans:
        return False, math.inf, f"{n_ans} rows against {n_ref}"
    exact = [n for n in names if _exact(ref_cols[n])]
    floats = [n for n in names if not _exact(ref_cols[n])]
    a = _order(answer, exact, floats)
    r = _order(ref_cols, exact, floats)
    for n in exact:
        if not np.array_equal(answer[n][a].astype(np.int64),
                              ref_cols[n][r].astype(np.int64)):
            return False, math.inf, f"column {n} differs"
    worst, where = 0.0, ""
    for n in floats:
        got = answer[n][a].astype(np.float64)
        want = ref_cols[n][r]
        mass = ref_mass[n][r] if n in ref_mass else np.abs(want)
        diff = np.abs(got - want)
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.where(mass > 0, diff / mass,
                           np.where(diff == 0, 0.0, math.inf))
        rel = np.where(np.isnan(got), math.inf, rel)
        if rel.size and float(rel.max()) > worst:
            i = int(rel.argmax())
            worst = float(rel.max())
            where = (f"{n}[{i}] {got[i]!r} against {want[i]!r}, mass "
                     f"{mass[i]!r}")
    return True, worst, where
