"""The port's checkpoint re-optimization against the JAX package's, on the
CPU: the five cases of the reference's ``tests/test_reopt.py``, each at
p = 1 and p = 8.

The 3-leaf chain (store_sales ⋈ σ(item)) ⋈ date_dim runs under
``Reorder(RelJoin, reopt=...)`` with ``adaptive=False`` and ``verify=True``
(plan-analysis rule R2 audits every checkpoint inline), on the port and on
the JAX ``Executor`` with the same catalogs. The port's ``ReoptDecision``
trail must equal the reference's: boundary, ``triggered``, ``old_next``
and ``new_next`` exactly, ``q_error`` to a relative 1e-9 (the same float
computation on the same cardinalities); decisions, bytes and rows exactly
(rows as multisets; the chain has no float aggregate).
"""

import numpy as np
import pytest

from repro.joins.ref import ref_equi_join, rows_as_set
from repro.sql import Executor as JExecutor
from repro.sql import RelJoinStrategy as JRelJoinStrategy
from repro.sql import ReorderingStrategy as JReorderingStrategy
from repro.sql import generate as j_generate
from repro.sql.logical import Filter as JFilter
from repro.sql.logical import Join as JJoin
from repro.sql.logical import Scan as JScan
from repro_torch.sql import (Executor, RelJoinStrategy, ReorderingStrategy,
                             generate)
from repro_torch.sql.logical import Filter, Join, Scan

#: The reference's catalogs: uniform (seed 42) and forced divergence
#: (seed 7, ss_item_sk tilted to Zipf 1.3).
CATALOGS = {"uniform": dict(seed=42),
            "tilted": dict(seed=7, skew_overrides={"ss_item_sk": 1.3})}


def _plan(item_cut=150.0, jax=False):
    """3-leaf chain (a reorderable region with two checkpoints)."""
    J, F, S = (JJoin, JFilter, JScan) if jax else (Join, Filter, Scan)
    return J(J(S("store_sales"), F(S("item"), "i_item_sk", "lt", item_cut),
               "ss_item_sk", "i_item_sk"),
             S("date_dim"), "ss_sold_date_sk", "d_date_sk")


def _oracle_rows(catalog, item_cut=150.0):
    ss = catalog.table("store_sales").to_numpy()
    item = catalog.table("item").to_numpy()
    dd = catalog.table("date_dim").to_numpy()
    item_f = {n: c[item["i_item_sk"] < item_cut] for n, c in item.items()}
    out = ref_equi_join(ss, item_f, "ss_item_sk", "i_item_sk")
    out = ref_equi_join(out, dd, "ss_sold_date_sk", "d_date_sk")
    return rows_as_set(out)


@pytest.fixture(scope="module")
def runs():
    """Both packages' runs of one cell, computed once per cell (the JAX
    runs compile their shapes)."""
    cats, done = {}, {}

    def run(cat, p, reopt, item_cut=150.0, adaptive=False):
        key = (cat, p, reopt, item_cut, adaptive)
        if key not in done:
            if (cat, p) not in cats:
                kw = CATALOGS[cat]
                cats[(cat, p)] = (j_generate(0.1, p, **kw),
                                  generate(0.1, p, **kw, device="cpu"))
            jcat, tcat = cats[(cat, p)]
            want = JExecutor(jcat, JReorderingStrategy(JRelJoinStrategy(),
                                                       reopt=reopt),
                             adaptive=adaptive, verify=True
                             ).execute(_plan(item_cut, jax=True))
            got = Executor(tcat, ReorderingStrategy(RelJoinStrategy(),
                                                    reopt=reopt),
                           adaptive=adaptive, verify=True
                           ).execute(_plan(item_cut))
            assert_same_run(got, want)
            done[key] = (got, want, tcat)
        return done[key]

    return run


def _trail(res):
    return [(d.boundary, d.triggered, d.old_next, d.new_next, d.threshold,
             d.estimated.cardinality, d.measured.cardinality)
            for d in res.reopts]


def assert_same_run(got, want):
    assert _trail(got) == _trail(want)
    for g, w in zip(got.reopts, want.reopts):
        assert g.q_error == pytest.approx(w.q_error, rel=1e-9)
    assert got.reopt_count == want.reopt_count
    assert got.max_q_error == pytest.approx(want.max_q_error, rel=1e-9)
    assert [(d.selection.method.value, d.selection.swapped_sides)
            for d in got.decisions] == \
        [(d.selection.method.value, d.selection.swapped_sides)
         for d in want.decisions]
    assert got.rows == want.rows
    assert got.network_bytes == want.network_bytes
    assert got.local_bytes == want.local_bytes
    assert got.straggler_bytes == want.straggler_bytes
    assert rows_as_set(got.table.to_numpy()) == \
        rows_as_set(want.table.to_numpy())


P = [1, 8]


@pytest.mark.parametrize("p", P)
def test_no_divergence_is_byte_identical(runs, p):
    """Uniform catalog: no checkpoint triggers, and the reopt arm's
    decisions equal the reopt-off arm's."""
    off, _, catalog = runs("uniform", p, False)
    on, _, _ = runs("uniform", p, True)
    assert on.reopts and on.reopt_count == 0
    assert not off.reopts
    assert on.methods() == off.methods()
    assert [(d.selection.method, d.selection.swapped_sides)
            for d in on.decisions] == \
        [(d.selection.method, d.selection.swapped_sides)
         for d in off.decisions]
    assert on.network_bytes == off.network_bytes
    assert rows_as_set(on.table.to_numpy()) == \
        rows_as_set(off.table.to_numpy()) == _oracle_rows(catalog)


@pytest.mark.parametrize("p", P)
def test_forced_divergence_triggers_and_preserves_rows(runs, p):
    off, _, catalog = runs("tilted", p, False)
    on, _, _ = runs("tilted", p, True)
    assert on.reopt_count >= 1
    for d in on.reopts:
        assert d.triggered == (d.q_error > d.threshold)
    expected = _oracle_rows(catalog)
    assert rows_as_set(on.table.to_numpy()) == expected
    assert rows_as_set(off.table.to_numpy()) == expected
    assert on.rows == off.rows


@pytest.mark.parametrize("p", P)
def test_empty_intermediate_stays_disciplined(runs, p):
    off, _, catalog = runs("uniform", p, False, item_cut=0.0)
    on, _, _ = runs("uniform", p, True, item_cut=0.0)
    assert on.rows == off.rows == 0
    assert rows_as_set(on.table.to_numpy()) == _oracle_rows(
        catalog, item_cut=0.0) == []
    for d in on.reopts:
        assert np.isfinite(d.q_error)
        assert d.triggered == (d.q_error > d.threshold)


@pytest.mark.parametrize("p", P)
def test_adaptive_reopt_agrees_with_static(runs, p):
    res, _, catalog = runs("uniform", p, True, adaptive=True)
    assert rows_as_set(res.table.to_numpy()) == _oracle_rows(catalog)
    assert res.reopts
    for d in res.reopts:
        assert d.triggered == (d.q_error > d.threshold)


@pytest.mark.parametrize("p", P)
def test_reopt_decisions_record_the_continuation(runs, p):
    for cat in CATALOGS:
        res, _, _ = runs(cat, p, True)
        assert res.reopts
        for d in res.reopts:
            if not d.triggered:
                assert d.new_next == d.old_next


def test_reopt_threshold_is_forwarded():
    """``reopt_qerror`` travels from the strategy (and its wrappers) to the
    executor as in the reference; the executor's own argument wins."""
    from repro.core.cost_model import DEFAULT_REOPT_QERROR as J_DEFAULT
    from repro_torch.core.cost_model import DEFAULT_REOPT_QERROR
    from repro_torch.sql import FilteredStrategy

    assert DEFAULT_REOPT_QERROR == J_DEFAULT
    cat = generate(0.05, 2, 42, device="cpu")
    strat = ReorderingStrategy(RelJoinStrategy(), reopt=True,
                               reopt_qerror=2.5)
    assert FilteredStrategy(strat).reopt_qerror == 2.5
    assert Executor(cat, FilteredStrategy(strat)).reopt_qerror == 2.5
    ex = Executor(cat, strat, reopt_qerror=7.0)
    assert ex.reopt and ex.reopt_qerror == 7.0
    ex = Executor(cat, RelJoinStrategy(), reorder=True, reopt=True)
    assert ex.reopt and ex.reopt_qerror == DEFAULT_REOPT_QERROR
    res = Executor(cat, strat, adaptive=False).execute(_plan())
    assert res.reopts and all(d.threshold == 2.5 for d in res.reopts)
