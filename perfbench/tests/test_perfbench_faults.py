"""The check that decides ``correct`` fails a run whose timed path is
broken underneath: the rest of a run is driven on the CPU (the harness's
look for a card skipped), once for each fault a query service can have."""

from pathlib import Path

import _paths
import pytest
import torch

from perfbench import cell

#: The cells' tables at this share of their rows (calendar tables and
#: those under 1,000 rows whole).
FACTOR = 0.02
WORKLOADS = [w["name"] for w in cell.load_benchmark(_paths.ROOT)["workloads"]]


def _run(workload, seed=2**31 + 9):
    import time
    return cell.run(workload, seed, 1.5, False, root=_paths.ROOT,
                    t_start=time.perf_counter(), device="cpu", factor=FACTOR)


def _alter(table):
    """The first valid row's first non-key value, doubled (or, for an
    integer, moved by one); an empty answer stays empty."""
    cols = dict(table.columns)
    flat = table.valid.reshape(-1).nonzero()
    if not flat.numel():
        return table
    name = sorted(cols)[-1]
    col = cols[name].clone().reshape(-1)
    i = int(flat[0])
    col[i] = col[i] * 2 + 1 if not col.dtype.is_floating_point \
        else col[i] * 2 + 1.0
    cols[name] = col.reshape(table.valid.shape)
    return type(table)(cols, table.valid, table.partitioned_by)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_an_answer_altered_where_it_is_produced(monkeypatch, workload):
    from repro_torch.sql import executor

    orig = executor.Executor.execute

    def altered(self, plan):
        res = orig(self, plan)
        res.table = _alter(res.table)
        return res
    monkeypatch.setattr(executor.Executor, "execute", altered)
    out = _run(workload)
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0 or \
        out["checks"]["agg_gap"]["value"] > out["checks"]["agg_gap"]["limit"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_half_of_each_batch_left_out(monkeypatch, workload):
    from repro_torch.sql import service

    orig = service.QueryService._execute_batch

    def half(self, batch):
        rep = orig(self, batch)
        keep = sorted(rep.results)[:len(rep.results) // 2]
        rep.results = {k: rep.results[k] for k in keep}
        return rep
    monkeypatch.setattr(service.QueryService, "_execute_batch", half)
    out = _run(workload)
    assert not out["correct"]
    assert out["checks"]["failed_queries"]["value"] > 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_exchange_between_partitions_left_out(monkeypatch, workload):
    from repro_torch.joins import exchange

    def stay(table, dest, pair_cap, partitioned_by, kind="shuffle"):
        return (exchange.Table(table.columns, table.valid, partitioned_by),
                exchange.ExchangeReport(kind, 0.0, 0.0))
    monkeypatch.setattr(exchange, "_exchange_by_dest", stay)
    out = _run(workload)
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_step_that_returns_its_state_unchanged(monkeypatch, workload):
    from repro_torch.sql import executor

    orig = executor.Executor.execute
    first = []

    def stale(self, plan):
        res = orig(self, plan)
        if not first:
            first.append(res)
        return first[0]
    monkeypatch.setattr(executor.Executor, "execute", stale)
    out = _run(workload)
    assert not out["correct"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_one_executors_rows_left_out_of_each_aggregate(monkeypatch,
                                                       workload):
    """Partition 0's rows dropped before each group-by's shuffle: every
    group keeps its key and loses about one eighth of its sum, which only
    the float gap can see."""
    from repro_torch.sql import executor

    orig = executor.group_aggregate

    def short(table, key, aggs, *args, **kw):
        valid = table.valid.clone()
        valid[0] = False
        return orig(type(table)(table.columns, valid, table.partitioned_by),
                    key, aggs, *args, **kw)
    monkeypatch.setattr(executor, "group_aggregate", short)
    out = _run(workload)
    assert not out["correct"]
    assert out["checks"]["agg_gap"]["value"] > \
        out["checks"]["agg_gap"]["limit"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails(workload):
    """The reference in bfloat16 in the program's place (at a tenth of
    the rows, the sums of thousands of rows a group)."""
    from perfbench.calibrate import control_records

    c = cell.Cell.for_workload(workload, 17, root=_paths.ROOT, device="cpu",
                               factor=0.1)
    c.free_program()
    res = c.check(control_records(c, c.mix.check), control=torch.bfloat16)
    limit = cell.limits(workload)["agg_gap"]
    assert res["wrong"] > 0 or res["gap"] > limit, res


def test_limits_exist_for_every_cell():
    bench = cell.load_benchmark(_paths.ROOT)
    for w in bench["workloads"]:
        lim = cell.limits(w["name"])
        assert 0 < lim["agg_gap"] < 1
    assert Path(cell.HERE / "limits").is_dir()
