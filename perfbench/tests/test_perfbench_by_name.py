"""A configuration, a traffic mix, a query template and a per-layer metric
added as new files (and new entries of ``BENCHMARK.json``) are found by
their names, with no edit to any file the benchmark already has."""

import json
import os
import shutil
import subprocess
import sys

import _paths

from perfbench import datagen

ROOT = _paths.ROOT

NEW_QUERY = {
    "name": "q90_birth_month_quantity",
    "source": "a test template",
    "sql": ["SELECT c_birth_month, SUM(ss_quantity)",
            "FROM store_sales",
            "JOIN (SELECT * FROM customer WHERE c_birth_month < {month})",
            "  ON ss_customer_sk = c_customer_sk",
            "GROUP BY c_birth_month"],
    "params": [{"names": ["month"], "int": [3, 12]}],
    "plan": {"op": "aggregate", "key": "c_birth_month",
             "aggs": [["ss_quantity", "sum"]],
             "child": {"op": "join", "type": "inner",
                       "left_key": "ss_customer_sk",
                       "right_key": "c_customer_sk",
                       "left": {"op": "scan", "table": "store_sales"},
                       "right": {"op": "filter", "column": "c_birth_month",
                                 "cmp": "lt", "value": "{month}",
                                 "child": {"op": "scan",
                                           "table": "customer"}}}},
}
NEW_METRIC = '''"""queries_answered: queries answered in the window (a test metric)."""


def read(ctx):
    return float(sum(r.ok for r in ctx.records))
'''


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "tpcds_sf1.json").read_text())
    cfg["rows"] = datagen.table_rows(cfg, datagen.load_schema(cfg["schema"]),
                                     0.01)
    (pb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (pb / "queries" / "q90_birth_month_quantity.json").write_text(
        json.dumps(NEW_QUERY))
    (pb / "mixes" / "tiny_mix.json").write_text(json.dumps(
        {"clients": 2, "templates": ["q90_birth_month_quantity", "q1_star3"],
         "check": 4}))
    (pb / "metrics" / "queries_answered.py").write_text(NEW_METRIC)
    (pb / "limits" / "tiny.cell.json").write_text('{"agg_gap": 1e-3}')
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "perfbench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny",
                               "traffic": "tiny_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "queries_answered", "unit": "queries",
                               "better": "higher", "source": "host_clock",
                               "layer": "service", "moves": "queries_per_s",
                               "workloads": ["tiny.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import json, time; from pathlib import Path; "
            "from perfbench import cell; "
            "out = cell.run('tiny.cell', 2**31 + 1, 1.0, {trace}, "
            "root=Path('.'), t_start=time.perf_counter(), device='cpu'); "
            "print(json.dumps(out))")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT / 'src'}")
    outs = []
    for trace in (False, True):
        done = subprocess.run([sys.executable, "-c", code.format(trace=trace)],
                              cwd=tmp_path, env=env, capture_output=True,
                              text=True, timeout=600)
        assert done.returncode == 0, done.stderr[-3000:]
        outs.append(json.loads(done.stdout.strip().splitlines()[-1]))
    plain, traced = outs
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    assert traced["metrics"]["queries_answered"]["value"] == \
        traced["info"]["queries"] > 0
    assert traced["metrics"]["query_median_ms"]["value"] > 0
    assert "q90_birth_month_quantity" in traced["info"]["gaps"]
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "perfbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items()), \
        "an existing file of the benchmark changed"
