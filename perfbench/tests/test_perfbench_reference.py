"""The plain reference against the program on the CPU: every query file's
declarative plan gives the rows that ``repro_torch`` gives for its SQL
text, which also pins each file's text to its plan."""

import json

import _paths
import numpy as np
import pytest
import torch

from perfbench import compare, datagen
from perfbench.cell import Cell, fetch
from perfbench.reference.evaluate import evaluate
from perfbench.traffic import Instance, Mix, load_template

QUERIES = sorted(p.stem for p in (_paths.ROOT / "perfbench" / "queries")
                 .glob("*.json"))
CONFIGS = sorted(p.stem for p in (_paths.ROOT / "perfbench" / "configs")
                 .glob("*.json"))
SEEDS = (3, 2**31 + 11)
#: The tables at this share of their rows (calendar tables and those under
#: 1,000 rows whole).
FACTOR = 0.01


def _config(name):
    path = _paths.ROOT / "perfbench" / "configs" / f"{name}.json"
    return json.loads(path.read_text())


@pytest.fixture(scope="module", params=[(c, s) for c in CONFIGS
                                        for s in SEEDS],
                ids=lambda cs: f"{cs[0]}-{cs[1]}")
def program(request):
    name, seed = request.param
    cfg = dict(_config(name), verify=True)
    return Cell(cfg, Mix(1, [], 1), seed, device="cpu", factor=FACTOR)


def _bindings(template, seed):
    rng = np.random.default_rng(seed)
    middle = tuple(b for p in template.params
                   for b in zip(p.names, p.values(0.5, rng)))
    drawn = tuple(b for p in template.params
                  for b in zip(p.names, p.values(rng.random(), rng)))
    return dict.fromkeys([middle, drawn])


def _anti(plan) -> bool:
    """An anti join at the top: at TPC-DS's ratios of sales to items every
    item sells, so the answer is empty."""
    while plan["op"] in ("aggregate", "project", "filter"):
        plan = plan["child"]
    return plan["op"] == "join" and plan["type"] == "left_anti"


@pytest.mark.parametrize("query", QUERIES)
def test_reference_rows_equal_the_program(program, query):
    template = load_template(query)
    for binding in _bindings(template, program.seed):
        inst = Instance(template, binding)
        program.submit(inst.sql, "q")
        (report,) = program.service.run()
        answer = fetch(report.results["q"].table)
        ref = compare.relation_to_numpy(evaluate(inst.plan, program.tables))
        same, gap, what = compare.gap(answer, ref)
        assert same, f"{query} {binding}: {what}"
        assert gap <= 1e-5, f"{query} {binding}: gap {gap} at {what}"
        if not _anti(template.plan):
            assert len(next(iter(answer.values()))) > 0, "an empty answer"


def test_the_control_is_the_reference_in_bfloat16():
    tables = datagen.base_tables(_config(CONFIGS[0]), 5, "cpu", FACTOR)
    plan = load_template("q2_chain7").plan
    lo = evaluate(plan, tables, dtype=torch.bfloat16)[0]
    assert lo["sum_ss_net_profit"].dtype == torch.bfloat16
    assert evaluate(plan, tables)[0]["sum_ss_net_profit"].dtype == \
        torch.float64
