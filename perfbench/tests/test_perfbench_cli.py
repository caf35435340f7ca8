"""The command as a check runs it: with no card it exits non-zero and
prints no result; from a directory that holds only ``BENCHMARK.json`` and
the benchmark's files it exits non-zero too. On the card, one short run of
each cell is correct."""

import json
import shutil
import subprocess
import sys

import _paths
import pytest

ROOT = _paths.ROOT
ARGS = ["--seed", "4294967311", "--seconds", "2", "--trace", "0"]


def _card() -> bool:
    import torch
    return torch.cuda.is_available()


WORKLOADS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(cwd, workload=WORKLOADS[0], timeout=900):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           workload, *ARGS], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout)


def test_no_card_no_result():
    if _card():
        pytest.skip("a CUDA card is present")
    done = _run(ROOT)
    assert done.returncode != 0
    assert not done.stdout.strip()


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    done = _run(tmp_path)
    assert done.returncode != 0
    assert not done.stdout.strip()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_short_run_on_the_card_is_correct(workload):
    if not _card():
        pytest.skip("needs a CUDA card")
    done = _run(ROOT, workload)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
