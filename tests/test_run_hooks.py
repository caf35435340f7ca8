"""What the repo-root ``conftest.py`` does to a run as a whole: the longest
files first, each pytest-xdist worker's share of the cores, and a time
limit on every phase of every test."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT_CONFTEST = Path(__file__).resolve().parents[1] / "conftest.py"


def _root_conftest():
    spec = importlib.util.spec_from_file_location("root_conftest",
                                                  ROOT_CONFTEST)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_long_files_come_first_longest_first():
    hooks = _root_conftest()
    long = list(hooks.LONG_FILES)
    assert list(hooks.LONG_FILES.values()) == sorted(
        hooks.LONG_FILES.values(), reverse=True)
    names = ["test_a.py", long[2], "test_b.py", long[0], "test_a.py", long[2]]
    items = [SimpleNamespace(path=Path("tests") / name, index=i)
             for i, name in enumerate(names)]
    hooks.pytest_collection_modifyitems(items)
    assert [item.index for item in items] == [3, 1, 5, 0, 2, 4]


def test_a_long_file_may_take_twice_its_seconds():
    hooks = _root_conftest()
    other = SimpleNamespace(path=Path("tests/test_run_hooks.py"))
    assert hooks.time_limit(other) == hooks.TIME_LIMIT == 300
    for name, seconds in hooks.LONG_FILES.items():
        assert (Path(__file__).parent / name).exists(), name
        item = SimpleNamespace(path=Path("tests") / name)
        assert hooks.time_limit(item) == max(300, 2 * seconds)


SLOW_TESTS = '''
import os
import time

import pytest


@pytest.fixture
def slow_fixture():
    time.sleep(30)


def test_sleeps_past_its_limit():
    time.sleep(30)


def test_setup_sleeps_past_its_limit(slow_fixture):
    pass


def test_omp_pool_takes_its_share_of_the_cores():
    assert os.environ["OMP_NUM_THREADS"] == str(max(1, os.cpu_count() // 2))
'''


def test_a_phase_past_its_limit_fails_with_a_stack(tmp_path):
    """The root conftest with a limit of 1 s, in a run that sees two xdist
    workers: a call and a setup past it fail, naming it, with stacks."""
    text = ROOT_CONFTEST.read_text()
    assert "\nTIME_LIMIT = 300\n" in text
    (tmp_path / "conftest.py").write_text(
        text.replace("\nTIME_LIMIT = 300\n", "\nTIME_LIMIT = 1\n"))
    (tmp_path / "test_slow.py").write_text(SLOW_TESTS)
    env = {k: v for k, v in os.environ.items()
           if k != "OMP_NUM_THREADS" and not k.startswith("PYTEST_")}
    env["PYTEST_XDIST_WORKER_COUNT"] = "2"
    env["PYTEST_DISABLE_PLUGIN_AUTOLOAD"] = "1"
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "test_slow.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60)
    assert run.returncode == 1, run.stdout + run.stderr
    assert "1 failed, 1 passed, 1 error" in run.stdout, run.stdout
    assert ("call of test_slow.py::test_sleeps_past_its_limit passed its "
            "time limit of 1 s") in run.stdout
    assert ("setup of test_slow.py::test_setup_sleeps_past_its_limit passed "
            "its time limit of 1 s") in run.stdout
    assert run.stderr.count("(most recent call first)") >= 2, run.stderr
    assert "in test_sleeps_past_its_limit\n" in run.stderr
    assert "in slow_fixture\n" in run.stderr
