"""Settings for a run of the test suite as a whole; the shared fixtures are
in ``tests/conftest.py``.

* Each pytest-xdist worker's OpenMP pool takes its share of the host's
  cores.
* The files of ``LONG_FILES`` are queued first, longest first, so that
  under ``--dist loadfile`` they start first instead of last.
* Every test's setup, call and teardown runs under a time limit: past it
  the phase fails, with every thread's stack printed to the run's stderr,
  instead of holding its worker until the run is cut.
"""

import faulthandler
import os
import signal
import threading

import pytest

#: Seconds that a test's setup, call or teardown may each take, unless its
#: file is in ``LONG_FILES``.
TIME_LIMIT = 300

#: The files whose tests take over ~150 s, longest first, each with the most
#: its tests took in three tier-1 runs with six xdist workers on an 8-CPU
#: host. They are queued in this order, before every other file, and a
#: phase of theirs may take twice their seconds.
LONG_FILES = {
    "test_golden_plans.py": 526,
    "test_torch_examples_tpcds.py": 331,
    "test_estimates.py": 317,
    "test_sql.py": 312,
    "test_plan_analysis.py": 277,
    "test_skew.py": 265,
    "test_models.py": 262,
    "test_torch_skew.py": 250,
    "test_joins.py": 248,
    "test_filters.py": 222,
    "test_torch_distributed.py": 216,
    "test_differential.py": 203,
    "test_torch_examples.py": 198,
    "test_planner.py": 189,
    "test_torch_hypercube.py": 187,
    "test_torch_joins.py": 173,
    "test_torch_reopt.py": 167,
}

# pytest-xdist's workers share the host's cores, so torch's OpenMP pool in
# each worker takes its share of them, not one thread a core: six workers
# on 8 CPUs ran the suite in 1,442 s with pools of 8 threads and in 992 s
# with pools of 1. This runs before any test module imports torch.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    os.environ.setdefault("OMP_NUM_THREADS",
                          str(max(1, (os.cpu_count() or 1) // int(_WORKERS))))

_STDERR = pytest.StashKey[int]()


def pytest_configure(config):
    # pytest-xdist queues files by their number of tests, most first;
    # without that reorder it keeps the order the collection hook leaves.
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False
    # The run's own stderr, which a test's output capture does not hold: a
    # stack printed there shows even if the phase never returns to Python.
    capture = config.pluginmanager.getplugin("capturemanager")
    if capture is not None:
        capture.suspend_global_capture()
    config.stash[_STDERR] = os.dup(2)
    if capture is not None:
        capture.resume_global_capture()


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR])


@pytest.hookimpl(trylast=True)
def pytest_collection_modifyitems(items):
    rank = {name: i for i, name in enumerate(LONG_FILES)}
    items.sort(key=lambda item: rank.get(item.path.name, len(rank)))


def time_limit(item):
    """Seconds that each phase of ``item`` may take."""
    return max(TIME_LIMIT, 2 * LONG_FILES.get(item.path.name, 0))


def _time_limited(item, when):
    if (not hasattr(signal, "SIGALRM")
            or threading.current_thread() is not threading.main_thread()):
        return (yield)
    limit = time_limit(item)
    stderr = item.config.stash[_STDERR]

    def expire(signum, frame):
        faulthandler.cancel_dump_traceback_later()
        faulthandler.dump_traceback(file=stderr)
        pytest.fail(f"{when} of {item.nodeid} passed its time limit of "
                    f"{limit} s")

    previous = signal.signal(signal.SIGALRM, expire)
    # The watchdog prints the stacks even if the alarm's handler never runs
    # (a phase stuck in native code). Forked and spawned ranks inherit
    # neither.
    faulthandler.dump_traceback_later(limit + 10, file=stderr)
    signal.alarm(limit)
    try:
        return (yield)
    finally:
        signal.alarm(0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    return (yield from _time_limited(item, "setup"))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _time_limited(item, "call"))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    return (yield from _time_limited(item, "teardown"))
