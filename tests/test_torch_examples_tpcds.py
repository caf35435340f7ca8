"""The port's ``reljoin_tpcds`` example against ``examples/reljoin_tpcds.py``
at its smallest setting: the same printed workloads, wins and PSTS; only
the wall times may differ, and they are masked. The case of
``test_torch_examples.py``'s parametrized test, in a file of its own so that
under ``--dist loadfile`` it runs on a worker of its own, among the first
files queued (``LONG_FILES`` in the repo-root ``conftest.py``)."""

import sys

import pytest

from repro_torch.examples import reljoin_tpcds
from test_torch_examples import case_id, printed, reference_script

ARGV = ["--scale", "0.05", "--p", "4"]


@pytest.mark.parametrize("name,port,argv", [
    pytest.param("reljoin_tpcds", reljoin_tpcds, ARGV,
                 id=case_id("reljoin_tpcds", reljoin_tpcds, ARGV, 1)),
])
def test_example_prints_what_the_reference_prints(capsys, monkeypatch, name,
                                                  port, argv):
    ref = reference_script(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    expected = printed(capsys, ref.main)
    got = printed(capsys, lambda: port.main([*argv, "--device", "cpu"]))
    assert expected
    assert got == expected
