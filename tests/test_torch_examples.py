"""The port's examples (``python -m repro_torch.examples.<name>``) against
the scripts of the same name under ``examples/``, each at its smallest
setting: the same printed rows, methods, bytes, workloads, wins, PSTS and
serving steps. Only the wall times may differ, and they are masked.

The ``reljoin_tpcds`` case sits in ``test_torch_examples_tpcds.py``: the
two cases that compile the most (this file's ``quickstart`` and that one)
then run on separate workers of a ``--dist loadfile`` run."""

import importlib.util
import re
import sys
from pathlib import Path

import pytest

from repro_torch.examples import quickstart, reljoin_tpcds, serve_lm

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
WALL = re.compile(r"wall[= ] *[0-9.]+s")


def reference_script(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def printed(capsys, call):
    call()
    return [WALL.sub("wall=*", line)
            for line in capsys.readouterr().out.splitlines()]


def case_id(name, port, argv, index):
    """The id pytest gave each case when the three sat in one list."""
    return f"{name}-{port.__name__}-argv{index}"


@pytest.mark.parametrize("name,port,argv", [
    pytest.param("quickstart", quickstart, [],
                 id=case_id("quickstart", quickstart, [], 0)),
    pytest.param("serve_lm", serve_lm, [],
                 id=case_id("serve_lm", serve_lm, [], 2)),
])
def test_example_prints_what_the_reference_prints(capsys, monkeypatch, name,
                                                  port, argv):
    ref = reference_script(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    expected = printed(capsys, ref.main)
    got = printed(capsys, lambda: port.main([*argv, "--device", "cpu"]))
    assert expected
    assert got == expected


def test_examples_default_to_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for port in (quickstart, reljoin_tpcds, serve_lm):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.main([])
