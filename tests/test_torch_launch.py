"""``repro_torch.launch.serve`` and ``launch.train`` run with ``--smoke
--data-par 2 --model-par 2`` on the CPU (four gloo ranks they start
themselves), against the reference's launchers.

* serve prints the plan ``plan_model`` gives for the 2x2 axes (its
  strategies the reference's for the same axes), and completes every
  request in as many decode steps as the reference's launcher;
* train prints the plan and logs the same steps as the reference's
  launcher, with finite losses, and checkpoints whole arrays that restore
  on no mesh.

The reference's launchers run on one device here: the steps they log and
count do not depend on the mesh.
"""

import math
import re

import numpy as np

from repro.configs import get_smoke_config as ref_smoke
from repro.core.relshard import plan_model as ref_plan_model
from repro.launch import serve as ref_serve
from repro.launch import train as ref_train
from repro.models.config import ShapeConfig as RefShape
from repro_torch.configs import get_smoke_config
from repro_torch.core.relshard import plan_model
from repro_torch.launch import serve, train
from repro_torch.models.config import ShapeConfig
from repro_torch.training import checkpoint as ck

AXES = (("data", 2), ("model", 2))
ARGS = ["--arch", "tinyllama-1.1b", "--smoke", "--data-par", "2",
        "--model-par", "2"]


def _strategies(text):
    return re.findall(r"^\s+(\S+)\s+-> (\S+)", text, re.M)


def _run(main, argv, monkeypatch, capfd):
    monkeypatch.setattr("sys.argv", ["prog"] + argv)
    main()
    return capfd.readouterr().out


def test_serve_on_a_2x2_mesh(capfd, monkeypatch):
    serve.main(ARGS + ["--device", "cpu"])
    out = capfd.readouterr().out
    shape = ShapeConfig("serve", 128, 4, "decode")
    plan = plan_model(get_smoke_config("tinyllama_1_1b"), AXES, shape,
                      fsdp=False)
    assert "backend gloo" in out
    assert plan.explain() in out
    ref_plan = ref_plan_model(ref_smoke("tinyllama_1_1b"), AXES,
                              RefShape("serve", 128, 4, "decode"),
                              fsdp=False)
    assert _strategies(plan.explain()) == _strategies(ref_plan.explain())
    done = re.search(r"\[serve\] completed (\d+) requests in (\d+) decode "
                     r"steps; replan events: (.*)", out)
    ref_out = _run(ref_serve.main, ARGS[:3], monkeypatch, capfd)
    ref_done = re.search(r"\[serve\] completed (\d+) requests in (\d+) "
                         r"decode steps", ref_out)
    assert done and ref_done
    assert done.group(1) == "6" == ref_done.group(1)
    assert done.group(2) == ref_done.group(2)


def test_train_on_a_2x2_mesh(capfd, monkeypatch, tmp_path):
    steps = ["--steps", "3", "--batch", "4", "--seq", "32"]
    ckpt = str(tmp_path / "ck")
    train.main(ARGS + steps + ["--device", "cpu", "--ckpt", ckpt,
                               "--ckpt-every", "3"])
    out = capfd.readouterr().out
    plan = plan_model(get_smoke_config("tinyllama_1_1b"), AXES,
                      ShapeConfig("cli", 32, 4, "train"), fsdp=True)
    assert plan.explain() in out
    logged = re.findall(r"\[train\] step\s+(\d+) loss (\S+)", out)
    ref_out = _run(ref_train.main, ARGS[:3] + steps, monkeypatch, capfd)
    ref_logged = re.findall(r"\[train\] step\s+(\d+) loss (\S+)", ref_out)
    assert [s for s, _ in logged] == [s for s, _ in ref_logged] == ["0", "2"]
    assert all(math.isfinite(float(v)) for _, v in logged)
    assert ck.latest_step(ckpt) == 3
    leaves = [np.load(f"{ckpt}/step_00000003/arr_{i}.npy") for i in range(3)]
    assert all(np.isfinite(a).all() for a in leaves)
