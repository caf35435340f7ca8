"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's accounting, in two processes started side by side: the
port's on a fake world of 4 (``tests/helpers/dryrun_port.py``, no JAX)
and the reference's on 4 forced host devices
(``tests/helpers/dryrun_ref.py``), both on the smoke tinyllama's train
step, prefill and decode step on a 2x2 mesh under one plan.

Counted FLOPs per device against ``hlo_cost.analyze`` of the reference's
compiled module: prefill and decode equal; the train step within 2%:
the reference's backward computes each layer's attention scores
(Q K^T) once more than the port's rematerialized block does (1,048,576
FLOPs) and takes the gold logit as a dot (16,128), where the port
multiplies and sums. Limits: 5% for forward entry points, 10% for the
train step. Collective and HBM bytes are printed, not held: XLA
all-reduces the activations in f32 where the port moves bf16, and the
analyzer reads an iota replica group (``[2,2]<=[4]``) as the whole world
(ring factor 3/4 in place of 1/2); its fusion model counts every fusion
root, where ``count`` leaves elementwise ops out.
"""

import ast
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch import roofline as ref_rf
from repro.models.config import SHAPE_BY_NAME as REF_SHAPES
from repro.models.config import shape_applicable as ref_applicable
from repro.configs import get_config as ref_config
from repro_torch.configs import get_smoke_config
from repro_torch.core.relshard import plan_model
from repro_torch.launch import dryrun, report
from repro_torch.models.config import ShapeConfig
from tests.helpers.lm_shard import REF_HBM, REF_W, plan_fields

REPO = Path(__file__).resolve().parents[1]
ARCH = "tinyllama_1_1b"
KINDS = ("train", "prefill", "decode")
#: the stated limits of |port / reference - 1| on counted FLOPs
FLOP_LIMIT = {"train": 0.10, "prefill": 0.05, "decode": 0.05}


def _cases():
    cfg = get_smoke_config(ARCH)
    out = {}
    for kind in KINDS:
        shape = ShapeConfig(kind, 64, 4, kind)
        plan = plan_model(cfg, (("data", 2), ("model", 2)), shape, w=REF_W,
                          hbm_bytes=REF_HBM, fsdp=kind == "train")
        out[kind] = (ARCH, (kind, 64, 4, kind), plan_fields(plan))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(_cases(), f)
    path = os.pathsep.join([str(REPO / "src"), str(REPO)])
    procs = {
        "ref": subprocess.Popen(
            [sys.executable, "-m", "tests.helpers.dryrun_ref",
             str(tmp / "cases.pkl"), str(tmp / "ref.pkl")], cwd=REPO,
            env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
                     XLA_FLAGS="--xla_force_host_platform_device_count=4"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "port": subprocess.Popen(
            [sys.executable, "-m", "tests.helpers.dryrun_port",
             str(tmp / "cases.pkl"), str(tmp / "port.pkl"),
             str(tmp / "records")], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=path),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    out = {}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{name}: {err[-3000:]}"
        with open(tmp / f"{name}.pkl", "rb") as f:
            out[name] = pickle.load(f)
    out["records"] = tmp / "records"
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_counted_flops_against_the_reference_analyzer(runs, kind):
    port, ref = runs["port"][kind], runs["ref"][kind]
    ratio = port["flops"] / ref["flops"]
    print(f"{kind}: FLOPs port {port['flops']:.0f} reference "
          f"{ref['flops']:.0f} ratio {ratio:.4f}; HBM bytes port "
          f"{port['bytes']:.0f} reference {ref['bytes']:.0f} ratio "
          f"{port['bytes'] / ref['bytes']:.3f}; collectives port "
          f"{port['collectives']} ({port['calls']} calls) reference "
          f"{ref['collectives']}")
    assert abs(ratio - 1) <= FLOP_LIMIT[kind]
    if kind != "train":
        assert port["flops"] == ref["flops"]
    else:
        assert ref["flops"] - port["flops"] == 1_048_576 + 16_128


def test_collectives_and_memory_of_the_counted_calls(runs):
    """What the port moves on 2x2, per device: the prefill's five
    model-axis all-reduces of a rank's bf16 activations (2 rows x 64
    positions x 64), the decode cache updated in place and returned."""
    p = runs["port"]["prefill"]
    assert p["calls"] == {"all-reduce": 5}
    t = 2 * 64 * 64 * 2
    assert p["collectives"] == {"all-reduce": 5 * 2 * t * 1 / 2}
    d = runs["port"]["decode"]["memory"]
    assert d.alias_bytes == 2 * 2 * 64 * 2 * 32 * 2   # k and v blocks
    assert d.peak_estimate == (d.argument_bytes + d.output_bytes
                               + d.temp_bytes - d.alias_bytes)
    t = runs["port"]["train"]
    assert set(t["calls"]) == {"all-gather", "reduce-scatter", "all-reduce"}
    assert t["memory"].alias_bytes > 0.99 * t["memory"].argument_bytes


def test_production_meshes_have_the_reference_axes(runs):
    assert runs["port"]["mesh_256"] == (("data", "model"), (16, 16))
    assert runs["port"]["mesh_512"] == (("pod", "data", "model"),
                                        (2, 16, 16))


def _reference_record_keys():
    """The keys of ``lower_cell``'s record in the reference's source
    (importing it would set ``XLA_FLAGS``)."""
    tree = ast.parse((REPO / "src" / "repro" / "launch" /
                      "dryrun.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Dict) \
                and getattr(node.targets[0], "id", None) == "record" \
                and len(node.value.keys) > 5:
            return {k.value: ({kk.value for kk in v.keys}
                              if isinstance(v, ast.Dict) else None)
                    for k, v in zip(node.value.keys, node.value.values)}
    raise AssertionError("no record literal in the reference's dryrun.py")


def test_record_schema_matches_the_reference(runs):
    rec = runs["port"]["decode_32k"]
    assert rec["status"] == "ok"
    want = _reference_record_keys()
    for gone in ("lower_s", "compile_s"):
        del want[gone]
    want.update(count_s=None, collective_calls_per_device=None)
    assert set(rec) == set(want)
    for key, sub in want.items():
        if sub is not None:
            assert set(rec[key]) == sub, key
    assert rec["chips"] == 256
    assert rec["model_flops"] == ref_rf.model_flops(
        ref_config(ARCH), REF_SHAPES["decode_32k"])
    assert rec["collectives_per_device"].keys() == \
        rec["collective_calls_per_device"].keys()


def test_skip_records_carry_the_reference_reason(runs):
    assert runs["port"]["main"] == 0
    reason = ref_applicable(ref_config(ARCH), REF_SHAPES["long_500k"])
    for tag in ("single", "multi"):
        with open(runs["records"] / f"{ARCH}_long_500k_{tag}.json") as f:
            rec = json.load(f)
        assert rec == {"arch": ARCH, "shape": "long_500k", "mesh": tag,
                       "status": "skip", "reason": reason}


def test_report_renders_the_records(runs, capsys, monkeypatch):
    monkeypatch.setattr(report, "DRYRUN_DIR", str(runs["records"]))
    assert report.summary() == ("single-pod: 1 ok / 1 skip / 0 error; "
                                "multi-pod: 0 ok / 1 skip / 0 error "
                                "(of 40 cells each)")
    single = report.dryrun_table("single").splitlines()
    assert single[0] == "### Mesh: single (16x16 = 256 GPUs)"
    assert "count s" in single[2]
    rec = runs["port"]["decode_32k"]
    row = next(r for r in single if "decode_32k" in r)
    assert row.endswith(f"| {rec['count_s']} |")
    assert any("long_500k | SKIP(full-attention)" in r for r in single)
    roof = report.roofline_table().splitlines()
    assert "6ND/counted" in roof[0]
    row = next(r for r in roof if "decode_32k" in r)
    assert f"| {rec['roofline']['bound']} |" in row
    report.main()
    assert "## Roofline (single-pod, 256 GPUs)" in capsys.readouterr().out


@pytest.mark.parametrize("rc, writes", [(-9, True), (-9, False), (0, False)],
                         ids=["killed-after-writing", "killed", "no-record"])
def test_a_failed_child_leaves_an_error_record_not_the_old_one(
        tmp_path, monkeypatch, rc, writes):
    """An earlier run's 'ok' record must not stand for a child that was
    killed or wrote nothing."""
    fname = tmp_path / f"{ARCH}_decode_32k_single.json"
    fname.write_text(json.dumps({"status": "ok", "stale": True}))

    def run(cmd, **kw):
        assert not fname.exists()
        if writes:
            fname.write_text(json.dumps({"status": "ok"}))
        return subprocess.CompletedProcess(cmd, rc, "", "Killed")
    monkeypatch.setattr(dryrun.subprocess, "run", run)
    rec = dryrun._child(ARCH, "decode_32k", "single", str(tmp_path))
    assert rec["status"] == "error"
    assert rec["error"].startswith(f"child exited {rc}")
    assert json.loads(fname.read_text()) == rec
