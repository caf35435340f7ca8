"""The LM's sharded paths on ``torch.distributed`` (gloo, on the CPU),
against the port's single-device path and the JAX package's sharded run.

Cases (``tests/helpers/lm_shard.py``): smoke configs of every family on
2x2, 1x4 and 1x8 meshes, under ``plan_model``'s plans and forced
strategies, through forward (hidden states, MoE load, drops and aux loss),
prefill logits, teacher-forced decode steps, ``train_loss`` and its
gradients. Between them every attention mode (1x4 and 2x2 "head", 1x8
"seq" at S 16, "batch" at S 12), both embed/head strategies, both MoE
strategies, both ``tp`` values, fsdp on and off, the batch-split and the
sequence-split KV cache run.

One spawn per world size runs every case in every rank (FileStore
rendezvous); one subprocess runs the reference on 8 forced host devices
(``tests/helpers/lm_shard_ref.py``), started first because the MoE cases
force its recorded routing on the port. Tolerances:

* sharded vs the port's mesh=None, and vs the reference's sharded run:
  |d| <= 2^-4 + 2^-5 |ref| elementwise and mean |d| <= 2^-6 (the bf16
  bounds of the other cross-package LM tests), losses within 2^-9 relative, every gradient leaf within 2^-4
  relative L2;
* expert parallel: ``moe_load`` and ``moe_dropped`` equal the reference's
  exactly on its routing; against mesh=None only at a capacity factor
  where nothing drops (per-shard capacities differ from the global one),
  and its aux loss is the mean of the shards' Switch losses, not the
  global one, so it is held to the reference's only;
* zamba2: the reference's own sharded forward leaves its unsharded one
  by more than the bounds above (mean 0.02 at these inputs: its Mamba
  blocks run tensor-parallel, the port's replicated over the model axis).
  The port's sharded run is held to the reference's unsharded run within
  the bounds, and to its sharded run within that spread (plus the bounds'
  atol and mean).

Training (world 4): a train step on 2x2 (AdamW; Adafactor with bf16
gradients) and 1x4 (Adafactor) against mesh=None's: loss within 2^-9, the
gradients' global norm within 2^-4 relative, the updated params within 2
lr of it and within lr/8 on average per leaf (the first step moves a
param by about lr times the sign of its gradient, and the gradients
differ in bf16 rounding: a sign flips where that rounding moves a
gradient across zero); three ``apply_updates`` on the same fixed gradients equal
mesh=None's within fp32 rounding (rtol 2^-20, atol 1e-8), their global
norms too (a replicated leaf counted once); a checkpoint saved on 2x2
restores bit-equal on 1x4 and on no mesh.

The engine (world 4): ``plan_model``'s own plan for 2x2 (fsdp over data,
the slots over data) drains more requests than slots, its tokens those of
the engine on one device or parting at near-ties of its logits.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.models import lm
from repro_torch.training import checkpoint as ck
from repro_torch.training import optimizer as opt
from tests.helpers import lm_shard as H

REPO = Path(__file__).resolve().parents[1]
WORLDS = (4, 8)
RTOL, ATOL, MEAN = 2.0 ** -5, 2.0 ** -4, 2.0 ** -6
LOSS_RTOL = 2.0 ** -9
GRAD_REL = 2.0 ** -4


def _cases(world):
    return [n for n in H.CASES if H.world_of(n) == world]


def _spawn(world, d, routing=None, training=False):
    d.mkdir()
    mp.start_processes(H.rank_main, args=(world, str(d / "store"), str(d),
                                          _cases(world), routing, training),
                       nprocs=world, start_method="spawn")
    with open(d / "port.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the reference's outputs, "port": the port's sharded ones,
    "none": the port's mesh=None ones}, by case."""
    d = tmp_path_factory.mktemp("sharded_lm")
    with open(d / "ref_in.pkl", "wb") as f:
        pickle.dump({n: {"plan": H.plan_fields(H.case_plan(n)[1]),
                         "params": H.case_params(n)} for n in H.CASES}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]))
    ref_proc = subprocess.Popen(
        [sys.executable, "-m", "tests.helpers.lm_shard_ref",
         str(d / "ref_in.pkl"), str(d / "ref_out.pkl")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        port = _spawn(8, d / "w8")         # no MoE: needs no routing
        _, err = ref_proc.communicate(timeout=600)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
    assert ref_proc.returncode == 0, err[-4000:]
    with open(d / "ref_out.pkl", "rb") as f:
        ref = pickle.load(f)
    routing = {n: ref[n]["routing"] for n in _cases(4)}
    port.update(_spawn(4, d / "w4", routing, training=True))
    none = {n: H.port_case(n, None, routing=ref[n]["routing"])
            for n in H.CASES}
    training = {n: H.train_case(n, None)[0] for n in H.TRAIN_CASES}
    return {"ref": ref, "port": port, "none": none, "training": training,
            "engine": H.engine_case(None), "ckpt": d / "w4" / "ckpt"}


def assert_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want)
    bad = err > ATOL + RTOL * np.abs(want)
    assert not bad.any(), (f"{what}: {bad.sum()} beyond the bounds, max "
                           f"{err.max():.4g}")
    assert err.mean() <= MEAN, f"{what}: mean {err.mean():.4g}"


def assert_loss(got, want, what):
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want)), (
        what, float(got), float(want))


def assert_grads(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        rel = (np.linalg.norm(got[k] - want[k])
               / max(np.linalg.norm(want[k]), 1e-12))
        assert rel <= GRAD_REL, f"{what} {k}: relative L2 {rel:.4g}"


def _outputs(vs_none=False):
    out = []
    for n, case in H.CASES.items():
        entries = case[6]
        ep = case[3].get("moe_strategy") == "expert_parallel"
        if "fwd" in entries:
            out.append((n, "hidden"))
        for e in ("prefill", "decode", "loss", "grads"):
            # expert parallelism's per-shard capacities drop assignments
            # the single device keeps: against it, only where none drop
            if e in entries and not (vs_none and ep and e != "decode"):
                out.append((n, e))
    return out


OUTPUTS = _outputs()
VS_NONE = _outputs(vs_none=True)


@pytest.mark.parametrize("name,key", VS_NONE,
                         ids=[f"{n}-{k}" for n, k in VS_NONE])
def test_sharded_equals_the_single_device_path(runs, name, key):
    got, want = runs["port"][name][key], runs["none"][name][key]
    what = f"{name} {key} vs mesh=None"
    if key == "loss":
        assert_loss(got, want, what)
    elif key == "grads":
        assert_grads(got, want, what)
    elif (key == "hidden" and H.CASES[name][3].get("moe_strategy")
          == "expert_parallel"):
        # per-shard capacities drop other assignments than the global one
        # does: the outputs agree where nothing drops
        assert_close(runs["port"][name]["dropless"],
                     runs["none"][name]["dropless"], what + " (dropless)")
        for k in ("dropless_moe_load", "dropless_moe_dropped"):
            assert np.array_equal(runs["port"][name][k],
                                  runs["none"][name][k]), k
        assert float(runs["port"][name]["dropless_moe_dropped"]) == 0.0
    else:
        assert_close(got, want, what)


@pytest.mark.parametrize("name,key", OUTPUTS,
                         ids=[f"{n}-{k}" for n, k in OUTPUTS])
def test_sharded_equals_the_reference_sharded_run(runs, name, key):
    got, ref = runs["port"][name][key], runs["ref"][name]
    what = f"{name} {key} vs the reference's sharded run"
    if key == "loss":
        assert_loss(got, ref[key], what)
    elif key == "grads":
        assert_grads(got, ref[key], what)
    elif key + "_unsharded" in ref:
        # zamba2: see the module docstring
        whole = ref[key + "_unsharded"]
        assert_close(got, whole, f"{name} {key} vs the reference unsharded")
        spread = np.abs(ref[key] - whole)
        err = np.abs(np.asarray(got, np.float64) - ref[key])
        assert err.max() <= spread.max() + ATOL, (what, err.max())
        assert err.mean() <= spread.mean() + MEAN, (what, err.mean())
    else:
        assert_close(got, ref[key], what)


MOE = [n for n, c in H.CASES.items() if c[0] in ("qwen3_moe_235b_a22b",
                                                  "dbrx_132b")]


@pytest.mark.parametrize("name", MOE)
def test_moe_load_and_drops_equal_the_reference(runs, name):
    port, ref = runs["port"][name], runs["ref"][name]
    assert np.array_equal(port["hidden_moe_load"], ref["hidden_moe_load"])
    assert np.array_equal(port["hidden_moe_dropped"],
                          ref["hidden_moe_dropped"])
    assert abs(float(port["hidden_moe_aux"]) - float(ref["hidden_moe_aux"])
               ) <= 2.0 ** -8 * abs(float(ref["hidden_moe_aux"]))
    if H.CASES[name][3].get("moe_strategy") == "replicate":
        # the global capacity: the same drops as one device
        assert np.array_equal(port["hidden_moe_dropped"],
                              runs["none"][name]["hidden_moe_dropped"])


def test_every_case_moved_what_its_placement_implies(runs):
    """Collectives ran where the placement needs them: an all-to-all only
    under expert parallelism, a reduce-scatter only where fsdp gathers
    weights for gradients, and every case some collective."""
    for name, case in H.CASES.items():
        calls = runs["port"][name]["stats"]
        ep = case[3].get("moe_strategy") == "expert_parallel"
        assert (calls["all_to_all"] > 0) == ep, (name, calls)
        assert sum(calls.values()) > 0, name


@pytest.mark.parametrize("name", list(H.TRAIN_CASES))
def test_a_sharded_train_step_equals_the_single_device_step(runs, name):
    got, want = runs["port"]["training"][name], runs["training"][name]
    assert_loss(got["loss"], want["loss"], name)
    assert abs(got["grad_norm"] - want["grad_norm"]) <= (
        GRAD_REL * want["grad_norm"]), (name, got["grad_norm"],
                                        want["grad_norm"])
    lr = H.train_setup(name)[2].lr
    for a, b in zip(_leaves(got["step"]), _leaves(want["step"])):
        err = np.abs(a - b)
        assert err.max() <= 2 * lr + 1e-6, name
        # a sign flips only where bf16 rounding moves a gradient across 0
        assert err.mean() <= lr / 8, (name, err.mean() / lr)


def test_the_engine_on_plan_models_own_2x2_plan(runs):
    """The engine on 2x2 under ``plan_model``'s default plan (fsdp over
    data, the slots split over data) completes every request with the
    tokens of the engine on one device, or parts from them where the
    single device's logits hold a near-tie (within the bf16 elementwise
    bound)."""
    cfg, plan = H.engine_plan()
    assert plan.fsdp_axes == ("data",) and plan.batch_axes == ("data",)
    _, _, _, n_req, new = H.ENGINE
    got, want = runs["port"]["engine"], runs["engine"]
    assert len(got) == len(want) == n_req
    params = lm.init_params(cfg, 2, device="cpu")
    for i, (a, b) in enumerate(zip(got, want)):
        assert len(a) == len(b) == new
        if a == b:
            continue
        j = next(t for t in range(new) if a[t] != b[t])
        with torch.no_grad():
            lg = lm.prefill(params, cfg, plan, None, torch.tensor(
                [H.engine_prompt(i) + b[:j]], dtype=torch.int32))[0].float()
        gap = float((lg[a[j]] - lg[b[j]]).abs())
        size = float(torch.maximum(lg[a[j]].abs(), lg[b[j]].abs()))
        assert gap <= ATOL + RTOL * size, (i, j, gap)


@pytest.mark.parametrize("name", list(H.TRAIN_CASES))
def test_sharded_updates_equal_the_single_device_ones(runs, name):
    got, want = runs["port"]["training"][name], runs["training"][name]
    np.testing.assert_allclose(got["update_norms"], want["update_norms"],
                               rtol=2.0 ** -20)
    for a, b in zip(_leaves(got["updates"]), _leaves(want["updates"])):
        np.testing.assert_allclose(a, b, rtol=2.0 ** -20, atol=1e-8)


def test_the_global_norm_counts_a_replicated_leaf_once(runs):
    """Every case's params hold replicated leaves (the norms) beside split
    ones; the sharded norm of the fixed gradients is the whole one."""
    cfg, plan, opt_cfg, tree, _, grads = H.train_setup("adamw_2x2")
    whole = float(opt._global_norm(opt_cfg, lm.params_from_numpy(grads,
                                                                  "cpu")))
    got = runs["port"]["training"]["adamw_2x2"]["update_norms"][0]
    assert got == pytest.approx(whole, rel=2.0 ** -20)
    specs = lm.param_specs(cfg, tree, plan)
    assert any(all(e is None for e in s) for s in _leaves(specs))


def test_a_checkpoint_moves_between_meshes_bit_equal(runs):
    """Saved from the 2x2 run after its three updates; restored on 1x4
    (in the ranks) and on no mesh (here): both bit-equal to the saved
    params, and the two restored states bit-equal."""
    cfg, plan, opt_cfg, tree, _, _ = H.train_setup("adamw_2x2")
    want = runs["port"]["training"]["adamw_2x2"]["updates"]
    on14 = runs["port"]["training"]["checkpoint"]
    like = lm.params_from_numpy(tree, "cpu")
    back, _ = ck.restore(str(runs["ckpt"]), 1, {
        "params": like, "opt": opt.init_opt_state(opt_cfg, like)})
    for a, b, c in zip(_leaves(want), _leaves(on14["params"]),
                       _leaves(back["params"])):
        assert np.array_equal(a, b.numpy()) and np.array_equal(a, c.numpy())
    for a, b in zip(_leaves(on14["opt"]), _leaves(back["opt"])):
        assert torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]
