"""The port's host training loop and data pipeline
(``repro_torch.training.train_loop``, ``repro_torch.training.data``):
tests/test_training.py's cases in the port, the properties the reference's
``batch_for_step`` promises (its bits come from ``jax.random`` and are not
reproduced), the refusals without a card, and the refusals of a mesh."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.relshard import plan_model
from repro_torch.examples import train_lm
from repro_torch.models.config import ShapeConfig
from repro_torch.training import checkpoint as ck
from repro_torch.training import optimizer as opt
from repro_torch.training import train_loop
from repro_torch.training.data import DataConfig, batch_for_step
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import make_train_step, train
from repro_torch.training.tree import tree_leaves

SHAPE = ShapeConfig("t", 64, 4, "train")
MESH1 = (("data", 1), ("model", 1))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_cfg():
    return dataclasses.replace(get_smoke_config("tinyllama_1_1b"),
                               n_layers=2, d_model=64, d_ff=128, vocab=256)


def test_loss_decreases(capsys):
    cfg = small_cfg()
    plan = plan_model(cfg, MESH1, SHAPE, fsdp=False)
    out = train(cfg, plan, None, steps=40, global_batch=4, seq_len=64,
                opt_cfg=OptConfig(lr=2e-3, warmup_steps=5), log_every=5,
                device="cpu")
    hist = out["history"]
    assert [s for s, _ in hist] == [0, 5, 10, 15, 20, 25, 30, 35, 39]
    assert hist[-1][1] < hist[0][1] - 0.3, hist
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(hist)
    assert lines[0].startswith("[train] step     0 loss ")


def test_checkpoint_restart_exact(tmp_path, capsys):
    """Kill-and-restart must reproduce the exact same training state."""
    cfg = small_cfg()
    plan = plan_model(cfg, MESH1, SHAPE, fsdp=False)
    o = OptConfig(lr=1e-3, warmup_steps=5)
    d = str(tmp_path / "ck")
    full = train(cfg, plan, None, steps=20, global_batch=4, seq_len=64,
                 opt_cfg=o, ckpt_dir=d, ckpt_every=10, resume=False,
                 log_every=100, device="cpu")
    assert ck.latest_step(d) == 20
    capsys.readouterr()
    # resume from step 10 (the later checkpoint removed) and run to 20
    import shutil
    shutil.rmtree(f"{d}/step_00000020")
    resumed = train(cfg, plan, None, steps=20, global_batch=4, seq_len=64,
                    opt_cfg=o, ckpt_dir=d, ckpt_every=100, resume=True,
                    log_every=100, device="cpu")
    assert "[train] resumed from step 10" in capsys.readouterr().out
    assert [s for s, _ in resumed["history"]] == [19]
    for a, b in zip(tree_leaves(full["params"]),
                    tree_leaves(resumed["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-4)
    assert int(resumed["opt_state"]["step"]) == 20


def test_checkpoint_holds_params_and_opt(tmp_path):
    cfg = dataclasses.replace(small_cfg(), optimizer="adafactor")
    plan = plan_model(cfg, MESH1, SHAPE, fsdp=False)
    d = str(tmp_path / "ck")
    out = train(cfg, plan, None, steps=2, global_batch=2, seq_len=16,
                ckpt_dir=d, ckpt_every=2, log_every=100, device="cpu")
    like = {"params": out["params"], "opt": out["opt_state"]}
    assert "fact" in out["opt_state"]
    restored, extra = ck.restore(d, 2, like)
    assert extra == {"arch": cfg.name}
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored),
                                                 tree_leaves(like)))


def test_train_step_metrics_and_in_place_update():
    cfg = small_cfg()
    plan = plan_model(cfg, MESH1, SHAPE, fsdp=False)
    from repro_torch.models import lm
    params = lm.init_params(cfg, 0, "cpu")
    before = [t.clone() for t in tree_leaves(params)]
    o = OptConfig(lr=1e-3, warmup_steps=1)
    state = opt.init_opt_state(o, params)
    batch = batch_for_step(DataConfig(cfg.vocab, 16, 2), 0, "cpu")
    p2, s2, m = make_train_step(cfg, plan, None, o)(params, state, batch)
    assert p2 is params and s2 is state
    assert set(m) == {"loss", "ce_loss", "moe_aux", "moe_dropped",
                      "grad_norm", "lr"}
    assert all(not v.requires_grad for v in m.values())
    assert all(not t.requires_grad for t in tree_leaves(params))
    assert all(not torch.equal(a, b) for a, b in
               zip(before, tree_leaves(params)))
    assert float(m["lr"]) == pytest.approx(1e-3)


# ---------------------------------------------------------------------------
# The data pipeline
# ---------------------------------------------------------------------------

def test_data_pipeline_deterministic():
    dc = DataConfig(vocab=256, seq_len=32, global_batch=4, seed=3)
    b1 = batch_for_step(dc, 7, "cpu")
    b2 = batch_for_step(dc, 7, "cpu")
    b3 = batch_for_step(dc, 8, "cpu")
    np.testing.assert_array_equal(b1["tokens"].numpy(), b2["tokens"].numpy())
    assert not np.array_equal(b1["tokens"].numpy(), b3["tokens"].numpy())
    other_seed = batch_for_step(dataclasses.replace(dc, seed=4), 7, "cpu")
    assert not torch.equal(b1["tokens"], other_seed["tokens"])


def test_batch_properties():
    V = 8192
    dc = DataConfig(vocab=V, seq_len=256, global_batch=16, seed=1,
                    n_cond_tokens=4, d_model=32)
    b = batch_for_step(dc, 2, "cpu")
    tok = b["tokens"]
    assert tok.dtype == torch.int32 and tok.shape == (16, 256)
    assert int(tok.min()) >= 0 and int(tok.max()) < V
    # every odd position is its predecessor plus one, mod V
    assert torch.equal(tok[:, 1::2], (tok[:, 0::2] + 1) % V)
    # even positions: floor(V^u) - 1 for u uniform, so about half lie
    # below sqrt(V) - 1 and a quarter below V^(1/4) - 1
    even = tok[:, 0::2].double()
    assert abs(float((even < math.sqrt(V) - 1).double().mean()) - 0.5) < 0.05
    assert abs(float((even < V ** 0.25 - 1).double().mean()) - 0.25) < 0.05
    cond = b["cond_emb"]
    assert cond.dtype == torch.bfloat16 and cond.shape == (16, 4, 32)
    assert float(cond.float().std()) == pytest.approx(0.02, rel=0.1)
    assert "cond_emb" not in batch_for_step(DataConfig(V, 8, 2), 0, "cpu")


def test_batch_moves_to_the_device_it_is_given():
    dc = DataConfig(vocab=64, seq_len=8, global_batch=2, n_cond_tokens=2,
                    d_model=4)
    b = batch_for_step(dc, 0, "meta")
    assert b["tokens"].device.type == "meta"
    assert b["cond_emb"].device.type == "meta"


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_without_a_card_train_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = small_cfg()
    plan = plan_model(cfg, MESH1, SHAPE, fsdp=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg, plan, None, steps=1, global_batch=2, seq_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_for_step(DataConfig(64, 8, 2), 0)


def test_without_a_card_the_example_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm.main(["--steps", "1", "--ckpt", str(tmp_path / "ck")])


def test_a_mesh_raises(tmp_path):
    cfg = small_cfg()
    plan = plan_model(cfg, MESH1, SHAPE, fsdp=False)
    mesh = object()
    with pytest.raises(NotImplementedError, match="item 5"):
        train_loop.batch_specs(plan, False)
    with pytest.raises(NotImplementedError, match="item 5"):
        train_loop.sharding_trees(cfg, plan, mesh, OptConfig(), {})
    with pytest.raises(NotImplementedError, match="item 5"):
        opt.opt_state_specs(OptConfig(), {})
    ck.save(str(tmp_path), 1, {"w": torch.ones(2)})
    with pytest.raises(NotImplementedError, match="item 5"):
        ck.restore(str(tmp_path), 1, {"w": torch.ones(2)},
                   shardings={"w": mesh})
    with pytest.raises(NotImplementedError, match="item 5"):
        make_train_step(cfg, plan, mesh, OptConfig())
    with pytest.raises(NotImplementedError, match="item 5"):
        train(cfg, plan, mesh, steps=1, global_batch=2, seq_len=16,
              device="cpu")
