"""Training step factory + host loop with checkpoint/restart.

``make_train_step`` builds the (params, opt_state, batch) -> (params,
opt_state, metrics) step: autograd takes the gradients of
``models.lm.train_loss`` with respect to every param leaf, and
``apply_updates`` writes the params and the optimizer state in place. The
step makes no host sync. The host loop adds fault tolerance: periodic
atomic checkpoints, resume-from-latest, and deterministic data replay.
Only one device is ported: the sharding trees a mesh needs wait for
``ROADMAP.md`` queue 1, item 5.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from ..core.relshard import ShardingPlan
from ..layers.common import require_no_mesh
from ..models import lm
from ..models.config import ModelConfig
from . import checkpoint as ckpt_mod
from .data import DataConfig, batch_for_step
from .optimizer import OptConfig, apply_updates, init_opt_state
from .tree import tree_leaves, tree_map, tree_unflatten

_NO_MESH = ("sharding trees need a device mesh, which is not ported yet "
            "(ROADMAP.md queue 1, item 5, LM slice 4)")


def batch_specs(plan: ShardingPlan, has_cond: bool):
    raise NotImplementedError(_NO_MESH)


def make_train_step(cfg: ModelConfig, plan: ShardingPlan, mesh,
                    opt_cfg: OptConfig, lt_schedule: bool = False):
    """Returns the train step. Its metrics are device tensors: the loss,
    ``train_loss``'s metrics, and the update's ``grad_norm`` and ``lr``."""
    require_no_mesh(mesh)

    def train_step(params, opt_state, batch):
        work = tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = tree_leaves(work)
        with torch.enable_grad():
            loss, metrics = lm.train_loss(work, cfg, plan, None, batch,
                                          lt_schedule=lt_schedule)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_unflatten(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
        params, opt_state, opt_metrics = apply_updates(opt_cfg, params,
                                                       opt_state, grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def sharding_trees(cfg: ModelConfig, plan: ShardingPlan, mesh,
                   opt_cfg: OptConfig, params_shape):
    raise NotImplementedError(_NO_MESH)


def train(cfg: ModelConfig, plan: ShardingPlan, mesh=None, *,
          steps: int, global_batch: int, seq_len: int,
          opt_cfg: Optional[OptConfig] = None, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 100, resume: bool = True, log_every: int = 10,
          seed: int = 0, device=None) -> Dict[str, Any]:
    """Host training loop (used by the examples). Runs on the CUDA card
    unless ``device`` names another, and raises without a card. The host
    waits for the card only on log steps and checkpoints."""
    require_no_mesh(mesh)
    opt_cfg = opt_cfg or OptConfig(name=cfg.optimizer)
    params = lm.init_params(cfg, seed, device)
    dev = tree_leaves(params)[0].device
    opt_state = init_opt_state(opt_cfg, params)
    data_cfg = DataConfig(cfg.vocab, seq_len, global_batch, seed,
                          cfg.n_cond_tokens, cfg.d_model)

    start = 0
    if ckpt_dir and resume:
        last = ckpt_mod.latest_step(ckpt_dir)
        if last is not None:
            state, _ = ckpt_mod.restore(ckpt_dir, last,
                                        {"params": params,
                                         "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start = last
            print(f"[train] resumed from step {start}")

    step_fn = make_train_step(cfg, plan, None, opt_cfg)
    history = []
    t0 = time.perf_counter()
    for step in range(start, steps):
        batch = batch_for_step(data_cfg, step, dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            history.append((step, loss))
            dt = time.perf_counter() - t0
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"({dt:.1f}s)", flush=True)
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt_mod.save(ckpt_dir, step + 1,
                          {"params": params, "opt": opt_state},
                          extra={"arch": cfg.name})
    return {"params": params, "opt_state": opt_state, "history": history}
