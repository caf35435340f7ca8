"""Training step factory + host loop with checkpoint/restart.

``make_train_step`` builds the (params, opt_state, batch) -> (params,
opt_state, metrics) step: autograd takes the gradients of
``models.lm.train_loss`` with respect to every param leaf, and
``apply_updates`` writes the params and the optimizer state in place. The
step makes no host sync. The host loop adds fault tolerance: periodic
atomic checkpoints, resume-from-latest, and deterministic data replay.

On a mesh every rank runs the same loop on its blocks of the params and
the state (``sharding_trees``): every rank draws the same
``batch_for_step`` and ``lm.train_loss`` keeps its rows; the gradients
arrive as blocks (the weight gathers' backward reduce-scatters them), and
``apply_updates`` updates the blocks. Checkpoints hold whole arrays.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from ..core.relshard import ShardingPlan
from ..models import lm
from ..models import sharding as sh
from ..models.config import ModelConfig
from . import checkpoint as ckpt_mod
from .data import DataConfig, batch_for_step
from .optimizer import (OptConfig, apply_updates, init_opt_state,
                        opt_state_specs)
from .tree import tree_leaves, tree_map, tree_unflatten


def batch_specs(plan: ShardingPlan, has_cond: bool):
    spec = {"tokens": sh.P(plan.batch_axes)}
    if has_cond:
        spec["cond_emb"] = sh.P(plan.batch_axes)
    return spec


def make_train_step(cfg: ModelConfig, plan: ShardingPlan, mesh,
                    opt_cfg: OptConfig, lt_schedule: bool = False):
    """Returns the train step. Its metrics are device tensors: the loss,
    ``train_loss``'s metrics, and the update's ``grad_norm`` and ``lr``.
    On a mesh params and state are the rank's blocks and the batch is whole
    (every rank passes the same)."""

    def train_step(params, opt_state, batch):
        work = tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = tree_leaves(work)
        with torch.enable_grad():
            loss, metrics = lm.train_loss(work, cfg, plan, mesh, batch,
                                          lt_schedule=lt_schedule)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_unflatten(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
        specs = (lm.param_specs(cfg, params, plan) if mesh is not None
                 else None)
        params, opt_state, opt_metrics = apply_updates(
            opt_cfg, params, opt_state, grads, mesh=mesh, specs=specs)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def sharding_trees(cfg: ModelConfig, plan: ShardingPlan, mesh,
                   opt_cfg: OptConfig, params_shape):
    """``NamedSharding`` trees of the params and the optimizer state, and
    the params' spec tree."""
    specs = lm.param_specs(cfg, params_shape, plan)

    def named(tree):
        return lm._map_tree(lambda s: sh.NamedSharding(mesh, s), tree)
    return named(specs), named(opt_state_specs(opt_cfg, specs)), specs


def train(cfg: ModelConfig, plan: ShardingPlan, mesh=None, *,
          steps: int, global_batch: int, seq_len: int,
          opt_cfg: Optional[OptConfig] = None, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 100, resume: bool = True, log_every: int = 10,
          seed: int = 0, device=None) -> Dict[str, Any]:
    """Host training loop (the examples, ``launch.train``). Runs on the
    CUDA card unless ``device`` names another, and raises without a card.
    The host waits for the card only on log steps and checkpoints. On a
    mesh every rank calls it; rank 0 prints."""
    opt_cfg = opt_cfg or OptConfig(name=cfg.optimizer)
    params = lm.init_params(cfg, seed, device)
    p_sh = o_sh = specs = None
    if mesh is not None:
        p_sh, o_sh, specs = sharding_trees(cfg, plan, mesh, opt_cfg, params)
        params = lm.shard_params(params, cfg, plan, mesh)
    dev = tree_leaves(params)[0].device
    opt_state = init_opt_state(opt_cfg, params)
    say = mesh is None or mesh.rank == 0
    data_cfg = DataConfig(cfg.vocab, seq_len, global_batch, seed,
                          cfg.n_cond_tokens, cfg.d_model)

    start = 0
    if ckpt_dir and resume:
        last = ckpt_mod.latest_step(ckpt_dir)
        if last is not None:
            state, _ = ckpt_mod.restore(
                ckpt_dir, last, {"params": params, "opt": opt_state},
                shardings=None if mesh is None else {"params": p_sh,
                                                     "opt": o_sh})
            params, opt_state = state["params"], state["opt"]
            start = last
            if say:
                print(f"[train] resumed from step {start}")

    step_fn = make_train_step(cfg, plan, mesh, opt_cfg)
    history = []
    t0 = time.perf_counter()
    for step in range(start, steps):
        batch = batch_for_step(data_cfg, step, dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            history.append((step, loss))
            dt = time.perf_counter() - t0
            if say:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"({dt:.1f}s)", flush=True)
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt_mod.save(ckpt_dir, step + 1,
                          {"params": params, "opt": opt_state},
                          extra={"arch": cfg.name}, mesh=mesh,
                          specs=None if mesh is None else {
                              "params": specs,
                              "opt": opt_state_specs(opt_cfg, specs)})
    return {"params": params, "opt_state": opt_state, "history": history}
