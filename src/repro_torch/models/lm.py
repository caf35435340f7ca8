"""Decoder LM composer: params, forward, train loss, prefill and decode for
the families built from uniform transformer blocks (DENSE, VLM, AUDIO).

Params are plain nested dicts of tensors with the JAX package's tree: the
same leaf names, shapes and dtypes, per-layer blocks stacked on a leading
layer axis (the reference scans over it; here a Python loop walks it).
``params_from_numpy`` / ``params_to_numpy`` carry a tree across from and
back to numpy, so that the reference's weights run here.

Every entry point runs on the device its tensors live on; ``init_params``
and ``init_cache`` build on the CUDA card unless the caller names another
device, and raise without a card. The MoE, HYBRID and SSM families wait for
``ROADMAP.md`` queue 1, item 3, and a device mesh for item 5.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..core.relshard import ShardingPlan
from ..joins.table import resolve_device
from ..layers import attention as attn
from ..layers import common as cm
from ..layers import embedding as emb
from .config import Family, ModelConfig

#: the families whose blocks are uniform transformer blocks
PORTED_FAMILIES = (Family.DENSE, Family.VLM, Family.AUDIO)


def _require_ported(cfg: ModelConfig, mesh=None) -> None:
    if cfg.family not in PORTED_FAMILIES or cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family.value}) is not ported yet: the MoE, "
            "HYBRID and SSM families are ROADMAP.md queue 1, item 3 "
            "(LM slice 2)")
    cm.require_no_mesh(mesh)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device=None
                ) -> Dict[str, Any]:
    """Random params with the reference's distributions and scales, drawn
    from one ``torch.Generator`` seeded with ``seed`` on ``device``."""
    _require_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L = (cfg.n_layers,)
    params: Dict[str, Any] = {
        "embed": emb.embedding_init(gen, cfg.vocab, cfg.d_model, dev),
        "final_norm": cm.rmsnorm_init(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = emb.head_init(gen, cfg.vocab, cfg.d_model, dev)
    params["blocks"] = {
        "attn_norm": cm.rmsnorm_init(cfg.d_model, dev, lead=L),
        "attn": attn.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.kv_heads,
                               cfg.hd, dev, lead=L),
        "mlp_norm": cm.rmsnorm_init(cfg.d_model, dev, lead=L),
        "mlp": cm.mlp_init(gen, cfg.d_model, cfg.d_ff, dev,
                           cfg.mlp_activation, lead=L),
    }
    return params


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree, device) -> Dict[str, Any]:
    """A params tree of numpy arrays (e.g. the reference's ``init_params``
    leaves through ``np.asarray``) as tensors on ``device``."""
    dev = torch.device(device)
    return _map_tree(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def params_to_numpy(params) -> Dict[str, Any]:
    """The same tree with every leaf a numpy array on the host."""
    return _map_tree(lambda t: t.detach().cpu().numpy(), params)


def cast_params(params, device=None) -> Dict[str, Any]:
    """Every leaf cast to the compute dtype (bf16), on ``device``. Every use
    of a weight casts it to bf16 first, so a resident copy gives the bits of
    the reference's cast at every use."""
    return _map_tree(lambda t: t.to(device=device, dtype=cm.COMPUTE_DTYPE),
                     params)


def _layer(blocks, i: int):
    return _map_tree(lambda t: t[i], blocks)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

class ForwardAux(NamedTuple):
    moe_load: Optional[torch.Tensor]   # (L, E) router counts (runtime stats)
    moe_aux_loss: torch.Tensor         # scalar
    moe_dropped: torch.Tensor          # scalar


def _dense_block(bp, x, cfg: ModelConfig, positions, lt_schedule=False):
    h = cm.rmsnorm(bp["attn_norm"], x, cfg.rms_eps)
    a, _kv = attn.attn_apply(
        bp["attn"], h, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
        head_dim=cfg.hd, theta=cfg.rope_theta, positions=positions,
        window=cfg.attn_window, lower_triangular_schedule=lt_schedule)
    x = x + a
    h = cm.rmsnorm(bp["mlp_norm"], x, cfg.rms_eps)
    return x + cm.mlp_apply(bp["mlp"], h, cfg.mlp_activation)


def forward(params, cfg: ModelConfig, plan: ShardingPlan, mesh, tokens,
            cond_emb=None, lt_schedule: bool = False):
    """Full-sequence forward to final hidden states.

    tokens: (B, S_text); cond_emb: (B, n_cond, d) stub frontend output.
    Returns (hidden (B, S_total, d) bf16, ForwardAux).
    """
    _require_ported(cfg, mesh)
    x = emb.embed_apply(params["embed"], tokens, mesh=mesh,
                        batch_axes=plan.batch_axes,
                        model_axis=plan.model_axis,
                        strategy=plan.embed_strategy)
    if cond_emb is not None:
        x = torch.cat([cond_emb.to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    for i in range(cfg.n_layers):
        x = _dense_block(_layer(params["blocks"], i), x, cfg, positions,
                         lt_schedule)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    x = cm.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return x, ForwardAux(None, zero, zero)


def _head_params(params, cfg):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def train_loss(params, cfg: ModelConfig, plan: ShardingPlan, mesh, batch,
               moe_aux_weight: float = 0.01, lt_schedule: bool = False):
    """batch: {"tokens": (B,S), optional "cond_emb": (B,n_cond,d)}.
    Next-token CE over text positions. Returns (loss, metrics); the value
    only (the backward pass is ROADMAP.md queue 1, item 4)."""
    tokens = batch["tokens"]
    cond = batch.get("cond_emb")
    n_cond = 0 if cond is None else cond.shape[1]
    hidden, aux = forward(params, cfg, plan, mesh, tokens, cond,
                          lt_schedule=lt_schedule)
    # predict tokens[:, 1:] from hidden at absolute pos n_cond .. end-1
    h = hidden[:, n_cond:-1]
    labels = tokens[:, 1:]
    loss = emb.lm_head_loss(_head_params(params, cfg), h, labels,
                            mesh=mesh, batch_axes=plan.batch_axes,
                            model_axis=plan.model_axis,
                            strategy=plan.head_strategy)
    total = loss + moe_aux_weight * aux.moe_aux_loss
    metrics = {"ce_loss": loss, "moe_aux": aux.moe_aux_loss,
               "moe_dropped": aux.moe_dropped}
    return total, metrics


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Decode state for one generation session: per-layer K/V of
    ``max_seq`` positions for each of ``batch`` rows, and each row's next
    write position."""
    _require_ported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=cm.COMPUTE_DTYPE, device=dev),
        "v": torch.zeros(shape, dtype=cm.COMPUTE_DTYPE, device=dev),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def decode_step(params, cfg: ModelConfig, plan: ShardingPlan, mesh, token,
                cache):
    """One serve step: token (B, 1) + cache -> (logits (B, vocab), cache).

    Like the reference's, every row advances its ``pos`` and writes its
    K/V at it. The K/V are written into ``cache``'s tensors in place; the
    returned cache holds them and the advanced ``pos``. A cache whose
    tensors are views of rows of a larger cache (as the serving engine
    passes) updates those rows only."""
    _require_ported(cfg, mesh)
    x = emb.embed_apply(params["embed"], token, mesh=mesh,
                        batch_axes=plan.batch_axes,
                        model_axis=plan.model_axis,
                        strategy=plan.embed_strategy)
    pos = cache["pos"]
    for i in range(cfg.n_layers):
        bp = _layer(params["blocks"], i)
        h = cm.rmsnorm(bp["attn_norm"], x, cfg.rms_eps)
        a, _, _ = attn.attn_decode(
            bp["attn"], h, cache["k"][i], cache["v"][i], pos,
            n_heads=cfg.n_heads, kv_heads=cfg.kv_heads, head_dim=cfg.hd,
            theta=cfg.rope_theta, window=cfg.attn_window)
        x = x + a
        h = cm.rmsnorm(bp["mlp_norm"], x, cfg.rms_eps)
        x = x + cm.mlp_apply(bp["mlp"], h, cfg.mlp_activation)
    x = cm.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    logits = emb.lm_head_logits(_head_params(params, cfg), x[:, 0:1],
                                mesh=mesh, batch_axes=plan.batch_axes,
                                model_axis=plan.model_axis,
                                strategy=plan.head_strategy)
    return logits[:, 0], {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def prefill(params, cfg: ModelConfig, plan: ShardingPlan, mesh, tokens,
            cond_emb=None):
    """Full-sequence prefill returning last-position logits (B, vocab)."""
    hidden, _aux = forward(params, cfg, plan, mesh, tokens, cond_emb)
    logits = emb.lm_head_logits(_head_params(params, cfg), hidden[:, -1:],
                                mesh=mesh, batch_axes=plan.batch_axes,
                                model_axis=plan.model_axis,
                                strategy=plan.head_strategy)
    return logits[:, 0]
