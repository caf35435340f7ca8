"""Decoder LM composer: params, forward, train loss, prefill and decode for
every family: uniform transformer blocks (DENSE, VLM, AUDIO, and MoE with
experts in place of the MLP), the hybrid of Mamba2 blocks and one shared
attention block (HYBRID, zamba2) and RWKV-6 (SSM).

Params are plain nested dicts of tensors with the JAX package's tree: the
same leaf names, shapes and dtypes, per-layer blocks stacked on a leading
layer axis (the reference scans over it; here a Python loop walks it).
``params_from_numpy`` / ``params_to_numpy`` carry a tree across from and
back to numpy, so that the reference's weights run here.

Every entry point runs on the device its tensors live on; ``init_params``
and ``init_cache`` build on the CUDA card unless the caller names another
device, and raise without a card. A device mesh waits for ``ROADMAP.md``
queue 1, item 5.
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
from ..layers import moe as moe_mod
from ..layers import rwkv as rwkv_mod
from ..layers import ssm as ssm_mod
from .config import Family, ModelConfig


def ssm_heads(cfg: ModelConfig) -> int:
    """The hybrid's SSM heads: ``ssm_heads``, or one per 64 inner channels."""
    return cfg.ssm_heads or (2 * cfg.d_model) // 64


def attn_period(cfg: ModelConfig) -> int:
    """The hybrid applies its shared attention block after every
    ``attn_period`` Mamba blocks (once per whole period)."""
    return cfg.attn_every or cfg.n_layers


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device=None
                ) -> Dict[str, Any]:
    """Random params with the reference's distributions and scales, drawn
    from one ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L = (cfg.n_layers,)
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": emb.embedding_init(gen, cfg.vocab, d, dev),
        "final_norm": cm.rmsnorm_init(d, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = emb.head_init(gen, cfg.vocab, d, dev)

    if cfg.family is Family.SSM:  # rwkv6
        params["blocks"] = {
            "tm_norm": cm.rmsnorm_init(d, dev, lead=L),
            "time_mix": rwkv_mod.rwkv_init(gen, d, cfg.rwkv_head_dim, dev,
                                           lead=L),
            "cm_norm": cm.rmsnorm_init(d, dev, lead=L),
            "channel_mix": rwkv_mod.channel_mix_init(gen, d, cfg.d_ff, dev,
                                                     lead=L),
        }
        return params

    if cfg.family is Family.HYBRID:  # zamba2
        params["blocks"] = {
            "norm": cm.rmsnorm_init(d, dev, lead=L),
            "ssm": ssm_mod.ssm_init(gen, d, cfg.ssm_state, ssm_heads(cfg),
                                    dev, lead=L),
        }
        params["shared_attn"] = {
            "attn_norm": cm.rmsnorm_init(d, dev),
            "attn": attn.attn_init(gen, d, cfg.n_heads, cfg.kv_heads, cfg.hd,
                                   dev),
            "mlp_norm": cm.rmsnorm_init(d, dev),
            "mlp": cm.mlp_init(gen, d, cfg.d_ff, dev, cfg.mlp_activation),
        }
        return params

    # dense / moe / vlm / audio: uniform transformer blocks
    blocks = {
        "attn_norm": cm.rmsnorm_init(d, dev, lead=L),
        "attn": attn.attn_init(gen, d, cfg.n_heads, cfg.kv_heads, cfg.hd,
                               dev, lead=L),
        "mlp_norm": cm.rmsnorm_init(d, dev, lead=L),
    }
    if cfg.is_moe:
        blocks["moe"] = moe_mod.moe_init(gen, d, cfg.d_ff, cfg.n_experts,
                                         dev, lead=L)
    else:
        blocks["mlp"] = cm.mlp_init(gen, d, cfg.d_ff, dev,
                                    cfg.mlp_activation, lead=L)
    params["blocks"] = blocks
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


#: Leaves the reference reads in f32 (``.astype(float32)``, or an f32
#: operand of an f32 sum): a bf16 copy of them would round their values.
F32_LEAVES = frozenset({"A_log", "dt_bias", "D", "decay_base", "bonus_u"})


def cast_params(params, device=None) -> Dict[str, Any]:
    """The weights as the forward and decode paths read them, on ``device``:
    every leaf cast to the compute dtype (bf16) but ``F32_LEAVES``, kept in
    fp32. Every use of any other weight casts it to bf16 first, so the copy
    gives the same bits as casting the fp32 tree at every use."""
    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else v.to(
            device=device,
            dtype=v.dtype if k in F32_LEAVES else cm.COMPUTE_DTYPE)
            for k, v in tree.items()}
    return cast(params)


def _layer(blocks, i: int):
    return _map_tree(lambda t: t[i], blocks)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

class ForwardAux(NamedTuple):
    moe_load: Optional[torch.Tensor]   # (L, E) int32 router counts
    moe_aux_loss: torch.Tensor         # scalar, mean over layers
    moe_dropped: torch.Tensor          # scalar, mean over layers


def _dense_block(bp, x, cfg: ModelConfig, plan, positions,
                 lt_schedule=False):
    """One uniform transformer block; returns (x, MoEAux or None)."""
    h = cm.rmsnorm(bp["attn_norm"], x, cfg.rms_eps)
    a, _kv = attn.attn_apply(
        bp["attn"], h, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
        head_dim=cfg.hd, theta=cfg.rope_theta, positions=positions,
        window=cfg.attn_window, lower_triangular_schedule=lt_schedule)
    x = x + a
    h = cm.rmsnorm(bp["mlp_norm"], x, cfg.rms_eps)
    if cfg.is_moe:
        y, aux = _moe(bp["moe"], h, cfg, plan)
        return x + y, aux
    return x + cm.mlp_apply(bp["mlp"], h, cfg.mlp_activation), None


def _moe(bp, h, cfg: ModelConfig, plan):
    return moe_mod.moe_apply(
        bp, h, mesh=None, batch_axes=plan.batch_axes,
        model_axis=plan.model_axis, n_experts=cfg.n_experts,
        top_k=cfg.top_k, strategy=plan.moe_strategy)


def _shared_attn_block(sp, x, cfg: ModelConfig, positions):
    """The hybrid's shared attention block (one set of weights)."""
    h = cm.rmsnorm(sp["attn_norm"], x, cfg.rms_eps)
    a, _ = attn.attn_apply(
        sp["attn"], h, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
        head_dim=cfg.hd, theta=cfg.rope_theta, positions=positions,
        window=cfg.attn_window)
    x = x + a
    h = cm.rmsnorm(sp["mlp_norm"], x, cfg.rms_eps)
    return x + cm.mlp_apply(sp["mlp"], h, cfg.mlp_activation)


def _rwkv_block(bp, x, cfg: ModelConfig):
    B = x.shape[0]
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    h = cm.rmsnorm(bp["tm_norm"], x, cfg.rms_eps)
    st0 = rwkv_mod.RWKVState(
        torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device),
        torch.zeros((B, cfg.d_model), dtype=cm.COMPUTE_DTYPE,
                    device=x.device))
    y, _st = rwkv_mod.rwkv_time_mix(bp["time_mix"], h, st0,
                                    head_dim=cfg.rwkv_head_dim)
    x = x + y
    h = cm.rmsnorm(bp["cm_norm"], x, cfg.rms_eps)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return x + rwkv_mod.channel_mix(bp["channel_mix"], h, h_prev)


def forward(params, cfg: ModelConfig, plan: ShardingPlan, mesh, tokens,
            cond_emb=None, lt_schedule: bool = False):
    """Full-sequence forward to final hidden states.

    tokens: (B, S_text); cond_emb: (B, n_cond, d) stub frontend output.
    Returns (hidden (B, S_total, d) bf16, ForwardAux).
    """
    cm.require_no_mesh(mesh)
    x = emb.embed_apply(params["embed"], tokens, mesh=mesh,
                        batch_axes=plan.batch_axes,
                        model_axis=plan.model_axis,
                        strategy=plan.embed_strategy)
    if cond_emb is not None:
        x = torch.cat([cond_emb.to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = ForwardAux(None, zero, zero)
    blocks = params["blocks"]

    if cfg.family is Family.SSM:
        for i in range(cfg.n_layers):
            x = _rwkv_block(_layer(blocks, i), x, cfg)

    elif cfg.family is Family.HYBRID:
        period = attn_period(cfg)
        for i in range(cfg.n_layers):
            bp = _layer(blocks, i)
            h = cm.rmsnorm(bp["norm"], x, cfg.rms_eps)
            y, _st = ssm_mod.ssm_apply(bp["ssm"], h, n_state=cfg.ssm_state,
                                       n_heads=ssm_heads(cfg))
            x = x + y
            if (i + 1) % period == 0:
                x = _shared_attn_block(params["shared_attn"], x, cfg,
                                       positions)

    else:
        auxes = []
        for i in range(cfg.n_layers):
            x, a = _dense_block(_layer(blocks, i), x, cfg, plan, positions,
                                lt_schedule)
            auxes.append(a)
        if cfg.is_moe:
            aux = ForwardAux(torch.stack([a.load for a in auxes]),
                             torch.stack([a.aux_loss for a in auxes]).mean(),
                             torch.stack([a.dropped for a in auxes]).mean())

    x = cm.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return x, aux


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
    if aux.moe_load is not None:
        metrics["moe_load"] = aux.moe_load
    return total, metrics


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Decode state for one generation session, every leaf but ``pos``
    with the batch on its axis 1: per-layer K/V of ``max_seq`` positions
    (uniform blocks), the RWKV state and token-shift inputs (SSM), or the
    SSM state, conv tail and the shared attention's K/V per application
    (HYBRID); and each row's next write position."""
    dev = resolve_device(device)

    def zeros(shape, dtype=cm.COMPUTE_DTYPE):
        return torch.zeros(shape, dtype=dtype, device=dev)
    L, d = cfg.n_layers, cfg.d_model
    pos = zeros((batch,), torch.int32)
    if cfg.family is Family.SSM:
        H, hd = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        return {"s": zeros((L, batch, H, hd, hd), torch.float32),
                "x_prev_tm": zeros((L, batch, d)),
                "x_prev_cm": zeros((L, batch, d)),
                "pos": pos}
    if cfg.family is Family.HYBRID:
        heads = ssm_heads(cfg)
        n_seg = L // attn_period(cfg)
        kv = (n_seg, batch, max_seq, cfg.kv_heads, cfg.hd)
        return {"ssm_s": zeros((L, batch, heads, 2 * d // heads,
                                cfg.ssm_state), torch.float32),
                "conv": zeros((L, batch, 2 * d, ssm_mod.CONV_K - 1)),
                "attn_k": zeros(kv), "attn_v": zeros(kv),
                "pos": pos}
    kv = (L, batch, max_seq, cfg.kv_heads, cfg.hd)
    return {"k": zeros(kv), "v": zeros(kv), "pos": pos}


def decode_step(params, cfg: ModelConfig, plan: ShardingPlan, mesh, token,
                cache, moe_aux: Optional[list] = None):
    """One serve step: token (B, 1) + cache -> (logits (B, vocab), cache).

    Like the reference's, every row advances its ``pos``, writes its K/V
    at it and steps its recurrent state. Every new K/V row and state is
    written into ``cache``'s tensors in place; the returned cache holds
    them and the advanced ``pos``. A cache whose tensors are views of rows
    of a larger cache (as the serving engine passes) updates those rows
    only. ``moe_aux``, a list, receives each MoE layer's ``MoEAux``."""
    cm.require_no_mesh(mesh)
    x = emb.embed_apply(params["embed"], token, mesh=mesh,
                        batch_axes=plan.batch_axes,
                        model_axis=plan.model_axis,
                        strategy=plan.embed_strategy)
    pos = cache["pos"]
    blocks = params["blocks"]

    if cfg.family is Family.SSM:
        for i in range(cfg.n_layers):
            bp = _layer(blocks, i)
            h = cm.rmsnorm(bp["tm_norm"], x, cfg.rms_eps)
            y, st = rwkv_mod.rwkv_decode(
                bp["time_mix"], h,
                rwkv_mod.RWKVState(cache["s"][i], cache["x_prev_tm"][i]),
                head_dim=cfg.rwkv_head_dim)
            x = x + y
            h = cm.rmsnorm(bp["cm_norm"], x, cfg.rms_eps)
            x = x + rwkv_mod.channel_mix(bp["channel_mix"], h,
                                         cache["x_prev_cm"][i][:, None, :])
            cache["s"][i].copy_(st.s)
            cache["x_prev_tm"][i].copy_(st.x_prev)
            cache["x_prev_cm"][i].copy_(h[:, 0])

    elif cfg.family is Family.HYBRID:
        period, sp = attn_period(cfg), params["shared_attn"]
        for i in range(cfg.n_layers):
            bp = _layer(blocks, i)
            h = cm.rmsnorm(bp["norm"], x, cfg.rms_eps)
            y, st = ssm_mod.ssm_decode(
                bp["ssm"], h,
                ssm_mod.SSMState(cache["ssm_s"][i], cache["conv"][i]),
                n_state=cfg.ssm_state, n_heads=ssm_heads(cfg))
            cache["ssm_s"][i].copy_(st.s)
            cache["conv"][i].copy_(st.conv)
            x = x + y
            if (i + 1) % period:
                continue
            seg = (i + 1) // period - 1
            h = cm.rmsnorm(sp["attn_norm"], x, cfg.rms_eps)
            a, _, _ = attn.attn_decode(
                sp["attn"], h, cache["attn_k"][seg], cache["attn_v"][seg],
                pos, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
                head_dim=cfg.hd, theta=cfg.rope_theta,
                window=cfg.attn_window)
            x = x + a
            h = cm.rmsnorm(sp["mlp_norm"], x, cfg.rms_eps)
            x = x + cm.mlp_apply(sp["mlp"], h, cfg.mlp_activation)

    else:
        for i in range(cfg.n_layers):
            bp = _layer(blocks, i)
            h = cm.rmsnorm(bp["attn_norm"], x, cfg.rms_eps)
            a, _, _ = attn.attn_decode(
                bp["attn"], h, cache["k"][i], cache["v"][i], pos,
                n_heads=cfg.n_heads, kv_heads=cfg.kv_heads, head_dim=cfg.hd,
                theta=cfg.rope_theta, window=cfg.attn_window)
            x = x + a
            h = cm.rmsnorm(bp["mlp_norm"], x, cfg.rms_eps)
            if cfg.is_moe:
                y, aux = _moe(bp["moe"], h, cfg, plan)
                if moe_aux is not None:
                    moe_aux.append(aux)
            else:
                y = cm.mlp_apply(bp["mlp"], h, cfg.mlp_activation)
            x = x + y

    x = cm.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    logits = emb.lm_head_logits(_head_params(params, cfg), x[:, 0:1],
                                mesh=mesh, batch_axes=plan.batch_axes,
                                model_axis=plan.model_axis,
                                strategy=plan.head_strategy)
    return logits[:, 0], dict(cache, pos=pos + 1)


def prefill(params, cfg: ModelConfig, plan: ShardingPlan, mesh, tokens,
            cond_emb=None):
    """Full-sequence prefill returning last-position logits (B, vocab)."""
    hidden, _aux = forward(params, cfg, plan, mesh, tokens, cond_emb)
    logits = emb.lm_head_logits(_head_params(params, cfg), hidden[:, -1:],
                                mesh=mesh, batch_axes=plan.batch_axes,
                                model_axis=plan.model_axis,
                                strategy=plan.head_strategy)
    return logits[:, 0]
