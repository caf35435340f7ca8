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
device, and raise without a card.

With a mesh (``models.sharding.Mesh`` over the caller's process group)
every rank runs the same program on its blocks (SPMD). Params are the
rank's blocks under ``param_specs`` (``params_from_numpy(..., mesh=)``,
``shard_params``); token ids and ``cond_emb`` are passed whole on every
rank and each rank keeps its rows (``launch.specs.batch_pspec``); the
outputs are the rank's blocks (hidden states and logits: its rows,
vocab-split logits under ``vocab_parallel``), losses and metrics whole.
A decode cache is the rank's block under ``cache_pspec``
(``init_cache(..., mesh=, plan=)``). Each block's weights are cast to bf16
and gathered to their compute placement inside the (rematerialized) block
(``_gather_weights``): the fsdp axis always, the model axis too for
``tp == "replicated"`` and for the RWKV and Mamba blocks, which run
replicated over it. Attention, the MLPs, the embedding, the head and the
MoE place what they move themselves (``layers/``).

Training differentiates ``train_loss`` with autograd. ``forward``
rematerializes every block as the reference's ``_remat`` does, following
``cfg.remat_policy``, whenever gradients are being recorded; prefill,
decode and the engine never record any and run the blocks as they are.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.relshard import ShardingPlan
from ..joins.table import resolve_device
from ..layers import attention as attn
from ..layers import common as cm
from ..layers import embedding as emb
from ..layers import moe as moe_mod
from ..layers import rwkv as rwkv_mod
from ..layers import ssm as ssm_mod
from . import sharding as sh
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
    # meta tensors (shapes only, ``launch.specs``) draw from no generator
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
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


def params_from_numpy(tree, device, mesh=None, specs=None
                      ) -> Dict[str, Any]:
    """A params tree of numpy arrays (e.g. the reference's ``init_params``
    leaves through ``np.asarray``) as tensors on ``device``. With a mesh,
    each rank keeps its block of every leaf under ``specs`` (a
    ``param_specs`` tree): the same bits as the whole tree's."""
    dev = torch.device(device)
    if mesh is None:
        return _map_tree(
            lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)
    return sh.map_specs(
        lambda a, spec: sh.shard(torch.from_numpy(np.asarray(a)), spec,
                                 mesh).to(dev), tree, specs)


def shard_params(params, cfg: ModelConfig, plan: ShardingPlan, mesh):
    """This rank's blocks of a whole params tree under ``param_specs``."""
    return sh.shard_tree(params, param_specs(cfg, params, plan), mesh)


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
    gives the same bits as casting the fp32 tree at every use. The copy is
    detached: built from params that require grad, it records no graph."""
    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else v.detach().to(
            device=device,
            dtype=v.dtype if k in F32_LEAVES else cm.COMPUTE_DTYPE)
            for k, v in tree.items()}
    return cast(params)


def _layer(blocks, i: int):
    return _map_tree(lambda t: t[i], blocks)


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------

#: leaf names of 2-D weight matrices split by columns / by rows.
_COL_SHARDED = {"w_q", "w_k", "w_v", "w_gate", "w_up", "w_in", "w_r", "w_g",
                "w_kc", "decay_a", "router"}
_ROW_SHARDED = {"w_o", "w_down", "w_out", "w_vc", "decay_b"}


def _map_paths(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


def param_specs(cfg: ModelConfig, params, plan: ShardingPlan):
    """The reference's ``param_specs``: a ``P`` tree congruent with
    ``params`` (any tree of leaves with a ``shape``), from leaf paths and
    the plan."""
    fsdp = plan.fsdp_axes[0] if plan.fsdp_axes else None
    model = plan.model_axis
    replicated_tp = plan.tp == "replicated"

    def spec_for(path, leaf) -> sh.P:
        name = path[-1]
        lead = (None,) if path[0] == "blocks" else ()
        nd = len(leaf.shape) - len(lead)
        if replicated_tp and path[0] not in ("embed", "head") and nd == 2 \
                and (name in _COL_SHARDED or name in _ROW_SHARDED):
            # storage spreads over fsdp x model; compute gathers both.
            return sh.P(*lead, fsdp, model)
        if path[0] in ("embed", "head"):
            strat = (plan.embed_strategy if path[0] == "embed"
                     else plan.head_strategy)
            if strat == "vocab_parallel":
                return sh.P(model, fsdp)
            return sh.P(None, fsdp)
        if name in ("w_gate", "w_up", "w_down") and nd == 3:  # MoE experts
            if plan.moe_strategy == "expert_parallel":
                return sh.P(*lead, model, fsdp, None)
            return sh.P(*lead, None, fsdp, None)
        if nd == 2:
            if name in _COL_SHARDED:
                return sh.P(*lead, fsdp, model)
            if name in _ROW_SHARDED:
                return sh.P(*lead, model, fsdp)
            return sh.P(*lead, None, None)
        if nd == 1:
            return sh.P(*lead, None)
        return sh.P(*lead, *(None,) * nd)

    return _map_paths(spec_for, params)


def _strip_fsdp(spec, fsdp_axes, strip_model: Optional[str] = None
                ) -> sh.P:
    """Compute-time placement: ``spec`` without the fsdp axes (and, for
    replicated-TP plans, the model axis)."""
    drop = set(fsdp_axes) | ({strip_model} if strip_model else set())
    out = []
    for e in spec:
        if e is None:
            out.append(None)
        elif isinstance(e, tuple):
            kept = tuple(a for a in e if a not in drop)
            out.append(kept if kept else None)
        else:
            out.append(None if e in drop else e)
    return sh.P(*out)


def block_compute_shardings(cfg: ModelConfig, params, plan: ShardingPlan,
                            mesh):
    """``NamedSharding``s of one block's params at compute time (the layer
    axis removed, fsdp stripped, and the model axis for replicated TP):
    the reference's, which ``_gather_weights`` realizes."""
    specs = param_specs(cfg, params, plan)
    strip_model = plan.model_axis if plan.tp == "replicated" else None

    def per(tree, lead):
        return _map_tree(lambda s: sh.NamedSharding(
            mesh, _strip_fsdp(sh.P(*tuple(s)[lead:]), plan.fsdp_axes,
                              strip_model)), tree)
    out = {"blocks": per(specs["blocks"], 1)}
    if "shared_attn" in specs:
        out["shared_attn"] = per(specs["shared_attn"], 0)
    return out


def shard_ctx(plan: ShardingPlan, mesh, batch: int, *,
              max_seq: Optional[int] = None, cfg: Optional[ModelConfig] = None
              ) -> Optional[sh.ShardCtx]:
    """What a sharded call on a global batch of ``batch`` rows runs with
    (None without a mesh). For decode (``max_seq`` given, and ``cfg``) it
    also reads where ``cache_pspec`` puts the KV cache's sequence and
    heads."""
    if mesh is None:
        return None
    model = plan.model_axis
    n = math.prod(mesh.shape[a] for a in plan.batch_axes)
    batch_ok = batch % n == 0
    seq, kv_model = (), False
    if max_seq is not None:
        specs = cache_specs(cfg, plan, mesh, batch, max_seq)
        kv = specs.get("k", specs.get("attn_k"))
        if kv is not None:
            seq, kv_model = sh.spec_axes(kv[2]), kv[3] == model
    return sh.ShardCtx(
        mesh=mesh, batch=tuple(plan.batch_axes) if batch_ok else (),
        model=model, fsdp=plan.fsdp_axes[0] if plan.fsdp_axes else None,
        tp=plan.tp == "tensor_parallel" and model not in plan.batch_axes,
        seq=seq, kv_model=kv_model)


def _gather_weights(bp, specs, ctx: Optional[sh.ShardCtx], plan,
                    whole: bool = False):
    """One block's weights at their compute placement, every floating leaf
    cast to bf16 first, so the all-gather moves bf16 and the backward
    reduce-scatters a bf16 gradient (the reference's ``_gather_weights``).
    ``whole`` also gathers the model axis (blocks that run replicated over
    it); a replicated-TP plan gathers it everywhere but in the MoE, whose
    layer places its experts and router itself."""
    if ctx is None:
        return bp
    strip = ctx.model if (whole or plan.tp == "replicated") else None

    def one(path, w):
        spec = _leaf(specs, path)
        compute = _strip_fsdp(spec, plan.fsdp_axes,
                              None if "moe" in path else strip)
        return sh.to_compute(w, spec, compute, ctx, ctx.vary(),
                             cast=cm.COMPUTE_DTYPE)
    return _map_paths(one, bp)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _block_specs(specs, name: str):
    """The spec tree of one layer of ``specs[name]`` (the layer axis of the
    stacked blocks removed)."""
    if name == "blocks":
        return _map_tree(lambda s: sh.P(*tuple(s)[1:]), specs[name])
    return specs[name]


def _whole(tree, specs, ctx):
    """Replicated leaves outside the blocks (the final norm) as they are,
    their gradients summed over the split batch axes."""
    if ctx is None:
        return tree
    return sh.map_specs(lambda w, s: sh.to_compute(w, s, s, ctx, ctx.vary()),
                        tree, specs)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

class ForwardAux(NamedTuple):
    moe_load: Optional[torch.Tensor]   # (L, E) int32 router counts
    moe_aux_loss: torch.Tensor         # scalar, mean over layers
    moe_dropped: torch.Tensor          # scalar, mean over layers


_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the products' outputs, recompute the rest
    (``jax.checkpoint_policies.checkpoint_dots``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _records_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_records_grad(v) for v in tree.values())
    if isinstance(tree, tuple):
        return any(_records_grad(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def _remat(fn, policy: str):
    """``fn`` rematerialized as the reference's ``_remat``: "none" keeps
    every activation, "dots" keeps the products' outputs, anything else
    ("full") keeps only the block's inputs and recomputes the block in the
    backward. Applies only while autograd records a graph through some
    input; otherwise ``fn`` runs as it is."""
    if policy == "none":
        return fn

    def run(*args):
        if not (torch.is_grad_enabled() and _records_grad(args)):
            return fn(*args)
        if policy == "dots":
            return checkpoint(
                fn, *args, use_reentrant=False,
                context_fn=lambda: create_selective_checkpoint_contexts(
                    _save_dots))
        return checkpoint(fn, *args, use_reentrant=False)
    return run


def _dense_block(bp, x, cfg: ModelConfig, plan, positions,
                 lt_schedule=False, ctx=None):
    """One uniform transformer block; returns (x, MoEAux or None)."""
    h = cm.rmsnorm(bp["attn_norm"], x, cfg.rms_eps)
    a, _kv = attn.attn_apply(
        bp["attn"], h, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
        head_dim=cfg.hd, theta=cfg.rope_theta, positions=positions,
        window=cfg.attn_window, lower_triangular_schedule=lt_schedule,
        shard_ctx=ctx)
    x = x + a
    h = cm.rmsnorm(bp["mlp_norm"], x, cfg.rms_eps)
    if cfg.is_moe:
        y, aux = _moe(bp["moe"], h, cfg, plan, ctx)
        return x + y, aux
    return x + cm.mlp_apply(bp["mlp"], h, cfg.mlp_activation,
                            shard_ctx=ctx), None


def _moe(bp, h, cfg: ModelConfig, plan, ctx=None):
    return moe_mod.moe_apply(
        bp, h, mesh=None if ctx is None else ctx.mesh,
        batch_axes=plan.batch_axes, model_axis=plan.model_axis,
        n_experts=cfg.n_experts, top_k=cfg.top_k,
        strategy=plan.moe_strategy, shard_ctx=ctx)


def _shared_attn_block(sp, x, cfg: ModelConfig, positions, ctx=None):
    """The hybrid's shared attention block (one set of weights)."""
    h = cm.rmsnorm(sp["attn_norm"], x, cfg.rms_eps)
    a, _ = attn.attn_apply(
        sp["attn"], h, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
        head_dim=cfg.hd, theta=cfg.rope_theta, positions=positions,
        window=cfg.attn_window, shard_ctx=ctx)
    x = x + a
    h = cm.rmsnorm(sp["mlp_norm"], x, cfg.rms_eps)
    return x + cm.mlp_apply(sp["mlp"], h, cfg.mlp_activation, shard_ctx=ctx)


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


def _emb_kw(plan, ctx, specs, which):
    """Keywords of the embedding / head calls; ``which`` is the params key
    whose table they read."""
    kw = dict(mesh=None if ctx is None else ctx.mesh,
              batch_axes=plan.batch_axes, model_axis=plan.model_axis)
    if ctx is not None:
        kw.update(shard_ctx=ctx, stored_spec=specs[which]["table"])
    return kw


def forward(params, cfg: ModelConfig, plan: ShardingPlan, mesh, tokens,
            cond_emb=None, lt_schedule: bool = False):
    """Full-sequence forward to final hidden states.

    tokens: (B, S_text); cond_emb: (B, n_cond, d) stub frontend output.
    Returns (hidden (B, S_total, d) bf16, ForwardAux); on a mesh, the
    rank's rows of hidden.
    """
    ctx = shard_ctx(plan, mesh, tokens.shape[0])
    specs = param_specs(cfg, params, plan) if ctx else None
    tokens = sh.rows(tokens, ctx)
    x = emb.embed_apply(params["embed"], tokens,
                        strategy=plan.embed_strategy,
                        **_emb_kw(plan, ctx, specs, "embed"))
    if cond_emb is not None:
        x = torch.cat([sh.rows(cond_emb, ctx).to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = ForwardAux(None, zero, zero)
    blocks = params["blocks"]
    policy = cfg.remat_policy
    bspecs = _block_specs(specs, "blocks") if ctx else None

    def gathered(fn, name="blocks", whole=False):
        sp = bspecs if name == "blocks" else (
            _block_specs(specs, name) if ctx else None)
        return lambda x, bp: fn(x, _gather_weights(bp, sp, ctx, plan, whole))

    if cfg.family is Family.SSM:
        body = _remat(gathered(lambda x, bp: _rwkv_block(bp, x, cfg),
                               whole=True), policy)
        for i in range(cfg.n_layers):
            x = body(x, _layer(blocks, i))

    elif cfg.family is Family.HYBRID:
        period = attn_period(cfg)

        def mamba_block(x, bp):
            h = cm.rmsnorm(bp["norm"], x, cfg.rms_eps)
            y, _st = ssm_mod.ssm_apply(bp["ssm"], h, n_state=cfg.ssm_state,
                                       n_heads=ssm_heads(cfg))
            return x + y
        body = _remat(gathered(mamba_block, whole=True), policy)
        shared = _remat(gathered(
            lambda x, sp: _shared_attn_block(sp, x, cfg, positions, ctx),
            "shared_attn"), policy)
        for i in range(cfg.n_layers):
            x = body(x, _layer(blocks, i))
            if (i + 1) % period == 0:
                x = shared(x, params["shared_attn"])

    else:
        body = _remat(gathered(lambda x, bp: _dense_block(
            bp, x, cfg, plan, positions, lt_schedule, ctx)), policy)
        auxes = []
        for i in range(cfg.n_layers):
            x, a = body(x, _layer(blocks, i))
            auxes.append(a)
        if cfg.is_moe:
            aux = ForwardAux(torch.stack([a.load for a in auxes]),
                             torch.stack([a.aux_loss for a in auxes]).mean(),
                             torch.stack([a.dropped for a in auxes]).mean())

    fn = _whole(params["final_norm"], specs and specs["final_norm"], ctx)
    x = cm.rmsnorm(fn, x, cfg.rms_eps)
    return x, aux


def _head_params(params, cfg):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def _head_key(cfg):
    return "embed" if cfg.tie_embeddings else "head"


def train_loss(params, cfg: ModelConfig, plan: ShardingPlan, mesh, batch,
               moe_aux_weight: float = 0.01, lt_schedule: bool = False):
    """batch: {"tokens": (B,S), optional "cond_emb": (B,n_cond,d)}.
    Next-token CE over text positions. Returns (loss, metrics); autograd
    differentiates it (``training.train_loop.make_train_step``). On a mesh
    the batch is whole on every rank and the loss is the global batch's."""
    tokens = batch["tokens"]
    cond = batch.get("cond_emb")
    n_cond = 0 if cond is None else cond.shape[1]
    hidden, aux = forward(params, cfg, plan, mesh, tokens, cond,
                          lt_schedule=lt_schedule)
    ctx = shard_ctx(plan, mesh, tokens.shape[0])
    specs = param_specs(cfg, params, plan) if ctx else None
    # predict tokens[:, 1:] from hidden at absolute pos n_cond .. end-1
    h = hidden[:, n_cond:-1]
    labels = sh.rows(tokens, ctx)[:, 1:]
    loss = emb.lm_head_loss(_head_params(params, cfg), h, labels,
                            strategy=plan.head_strategy,
                            **_emb_kw(plan, ctx, specs, _head_key(cfg)))
    total = loss + moe_aux_weight * aux.moe_aux_loss
    metrics = {"ce_loss": loss, "moe_aux": aux.moe_aux_loss,
               "moe_dropped": aux.moe_dropped}
    if aux.moe_load is not None:
        metrics["moe_load"] = aux.moe_load
    return total, metrics


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def cache_layout(cfg: ModelConfig, batch: int, max_seq: int):
    """{leaf name: (whole shape, dtype)} of a decode cache, every leaf but
    ``pos`` with the batch on its axis 1: per-layer K/V of ``max_seq``
    positions (uniform blocks), the RWKV state and token-shift inputs
    (SSM), or the SSM state, conv tail and the shared attention's K/V per
    application (HYBRID); and each row's next write position."""
    L, d, bf16 = cfg.n_layers, cfg.d_model, cm.COMPUTE_DTYPE
    pos = ((batch,), torch.int32)
    if cfg.family is Family.SSM:
        H, hd = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        return {"s": ((L, batch, H, hd, hd), torch.float32),
                "x_prev_tm": ((L, batch, d), bf16),
                "x_prev_cm": ((L, batch, d), bf16), "pos": pos}
    if cfg.family is Family.HYBRID:
        heads = ssm_heads(cfg)
        kv = ((L // attn_period(cfg), batch, max_seq, cfg.kv_heads, cfg.hd),
              bf16)
        return {"ssm_s": ((L, batch, heads, 2 * d // heads, cfg.ssm_state),
                          torch.float32),
                "conv": ((L, batch, 2 * d, ssm_mod.CONV_K - 1), bf16),
                "attn_k": kv, "attn_v": kv, "pos": pos}
    kv = ((L, batch, max_seq, cfg.kv_heads, cfg.hd), bf16)
    return {"k": kv, "v": kv, "pos": pos}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None,
               mesh=None, plan: Optional[ShardingPlan] = None):
    """Decode state for one generation session, zeros in
    ``cache_layout``. With a mesh (and the plan), the rank's block of each
    leaf under ``cache_pspec``."""
    dev = resolve_device(device)
    specs = (cache_specs(cfg, plan, mesh, batch, max_seq)
             if mesh is not None else None)

    def zeros(name, shape, dtype):
        if specs is not None:
            shape = tuple(n // mesh.n(e) for n, e in
                          zip(shape, tuple(specs[name]) + (None,) * 8))
        return torch.zeros(shape, dtype=dtype, device=dev)
    return {k: zeros(k, shape, dtype) for k, (shape, dtype) in
            cache_layout(cfg, batch, max_seq).items()}


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    """The whole cache's leaf shapes, by name."""
    return {k: shape for k, (shape, _) in
            cache_layout(cfg, batch, max_seq).items()}


def cache_pspec(shp, cfg: ModelConfig, plan: ShardingPlan, mesh,
                batch: int) -> sh.P:
    """A decode cache leaf's placement (the reference's
    ``launch/specs._cache_pspec``): the batch dim over the batch axes when
    the batch divides; otherwise the sequence dim of a KV cache of 1024 or
    more positions over them (sequence-sharded long-context decode). A KV
    cache's heads split over the model axis when they divide."""
    bs = math.prod(mesh.shape[a] for a in plan.batch_axes)
    model = plan.model_axis
    m = mesh.shape[model]
    if len(shp) == 1:   # pos
        return sh.P()
    batch_ok = (batch % bs == 0)
    bdim = plan.batch_axes if batch_ok else None
    if len(shp) == 5 and shp[2] >= 1024:    # (L/seg, B, S, G, hd) KV cache
        sdim = None if batch_ok else plan.batch_axes
        gdim = model if shp[3] % m == 0 else None
        return sh.P(None, bdim, sdim, gdim, None)
    if len(shp) >= 3:
        return sh.P(None, bdim, *(None,) * (len(shp) - 2))
    return sh.P(None, bdim)


def cache_specs(cfg: ModelConfig, plan: ShardingPlan, mesh, batch: int,
                max_seq: int):
    """{leaf name: P} of the decode cache (``cache_pspec``)."""
    return {k: cache_pspec(shp, cfg, plan, mesh, batch)
            for k, shp in cache_shapes(cfg, batch, max_seq).items()}


def decode_step(params, cfg: ModelConfig, plan: ShardingPlan, mesh, token,
                cache, moe_aux: Optional[list] = None, *,
                max_seq: Optional[int] = None, ctx=None):
    """One serve step: token (B, 1) + cache -> (logits (B, vocab), cache).

    Like the reference's, every row advances its ``pos``, writes its K/V
    at it and steps its recurrent state. Every new K/V row and state is
    written into ``cache``'s tensors in place; the returned cache holds
    them and the advanced ``pos``. A cache whose tensors are views of rows
    of a larger cache (as the serving engine passes) updates those rows
    only. ``moe_aux``, a list, receives each MoE layer's ``MoEAux``.

    On a mesh, ``token`` is whole on every rank and the cache is the
    rank's block (``init_cache(..., mesh=, plan=)``); the logits are the
    rank's rows (and vocab block under ``vocab_parallel``). ``max_seq``
    (the whole cache's length) places a cache whose batch does not divide
    over the batch axes; ``ctx`` (``shard_ctx``'s) overrides the placement,
    as the engine's admission of one slot does."""
    if mesh is not None and ctx is None:
        if max_seq is None:
            kv = cache.get("k", cache.get("attn_k"))
            n = math.prod(mesh.shape[a] for a in plan.batch_axes)
            if kv is not None and token.shape[0] % n:
                raise ValueError("decode on a mesh with a batch that does "
                                 "not divide over the batch axes needs "
                                 "max_seq")
            max_seq = kv.shape[2] if kv is not None else 0
        ctx = shard_ctx(plan, mesh, token.shape[0], max_seq=max_seq,
                        cfg=cfg)
    specs = param_specs(cfg, params, plan) if ctx else None
    token = sh.rows(token, ctx)
    x = emb.embed_apply(params["embed"], token,
                        strategy=plan.embed_strategy,
                        **_emb_kw(plan, ctx, specs, "embed"))
    pos_all = cache["pos"]          # whole on every rank (P())
    pos = sh.rows(pos_all, ctx)
    blocks = params["blocks"]
    bspecs = _block_specs(specs, "blocks") if ctx else None

    def layer(i, whole=False):
        return _gather_weights(_layer(blocks, i), bspecs, ctx, plan, whole)

    if cfg.family is Family.SSM:
        for i in range(cfg.n_layers):
            bp = layer(i, whole=True)
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
        period = attn_period(cfg)
        sp = _gather_weights(params["shared_attn"],
                             _block_specs(specs, "shared_attn")
                             if ctx else None, ctx, plan)
        for i in range(cfg.n_layers):
            bp = layer(i, whole=True)
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
                window=cfg.attn_window, shard_ctx=ctx)
            x = x + a
            h = cm.rmsnorm(sp["mlp_norm"], x, cfg.rms_eps)
            x = x + cm.mlp_apply(sp["mlp"], h, cfg.mlp_activation,
                                 shard_ctx=ctx)

    else:
        for i in range(cfg.n_layers):
            bp = layer(i)
            h = cm.rmsnorm(bp["attn_norm"], x, cfg.rms_eps)
            a, _, _ = attn.attn_decode(
                bp["attn"], h, cache["k"][i], cache["v"][i], pos,
                n_heads=cfg.n_heads, kv_heads=cfg.kv_heads, head_dim=cfg.hd,
                theta=cfg.rope_theta, window=cfg.attn_window,
                shard_ctx=ctx)
            x = x + a
            h = cm.rmsnorm(bp["mlp_norm"], x, cfg.rms_eps)
            if cfg.is_moe:
                y, aux = _moe(bp["moe"], h, cfg, plan, ctx)
                if moe_aux is not None:
                    moe_aux.append(aux)
            else:
                y = cm.mlp_apply(bp["mlp"], h, cfg.mlp_activation,
                                 shard_ctx=ctx)
            x = x + y

    x = cm.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    logits = emb.lm_head_logits(_head_params(params, cfg), x[:, 0:1],
                                strategy=plan.head_strategy,
                                **_emb_kw(plan, ctx, specs, _head_key(cfg)))
    return logits[:, 0], dict(cache, pos=pos_all + 1)


def prefill(params, cfg: ModelConfig, plan: ShardingPlan, mesh, tokens,
            cond_emb=None):
    """Full-sequence prefill returning last-position logits (B, vocab); on
    a mesh the rank's rows (and vocab block under ``vocab_parallel``)."""
    hidden, _aux = forward(params, cfg, plan, mesh, tokens, cond_emb)
    ctx = shard_ctx(plan, mesh, tokens.shape[0])
    specs = param_specs(cfg, params, plan) if ctx else None
    logits = emb.lm_head_logits(_head_params(params, cfg), hidden[:, -1:],
                                strategy=plan.head_strategy,
                                **_emb_kw(plan, ctx, specs, _head_key(cfg)))
    return logits[:, 0]
