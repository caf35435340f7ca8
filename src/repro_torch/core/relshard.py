"""RelShard: the paper's relative-cost selection applied to sharded-LM ops.

Every "join-like" tensor op — embedding lookup, LM head, MoE dispatch —
faces the paper's §3.6.2 decision: *broadcast* the small table across the
model axis, or *shuffle* activations between shards. We evaluate the very
same cost equations (Eqs. 4/10, threshold Eq. 13) with:

    |A| = bytes of the activations that the shuffle-analogue would move
    |B| = bytes of the weight table the broadcast-analogue would replicate
    p   = model-axis size (the join parallelism)
    w   = network-vs-compute weight, derived from the card's constants
          (device-memory rate / interconnect rate) instead of the paper's
          GbE testbed value of 1 — recorded per decision.

Training amortizes nothing: the broadcast-analogue re-gathers the table
every step (FSDP), so the paper's equations apply verbatim. Serving keeps
weights resident, so the broadcast term amortizes to ~0 and the decision
degenerates to Algorithm 1's memory-feasibility gate ("hashing allowed"),
which we mirror with an HBM budget check. The chip constants are
arguments (``w``, ``hbm_bytes``); their defaults are one NVIDIA H100's.

The planner also fixes the generic mesh rules (batch/fsdp/tensor axes) that
the model builders consume.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..models.config import Family, ModelConfig, ShapeConfig
from .cost_model import (CostParams, broadcast_hash_cost, k0_threshold,
                         shuffle_hash_cost)

# One NVIDIA H100 SXM (NVIDIA's data sheet): 3.35 TB/s HBM3, 900 GB/s
# NVLink to the other cards of the host, 80 GB of HBM.
HBM_GBPS = 3350.0
NVLINK_GBPS = 900.0
W_DEFAULT = HBM_GBPS / NVLINK_GBPS         # ~3.72
HBM_BYTES = 80 * 10 ** 9

ACT_BYTES = 2   # bf16 activations
PARAM_BYTES = 4  # fp32 params


@dataclasses.dataclass(frozen=True)
class OpDecision:
    """Audit record of one planned op (the RelShard analogue of a paper
    join-method selection)."""

    op: str
    strategy: str
    size_a: float     # activation bytes (shuffle side)
    size_b: float     # table bytes (broadcast side)
    k: float
    k0: float
    cost_broadcast: float
    cost_shuffle: float
    reason: str


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Everything the model builders need to place tensors on the mesh."""

    batch_axes: Tuple[str, ...]        # e.g. ("pod", "data")
    model_axis: str                    # "model"
    fsdp_axes: Tuple[str, ...]         # param sharding over data axes
    embed_strategy: str                # replicate | vocab_parallel
    head_strategy: str
    moe_strategy: str                  # replicate | expert_parallel
    w: float
    #: per-block weights: 'tensor_parallel' (shuffle activations between
    #: shards — Megatron TP) or 'replicated' (broadcast/gather weights —
    #: pure FSDP/ZeRO; batch spreads over the model axis too). The same
    #: Eq.13 decision as every other op: A = per-layer activation traffic
    #: TP would move, B = per-layer weights FSDP would gather.
    tp: str = "tensor_parallel"
    decisions: Tuple[OpDecision, ...] = ()
    #: the device memory the decode-time gates budget against
    hbm_bytes: float = HBM_BYTES

    def explain(self) -> str:
        lines = [f"RelShard plan (w={self.w:.2f}):"]
        for d in self.decisions:
            lines.append(
                f"  {d.op:12s} -> {d.strategy:16s} k={d.k:10.2f} "
                f"k0={d.k0:7.2f} C_bcast={d.cost_broadcast:.3e} "
                f"C_shuf={d.cost_shuffle:.3e} ({d.reason})")
        return "\n".join(lines)


def _decide(op: str, size_a: float, size_b: float, p: int, w: float,
            kind: str, broadcast_name: str, shuffle_name: str,
            resident_bytes_budget: float) -> OpDecision:
    """One Eq.13 decision. For decode (resident weights) the broadcast term
    amortizes away and a memory gate decides (Algorithm 1's feasibility)."""
    params = CostParams(p=p, w=w)
    k = size_a / max(size_b, 1.0)
    k0 = k0_threshold(params)
    cb = broadcast_hash_cost(size_a, size_b, params)
    cs = shuffle_hash_cost(size_a, size_b, params)
    if kind == "decode":
        per_device = size_b  # full table resident on every device
        if per_device <= resident_bytes_budget:
            return OpDecision(op, broadcast_name, size_a, size_b, k, k0, cb,
                              cs, "decode: table fits resident HBM budget")
        return OpDecision(op, shuffle_name, size_a, size_b, k, k0, cb, cs,
                          "decode: table exceeds resident budget")
    if k > k0:
        return OpDecision(op, broadcast_name, size_a, size_b, k, k0, cb, cs,
                          f"k > k0 (Eq.13): C_bcast {cb:.3e} < {cs:.3e}")
    return OpDecision(op, shuffle_name, size_a, size_b, k, k0, cb, cs,
                      f"k <= k0 (Eq.13): C_shuf {cs:.3e} <= {cb:.3e}")


def plan_model(cfg: ModelConfig, mesh_axes: Tuple[Tuple[str, int], ...],
               shape: ShapeConfig, w: Optional[float] = None,
               fsdp: bool = True, hbm_bytes: float = HBM_BYTES
               ) -> ShardingPlan:
    """Derive the sharding plan for (architecture x input shape x mesh).

    ``mesh_axes``: ((name, size), ...) e.g. (("data", 16), ("model", 16)).
    ``w`` defaults to ``W_DEFAULT``; ``hbm_bytes`` is one device's memory,
    of which a vocab table may take a quarter and one layer's experts half
    while decoding.
    """
    w = W_DEFAULT if w is None else w
    names = [n for n, _ in mesh_axes]
    sizes = dict(mesh_axes)
    model_axis = "model"
    batch_axes = tuple(n for n in names if n != model_axis)
    p = sizes[model_axis]
    d = cfg.d_model

    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    decisions: List[OpDecision] = []

    # Embedding lookup: A = token activations, B = vocab table.
    size_a = tokens * d * ACT_BYTES
    size_b = cfg.vocab * d * PARAM_BYTES
    emb = _decide("embedding", size_a, size_b, p, w, shape.kind,
                  "replicate", "vocab_parallel", hbm_bytes / 4)
    decisions.append(emb)

    # LM head: A = activations + logit reductions, B = head table.
    head = _decide("lm_head", size_a, size_b, p, w, shape.kind,
                   "replicate", "vocab_parallel", hbm_bytes / 4)
    decisions.append(head)

    # MoE dispatch: A = routed token activations (top_k copies), B = expert
    # weights of one layer.
    moe_strategy = "expert_parallel"
    if cfg.is_moe:
        size_a = tokens * cfg.top_k * d * ACT_BYTES
        size_b = cfg.n_experts * 3 * d * cfg.d_ff * PARAM_BYTES
        moe = _decide("moe_dispatch", size_a, size_b, p, w, shape.kind,
                      "replicate", "expert_parallel",
                      resident_bytes_budget=hbm_bytes / 2)
        decisions.append(moe)
        moe_strategy = moe.strategy

    # Block weights: TP (shuffle activations) vs pure FSDP (broadcast
    # weights). |A| ~ the ~6 full-width activation passes TP's forward/
    # backward all-reduces move per layer; |B| = one layer's weights in
    # bf16. Gated to the attention-free family on train shapes (where the
    # decision is measurable and batch=256 divides the full mesh).
    tp = "tensor_parallel"
    if cfg.family is Family.SSM and shape.kind == "train":
        n_layers = max(cfg.n_layers, 1)
        blk_bytes = (cfg.param_count() - 2 * cfg.vocab * cfg.d_model) \
            / n_layers * 2.0
        act_bytes = 6.0 * tokens * d * ACT_BYTES
        tp_dec = _decide("block_tp", act_bytes, blk_bytes, p, w, shape.kind,
                         "replicated", "tensor_parallel", hbm_bytes / 4)
        decisions.append(tp_dec)
        tp = tp_dec.strategy
    emb_strategy = emb.strategy
    head_strategy = head.strategy
    if tp == "replicated":
        # batch spans the model axis too; vocab-parallel's psum-over-model
        # lookup assumes model-replicated ids, so tables fall back to the
        # broadcast strategy (they are FSDP-gathered like block weights).
        batch_axes = batch_axes + (model_axis,)
        emb_strategy = "replicate"
        head_strategy = "replicate"

    return ShardingPlan(
        batch_axes=batch_axes,
        model_axis=model_axis,
        fsdp_axes=tuple(a for a in batch_axes if a == "data") if fsdp
        else (),
        embed_strategy=emb_strategy,
        head_strategy=head_strategy,
        moe_strategy=moe_strategy,
        w=w,
        hbm_bytes=hbm_bytes,
        tp=tp,
        decisions=tuple(decisions),
    )


def replan(plan: ShardingPlan, cfg: ModelConfig,
           mesh_axes: Tuple[Tuple[str, int], ...], shape: ShapeConfig,
           measured_tokens: int, hbm_bytes: Optional[float] = None
           ) -> ShardingPlan:
    """Stage-boundary re-optimization (paper §4.1): adapt the plan to the
    *measured* token throughput (e.g. serving batch occupancy). Returns a
    possibly different plan; the caller recompiles when it changed.
    ``hbm_bytes`` defaults to the budget ``plan`` was made with."""
    scaled = dataclasses.replace(shape,
                                 global_batch=max(measured_tokens, 1),
                                 seq_len=1 if shape.kind == "decode"
                                 else shape.seq_len)
    return plan_model(cfg, mesh_axes, scaled, w=plan.w,
                      fsdp=bool(plan.fsdp_axes),
                      hbm_bytes=plan.hbm_bytes if hbm_bytes is None
                      else hbm_bytes)
