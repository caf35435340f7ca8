"""Mixture-of-Experts with RelJoin-planned dispatch.

MoE dispatch is a distributed join: tokens (probe side A) are matched to
experts (build side B). The reference has two physical methods, the
paper's two exchanges: ``expert_parallel`` (the shuffle-hash analogue,
experts sharded over the ``model`` mesh axis and assignments moved with an
``all_to_all`` through ``slot_scatter``'s slots) and ``replicate`` (the
broadcast-hash analogue: every device holds all experts, tokens never
move). On one device, with no mesh, the reference runs ``replicate``, and
so does the port.

On a mesh (``shard_ctx``) ``replicate`` keeps the reference's GSPMD
semantics: one capacity for the global batch, and an expert's slots go to
the earliest assignments in global token order. Each rank holds a block of
the batch rows, so it offsets its slot positions by the assignments of the
ranks before it (an all-gather of per-expert counts), and ``load``,
``aux_loss`` and ``dropped`` are the global batch's. ``expert_parallel``
is the reference's ``shard_map`` body: experts split over the model axis,
every rank routes its own tokens (the sequence split over the model axis
in train and prefill when it divides; in decode the tokens stay whole on
every rank and y is averaged over the model axis), packs them into
per-destination slots of ``max(8, int(N / p * cf))``, and two all-to-alls
carry tokens and local expert ids out; the experts group what they receive
into ``max(8, int(Nr / El * cf))`` slots each, and one all-to-all brings
the outputs back. ``load`` is summed and ``aux_loss`` and ``dropped``
averaged over the reference's axes.

The replicated path groups the token assignments by expert into
``(E, cap)`` slots with the port's ``joins.slots.slot_scatter`` (the
earliest assignments of an expert keep its ``cap`` slots, later ones are
dropped and counted), runs every expert's SwiGLU on its slots, and sums
each token's ``top_k`` weighted outputs in bf16 in the order of its
choices, as the reference's scatter-add does. The router's per-expert
counts (``MoEAux.load``) are the runtime statistic RelShard re-plans on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..joins.slots import slot_scatter
from ..models import sharding as sh
from .common import COMPUTE_DTYPE, _dense_init, silu


class MoEAux(NamedTuple):
    load: torch.Tensor       # (E,) int32 assignments routed per expert
    aux_loss: torch.Tensor   # () load-balancing loss (Switch-style)
    dropped: torch.Tensor    # () fraction of assignments dropped by capacity


def moe_init(gen: torch.Generator, d: int, ff: int, n_experts: int, device,
             lead=()):
    fan = len(lead)

    def normal(shape, scale):
        return _dense_init(gen, (*lead, *shape), device, scale=scale)
    return {
        "router": _dense_init(gen, (*lead, d, n_experts), device,
                              fan_in_dim=fan),
        "w_gate": normal((n_experts, d, ff), d ** -0.5),
        "w_up": normal((n_experts, d, ff), d ** -0.5),
        "w_down": normal((n_experts, ff, d), ff ** -0.5),
    }


def top_k_lowest_first(probs: torch.Tensor, k: int):
    """The ``k`` largest entries of each row and their indices, equal
    entries in ascending index order, as ``jax.lax.top_k`` breaks ties
    (``torch.topk`` fixes no order among equal entries)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int64 occurrences of each value of ``ids`` in [0, n), without
    the host sync ``torch.bincount`` makes on a CUDA tensor."""
    flat = ids.reshape(-1)
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def _route(params, x2d, n_experts: int, top_k: int):
    """x2d: (N, d) -> gates (N, K) f32, expert ids (N, K) int64, the
    Switch aux loss and the per-expert load (E,) int32."""
    logits = (x2d @ params["router"].to(COMPUTE_DTYPE)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k_lowest_first(probs, top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True),
                                        min=1e-9)
    # Switch-transformer load balance loss: E * sum_e f_e * p_e, with f_e
    # the share of tokens whose first choice is e.
    f = _counts(expert_ids[:, 0], n_experts).float() / expert_ids.shape[0]
    pbar = probs.mean(dim=0)
    aux = n_experts * (f * pbar).sum()
    load = _counts(expert_ids, n_experts).to(torch.int32)
    return gate_vals, expert_ids, aux, load


def _expert_ffn(w_gate, w_up, w_down, xe):
    """xe: (E, C, d) -> (E, C, d) through per-expert SwiGLU."""
    g = torch.bmm(xe, w_gate.to(COMPUTE_DTYPE))
    u = torch.bmm(xe, w_up.to(COMPUTE_DTYPE))
    return torch.bmm(silu(g) * u, w_down.to(COMPUTE_DTYPE))


def _inverse_slots(idx: torch.Tensor, n_src: int) -> torch.Tensor:
    """Given slots -> source idx (nd, cap), return source -> flat slot
    (n_src,), -1 for unplaced sources."""
    flat = idx.reshape(-1).long()
    pos = torch.arange(flat.shape[0], dtype=torch.int64, device=idx.device)
    inv = torch.full((n_src + 1,), -1, dtype=torch.int64, device=idx.device)
    # empty slots write to the spare trailing entry, sliced off
    inv[torch.where(flat >= 0, flat, n_src)] = pos
    return inv[:n_src]


def _gather0(x, idx):
    """Rows of ``x`` at ``idx`` (any shape), zero where ``idx`` < 0;
    returns (rows, mask)."""
    mask = idx >= 0
    out = x[idx.clamp(min=0).long()]
    return torch.where(mask.reshape(mask.shape + (1,) * (out.dim()
                                                         - mask.dim())),
                       out, torch.zeros((), dtype=out.dtype,
                                        device=out.device)), mask


def moe_capacity(n_assignments: int, n_experts: int,
                 capacity_factor: float = 1.5) -> int:
    """Slots an expert gets for ``n_assignments`` token choices."""
    return max(8, int(n_assignments / n_experts * capacity_factor))


def _combine(y_asn, gates, n_tok, top_k):
    """Each token's choices weighted by its gates and added one after the
    other, each sum rounded to bf16 (the reference's scatter-add)."""
    d = y_asn.shape[-1]
    y_asn = (y_asn * gates.reshape(-1)[:, None].to(COMPUTE_DTYPE)).reshape(
        n_tok, top_k, d)
    y2 = y_asn[:, 0]
    for j in range(1, top_k):
        y2 = y2 + y_asn[:, j]
    return y2


def _moe_replicated(params, x, n_experts, top_k, capacity_factor,
                    ctx=None):
    B, S, d = x.shape
    x2 = x.reshape(B * S, d).to(COMPUTE_DTYPE)
    gates, eids, aux, load = _route(params, x2, n_experts, top_k)
    N = B * S * top_k
    # a token's top_k assignments are contiguous: token t owns t*k .. t*k+k-1
    tok = torch.arange(B * S, device=x.device).repeat_interleave(top_k)
    dest = eids.reshape(-1)
    split = ctx is not None and ctx.batch
    n_all = N * (ctx.mesh.n(ctx.batch) if split else 1)
    cap = moe_capacity(n_all, n_experts, capacity_factor)
    idx = slot_scatter(dest[None], torch.ones((1, N), dtype=torch.bool,
                                              device=x.device),
                       n_experts, cap).idx[0]              # (E, cap)
    if split:
        # slots already taken by the ranks holding earlier batch rows
        counts = sh.all_gather_raw(ctx.mesh, _counts(dest, n_experts)[None],
                                   ctx.batch, 0)           # (n, E)
        before = counts[:ctx.mesh.index(ctx.batch)].sum(dim=0)
        free = torch.arange(cap, device=x.device)[None, :] < (
            cap - before)[:, None]
        idx = torch.where(free, idx, -1)
    xe, _ = _gather0(x2, torch.where(idx >= 0, tok[idx.clamp(min=0).long()],
                                     -1))                  # (E, cap, d)
    ye = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], xe)
    # combine back: expert outputs to assignments, weighted by the gates
    inv = _inverse_slots(idx, N)                           # (N,)
    y_asn, mask = _gather0(ye.reshape(-1, d), inv)         # (N, d)
    y2 = _combine(y_asn, gates, B * S, top_k)
    if not split:
        dropped = 1.0 - mask.float().mean()
        return y2.reshape(B, S, d), MoEAux(load, aux, dropped)
    mesh, ax = ctx.mesh, ctx.batch
    kept = sh.all_reduce_raw(mesh, mask.float().sum(), ax)
    dropped = 1.0 - kept / n_all
    load = sh.all_reduce_raw(mesh, load, ax)
    # the Switch loss of the global batch: E * sum_e f_e * pbar_e
    n_tok = B * S * mesh.n(ax)
    logits = (x2 @ params["router"].to(COMPUTE_DTYPE)).float()
    probs = torch.softmax(logits, dim=-1)
    f = sh.all_reduce_raw(mesh, _counts(eids[:, 0], n_experts).float(),
                          ax) / n_tok
    pbar = sh.reduce_fwd(probs.sum(dim=0), mesh, ax) / n_tok
    aux = n_experts * (f * pbar).sum()
    return y2.reshape(B, S, d), MoEAux(load, aux, dropped)


def _moe_expert_parallel_body(params_loc, x_loc, ctx, *, n_experts, top_k,
                              capacity_factor, replicated_tokens):
    """The reference's ``shard_map`` body on this rank. Expert weights are
    the rank's (El, d, ff) block, the router whole; x_loc (Bl, S, d).
    ``replicated_tokens``: every rank of the model axis holds the same
    tokens (decode), so the token-side values enter through f, whose
    backward sums the ranks' shares."""
    mesh, M = ctx.mesh, ctx.model
    p = mesh.n(M)
    El = n_experts // p
    B, S, d = x_loc.shape
    x2 = x_loc.reshape(B * S, d).to(COMPUTE_DTYPE)
    gates, eids, aux, load = _route(params_loc, x2, n_experts, top_k)
    if replicated_tokens:
        x2 = sh.reduce_bwd(x2, mesh, M)
        gates = sh.reduce_bwd(gates, mesh, M)

    N = B * S * top_k
    tok = torch.arange(B * S, device=x2.device).repeat_interleave(top_k)
    flat = eids.reshape(-1)
    dest_shard = flat // El                                # owning rank
    local_eid = flat % El                                  # expert id there
    cap = moe_capacity(N, p, capacity_factor)

    # exchange 1: tokens -> expert shards (the slotted shuffle)
    idx = slot_scatter(dest_shard[None], torch.ones((1, N), dtype=torch.bool,
                                                    device=x2.device),
                       p, cap).idx[0]                      # (p, cap)
    x_send, _ = _gather0(x2, torch.where(idx >= 0,
                                         tok[idx.clamp(min=0).long()], -1))
    e_send = torch.where(idx >= 0, local_eid[idx.clamp(min=0).long()], -1)
    x_recv = sh.all_to_all(x_send, mesh, M)                # (p, cap, d)
    e_recv = sh.all_to_all_raw(mesh, e_send, M)            # (p, cap)

    # local join: group received tokens by local expert, run the FFN
    Nr = p * cap
    e_flat = e_recv.reshape(Nr)
    cap2 = moe_capacity(Nr, El, capacity_factor)
    idx2 = slot_scatter(e_flat.clamp(min=0)[None], (e_flat >= 0)[None], El,
                        cap2).idx[0]                       # (El, cap2)
    xe, _ = _gather0(x_recv.reshape(Nr, d), idx2)          # (El, cap2, d)
    ye = _expert_ffn(params_loc["w_gate"], params_loc["w_up"],
                     params_loc["w_down"], xe)

    # reverse the local grouping, exchange back, combine
    inv2 = _inverse_slots(idx2, Nr)
    y_recv, _ = _gather0(ye.reshape(-1, d), inv2)          # (Nr, d)
    y_back = sh.all_to_all(y_recv.reshape(p, cap, d), mesh, M)
    inv1 = _inverse_slots(idx, N)
    y_asn, m1 = _gather0(y_back.reshape(p * cap, d), inv1)  # (N, d)
    y2 = _combine(y_asn, gates, B * S, top_k)
    dropped = 1.0 - (m1 & (inv1 >= 0)).float().mean()
    return y2.reshape(B, S, d), load, aux, dropped


def _whole_router(params, ctx, vary):
    """The router, which arrives split by columns over the model axis
    (``param_specs``), whole on every rank."""
    return sh.to_compute(params["router"], sh.P(None, ctx.model),
                         sh.P(None, None), ctx, vary)


def _moe_expert_parallel(params, x, ctx, n_experts, top_k, capacity_factor):
    """``moe_apply``'s expert_parallel branch: the body's inputs placed as
    the reference's ``in_specs`` place them, its outputs as its
    ``out_specs``. The block's leaves arrive with the fsdp axis gathered:
    the router split by columns, the experts by expert over the model
    axis."""
    mesh, M = ctx.mesh, ctx.model
    B, S, d = x.shape
    p = mesh.n(M)
    seq_shard = S % p == 0 and S >= p
    # the router whole on every rank; with the sequence split its
    # consumers (the rank's tokens) differ over M
    rp = _whole_router(params, ctx, ctx.vary(M) if seq_shard
                       else ctx.vary())
    experts = {n: params[n] for n in ("w_gate", "w_up", "w_down")}
    xl = sh.split(x, mesh, M, 1) if seq_shard else x
    y, load, aux, dropped = _moe_expert_parallel_body(
        {"router": rp, **experts}, xl, ctx, n_experts=n_experts,
        top_k=top_k, capacity_factor=capacity_factor,
        replicated_tokens=not seq_shard)
    # the reference's red: every axis the values vary over
    red = ctx.batch + ((M,) if seq_shard else ())
    red = tuple(a for a in mesh.axis_names if a in red)
    aux = sh.mean_fwd(aux, mesh, red)
    dropped = sh.all_reduce_raw(mesh, dropped, red) / mesh.n(red)
    load = sh.all_reduce_raw(mesh, load.float(), red)
    if seq_shard:
        y = sh.gather(y, mesh, M, 1, reduce_grad=False)
    else:
        y = sh.mean_fwd(y, mesh, M)
    return y, MoEAux(load, aux, dropped)


def moe_apply(params, x, *, mesh, batch_axes, model_axis, n_experts, top_k,
              strategy: str, capacity_factor: float = 1.5, shard_ctx=None):
    """Dispatch through the planned strategy. Returns (y, MoEAux). With no
    mesh both strategies are the replicated path, as in the reference."""
    if strategy not in ("replicate", "expert_parallel"):
        raise ValueError(f"unknown MoE strategy {strategy}")
    if shard_ctx is None or strategy == "replicate":
        if shard_ctx is not None:
            params = dict(params, router=_whole_router(params, shard_ctx,
                                                       shard_ctx.vary()))
        return _moe_replicated(params, x, n_experts, top_k, capacity_factor,
                               shard_ctx)
    return _moe_expert_parallel(params, x, shard_ctx, n_experts, top_k,
                                capacity_factor)
