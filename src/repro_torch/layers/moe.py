"""Mixture-of-Experts with RelJoin-planned dispatch.

MoE dispatch is a distributed join: tokens (probe side A) are matched to
experts (build side B). The reference has two physical methods, the
paper's two exchanges: ``expert_parallel`` (the shuffle-hash analogue,
experts sharded over the ``model`` mesh axis and assignments moved with an
``all_to_all`` through ``slot_scatter``'s slots) and ``replicate`` (the
broadcast-hash analogue: every device holds all experts, tokens never
move). On one device, with no mesh, the reference runs ``replicate``, and
so does the port; a mesh waits for ``ROADMAP.md`` queue 1, item 5.

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
from .common import COMPUTE_DTYPE, _dense_init, require_no_mesh, silu


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


def _moe_replicated(params, x, n_experts, top_k, capacity_factor):
    B, S, d = x.shape
    x2 = x.reshape(B * S, d).to(COMPUTE_DTYPE)
    gates, eids, aux, load = _route(params, x2, n_experts, top_k)
    N = B * S * top_k
    # a token's top_k assignments are contiguous: token t owns t*k .. t*k+k-1
    tok = torch.arange(B * S, device=x.device).repeat_interleave(top_k)
    dest = eids.reshape(-1)
    cap = moe_capacity(N, n_experts, capacity_factor)
    idx = slot_scatter(dest[None], torch.ones((1, N), dtype=torch.bool,
                                              device=x.device),
                       n_experts, cap).idx[0]              # (E, cap)
    xe, _ = _gather0(x2, torch.where(idx >= 0, tok[idx.clamp(min=0).long()],
                                     -1))                  # (E, cap, d)
    ye = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], xe)
    # combine back: expert outputs to assignments, weighted by the gates
    inv = _inverse_slots(idx, N)                           # (N,)
    y_asn, mask = _gather0(ye.reshape(-1, d), inv)         # (N, d)
    y_asn = (y_asn * gates.reshape(-1)[:, None].to(COMPUTE_DTYPE)).reshape(
        B * S, top_k, d)
    # the reference's zeros(bf16).at[tok].add: each token's choices added
    # one after the other, each sum rounded to bf16
    y2 = y_asn[:, 0]
    for j in range(1, top_k):
        y2 = y2 + y_asn[:, j]
    dropped = 1.0 - mask.float().mean()
    return y2.reshape(B, S, d), MoEAux(load, aux, dropped)


def moe_apply(params, x, *, mesh, batch_axes, model_axis, n_experts, top_k,
              strategy: str, capacity_factor: float = 1.5):
    """Dispatch through the planned strategy. Returns (y, MoEAux). With no
    mesh both strategies are the replicated path, as in the reference."""
    require_no_mesh(mesh)
    return _moe_replicated(params, x, n_experts, top_k, capacity_factor)
