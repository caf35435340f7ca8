"""RWKV-6 (Finch) block: time-mix with data-dependent per-channel decay,
and channel-mix. Attention-free; decode is O(1) in sequence length.

Recurrence per head (state S: (Dk, Dv)):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (diag(u) k_t^T v_t + S_{t-1})        (u: current-token bonus)

w_t in (0,1) per key channel is data-dependent. The full-sequence form
runs chunks of 64 one after the other, a Python loop carrying the f32
state, with a vectorized pass inside each chunk; decode carries S. The
precisions are the reference's: f32 for the decay sums and the carried
state, the decayed r and k rounded to bf16, their scores an f32 product
of the bf16 values, masked and then rounded. ``exp(-cum)`` grows along a
chunk, and the reference does not rescale it; nor does the port.

On a mesh the block runs replicated over the model axis (``lm`` gathers
its weights whole), as the reference's ``_replicate_over_model`` pins the
WKV inner; the batch rows are the rank's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .common import COMPUTE_DTYPE, PARAM_DTYPE, _dense_init, silu
from .ssm import chunk_count


class RWKVState(NamedTuple):
    s: torch.Tensor       # (B, H, Dk, Dv) f32
    x_prev: torch.Tensor  # (B, d) previous token's input (token shift)


DECAY_LORA = 64


def rwkv_init(gen: torch.Generator, d_model: int, head_dim: int, device,
              lead=()):
    n_heads = d_model // head_dim
    fan = len(lead)

    def dense(shape):
        return _dense_init(gen, (*lead, *shape), device, fan_in_dim=fan)

    def full(shape, value):
        return torch.full((*lead, *shape), value, dtype=PARAM_DTYPE,
                          device=device)
    return {
        "w_r": dense((d_model, d_model)),
        "w_k": dense((d_model, d_model)),
        "w_v": dense((d_model, d_model)),
        "w_g": dense((d_model, d_model)),
        "w_o": dense((d_model, d_model)),
        # data-dependent decay LoRA: w_t = exp(-exp(base + tanh(x A) B))
        "decay_a": dense((d_model, DECAY_LORA)),
        "decay_b": dense((DECAY_LORA, d_model)),
        "decay_base": full((d_model,), -4.0),
        "bonus_u": full((n_heads, head_dim), 0.0),
        "mix": full((5, d_model), 0.5),
    }


def _projections(params, x, x_shift):
    """Token-shift mixing, then the r/k/v/g and decay projections.

    As in the reference, the four mixed projections
    ``(m_i*x + (1-m_i)*x_shift) @ W_i`` are two products against row-scaled
    concatenated weights, one for each input stream."""
    d = x.shape[-1]
    mix = params["mix"].to(COMPUTE_DTYPE)              # (5, d)
    ws = [params[n].to(COMPUTE_DTYPE) for n in ("w_r", "w_k", "w_v", "w_g")]
    w_x = torch.cat([mix[i][:, None] * w for i, w in enumerate(ws)], dim=1)
    w_s = torch.cat([(1 - mix[i])[:, None] * w for i, w in enumerate(ws)],
                    dim=1)
    proj = x @ w_x + x_shift @ w_s                     # (..., 4d)
    r, k, v, g = torch.split(proj, d, dim=-1)
    x5 = x * mix[4] + x_shift * (1 - mix[4])
    lora = torch.tanh(x5 @ params["decay_a"].to(COMPUTE_DTYPE)) \
        @ params["decay_b"].to(COMPUTE_DTYPE)
    log_w = -torch.exp(params["decay_base"].float() + lora.float())
    return r, k, v, g, log_w                           # log_w < 0, f32


def _heads(t, n_heads, hd):
    return t.reshape(t.shape[:-1] + (n_heads, hd))


def rwkv_time_mix(params, x, state: RWKVState, *, head_dim: int,
                  chunk: int = 64, shard_ctx=None):
    """Full-sequence time-mix. x: (B, S, d) bf16. Returns (y, new state).
    On a mesh the block runs replicated over the model axis, on the rank's
    batch rows, with its weights whole (``lm`` gathers them): the
    reference's ``_replicate_over_model`` for the whole block, so nothing
    here moves between ranks and ``shard_ctx`` is not read."""
    B, S, d = x.shape
    H, hd = d // head_dim, head_dim
    x_shift = torch.cat([state.x_prev[:, None, :].to(x.dtype), x[:, :-1]],
                        dim=1)
    r, k, v, g, log_w = _projections(params, x, x_shift)
    r, k, v, log_w = (_heads(t, H, hd) for t in (r, k, v, log_w))
    u = params["bonus_u"].float()                      # (H, K)

    nc = chunk_count(S, chunk)
    c = S // nc
    strict = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=x.device), diagonal=-1)  # s < t
    s = state.s
    ys = []
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        rc, kc, vc, lwc = r[:, sl], k[:, sl], v[:, sl], log_w[:, sl]
        cum = torch.cumsum(lwc, dim=1)                 # inclusive, f32
        cum_excl = cum - lwc
        # inter: y_t += r_t diag(exp(cum_excl_t)) S_prev
        r_dec = (rc.float() * torch.exp(cum_excl)).to(COMPUTE_DTYPE)
        y_inter = torch.einsum("bthk,bhkv->bthv", r_dec,
                               s.to(COMPUTE_DTYPE))
        # intra (s < t): r_t [prod w] k_s^T v_s; the scores are an f32
        # product of the bf16 values, whose products f32 holds exactly
        k_dec = (kc.float() * torch.exp(-cum)).to(COMPUTE_DTYPE)
        att = torch.einsum("bthk,bshk->bhts", r_dec.float(), k_dec.float())
        att = torch.where(strict, att, 0.0).to(COMPUTE_DTYPE)
        y_intra = torch.einsum("bhts,bshv->bthv", att, vc)
        # current-token bonus: r_t diag(u) k_t^T v_t
        bonus = torch.einsum("bthk,hk,bthk->bth", rc.float(), u, kc.float())
        y_cur = bonus[..., None].to(COMPUTE_DTYPE) * vc
        # state to the chunk's end (f32)
        dec_end = torch.exp(cum[:, -1:] - cum)         # (B,c,H,K)
        s = torch.exp(cum[:, -1])[..., None] * s + torch.einsum(
            "bshk,bshv->bhkv", kc.float() * dec_end, vc.float())
        ys.append((y_inter + y_intra + y_cur).to(COMPUTE_DTYPE))
    y = torch.cat(ys, dim=1).reshape(B, S, d)
    y = y * silu(g)
    out = y @ params["w_o"].to(COMPUTE_DTYPE)
    return out, RWKVState(s, x[:, -1, :])


def rwkv_decode(params, x, state: RWKVState, *, head_dim: int):
    """One-token step. x: (B, 1, d). Returns (y, new state); the state is
    new tensors, the caller's is not written."""
    B, _, d = x.shape
    H, hd = d // head_dim, head_dim
    r, k, v, g, log_w = _projections(params, x[:, 0],
                                     state.x_prev.to(x.dtype))
    r, k, v, log_w = (_heads(t, H, hd) for t in (r, k, v, log_w))
    u = params["bonus_u"].float()
    rf, kf, vf = r.float(), k.float(), v.float()
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    y = torch.einsum("bhk,bhkv->bhv", rf,
                     state.s + u[None, :, :, None] * kv)
    s_new = torch.exp(log_w)[..., None] * state.s + kv
    y = y.reshape(B, 1, d).to(COMPUTE_DTYPE) * silu(g)[:, None, :]
    out = y @ params["w_o"].to(COMPUTE_DTYPE)
    return out, RWKVState(s_new, x[:, 0])


# channel-mix (the RWKV "MLP")

def channel_mix_init(gen: torch.Generator, d: int, ff: int, device,
                     lead=()):
    fan = len(lead)
    return {"w_kc": _dense_init(gen, (*lead, d, ff), device, fan_in_dim=fan),
            "w_vc": _dense_init(gen, (*lead, ff, d), device, fan_in_dim=fan),
            "mix_c": torch.full((*lead, d), 0.5, dtype=PARAM_DTYPE,
                                device=device)}


def channel_mix(params, x, x_prev):
    """x: (B,S,d); x_prev: the previous token's x, shifted."""
    m = params["mix_c"].to(COMPUTE_DTYPE)
    xm = x * m + x_prev * (1 - m)
    h = torch.square(torch.relu(xm @ params["w_kc"].to(COMPUTE_DTYPE)))
    return h @ params["w_vc"].to(COMPUTE_DTYPE)
