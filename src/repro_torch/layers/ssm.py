"""Mamba2-style SSD block (zamba2's mixer) with the chunked-parallel form.

Recurrence (per head h, scalar decay): state (hd, n) evolves as

    S_t = a_t * S_{t-1} + dt_t * (x_t outer B_t),   y_t = S_t @ C_t + D * x_t
    a_t = exp(-softplus(dt_raw_t) * exp(A_log_h))

Train and prefill use the exact chunked form: within a chunk the scalar
decays factor into (t, s) decay matrices; across chunks one f32 state is
carried, here by a Python loop over the chunks (the reference's
``lax.scan``). Decode keeps the state and applies one step. The precisions
are the reference's: ``dt``, the decays and the state in f32, ``D`` cast
to bf16 in the chunked form and used in f32 in decode.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import COMPUTE_DTYPE, PARAM_DTYPE, _dense_init, silu


class SSMState(NamedTuple):
    s: torch.Tensor     # (B, H, hd, n) carried state, f32
    conv: torch.Tensor  # (B, H*hd, k-1) causal-conv tail (decode), bf16


CONV_K = 4


def ssm_init(gen: torch.Generator, d_model: int, n_state: int, n_heads: int,
             device, lead=()):
    d_inner = 2 * d_model
    fan = len(lead)
    return {
        # fused input projection: [z, x, B, C, dt]
        "w_in": _dense_init(gen, (*lead, d_model,
                                  2 * d_inner + 2 * n_state + n_heads),
                            device, fan_in_dim=fan),
        "w_out": _dense_init(gen, (*lead, d_inner, d_model), device,
                             fan_in_dim=fan),
        "conv_w": _dense_init(gen, (*lead, CONV_K, d_inner), device,
                              scale=CONV_K ** -0.5),
        "A_log": torch.zeros((*lead, n_heads), dtype=PARAM_DTYPE,
                             device=device),
        "D": torch.ones((*lead, n_heads), dtype=PARAM_DTYPE, device=device),
        "dt_bias": torch.full((*lead, n_heads), -2.0, dtype=PARAM_DTYPE,
                              device=device),
    }


def _split_proj(params, x, d_inner, n_state, n_heads):
    proj = x.to(COMPUTE_DTYPE) @ params["w_in"].to(COMPUTE_DTYPE)
    return torch.split(proj, [d_inner, d_inner, n_state, n_state, n_heads],
                       dim=-1)


def _causal_conv(xs, conv_w):
    """Depthwise causal conv over time, then SiLU. xs: (B, S, d_inner);
    the taps are summed in bf16 one after the other, as the reference's."""
    k, S = conv_w.shape[0], xs.shape[1]
    pad = F.pad(xs, (0, 0, k - 1, 0))
    w = conv_w.to(COMPUTE_DTYPE)
    out = pad[:, 0:S] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + S] * w[i]
    return silu(out)


def chunk_count(S: int, chunk: int) -> int:
    """The reference's chunking: ``S // chunk`` chunks of equal length (one
    chunk of all of S when S < chunk). A length that does not divide into
    them raises, where the reference's assert fails."""
    nc = max(S // chunk, 1)
    if S % (S // nc):
        raise ValueError(f"sequence length {S} does not divide into {nc} "
                         f"chunks of {S // nc}")
    return nc


def ssm_apply(params, x, *, n_state: int, n_heads: int, chunk: int = 128):
    """Full-sequence SSD. x: (B, S, d). Returns (y, final SSMState); the
    state's conv tail is the last taps after the conv and SiLU, as the
    reference returns it."""
    B, S, d = x.shape
    d_inner = 2 * d
    hd = d_inner // n_heads
    z, xs, bmat, cmat, dt_raw = _split_proj(params, x, d_inner, n_state,
                                            n_heads)
    xs = _causal_conv(xs, params["conv_w"])
    dt = F.softplus(dt_raw.float() + params["dt_bias"])     # (B,S,H)
    a_log = -dt * torch.exp(params["A_log"])                # (B,S,H) <= 0

    xh = xs.reshape(B, S, n_heads, hd)
    u = xh * dt[..., None].to(COMPUTE_DTYPE)               # dt-scaled input

    nc = chunk_count(S, chunk)
    c = S // nc
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    s = torch.zeros((B, n_heads, hd, n_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        uc = u[:, sl].float()                              # (B,c,H,hd)
        bc = bmat[:, sl].float()                           # (B,c,n)
        cc = cmat[:, sl].float()                           # (B,c,n)
        cum = torch.cumsum(a_log[:, sl], dim=1)            # (B,c,H) inclusive
        total = cum[:, -1]                                 # (B,H)
        # inter-chunk: y_inter[t] = exp(cum_t) * (S_prev @ C_t)
        sc = torch.einsum("bhdn,bcn->bchd", s, cc)
        y_inter = torch.exp(cum)[..., None] * sc
        # intra-chunk: pairwise decays exp(cum_t - cum_s) for s <= t; above
        # the diagonal exp overflows to inf, which where() drops (a 0/1
        # multiply would leave inf * 0 = NaN)
        dec = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])  # (B,t,s,H)
        dec = torch.where(tril[None, :, :, None], dec, 0.0)
        kv = torch.einsum("bsn,btn->bst", bc, cc)          # (B,s,t)
        w = dec * kv.transpose(1, 2)[..., None]            # (B,t,s,H)
        y_intra = torch.einsum("btsh,bshd->bthd", w, uc)
        # state to the chunk's end
        decay_to_end = torch.exp(total[:, None, :] - cum)  # (B,c,H)
        su = torch.einsum("bshd,bsn,bsh->bhdn", uc, bc, decay_to_end)
        s = torch.exp(total)[..., None, None] * s + su
        ys.append((y_inter + y_intra).to(COMPUTE_DTYPE))
    y = torch.cat(ys, dim=1)                               # (B,S,H,hd)
    y = y + params["D"].to(COMPUTE_DTYPE)[None, None, :, None] * xh
    y = y.reshape(B, S, d_inner) * silu(z)
    out = y @ params["w_out"].to(COMPUTE_DTYPE)
    conv_tail = xs[:, -(CONV_K - 1):, :].transpose(1, 2)
    return out, SSMState(s, conv_tail)


def ssm_decode(params, x, state: SSMState, *, n_state: int, n_heads: int):
    """One-token step. x: (B, 1, d). Returns (y, new state); the state is
    new tensors, the caller's is not written."""
    B, _, d = x.shape
    d_inner = 2 * d
    hd = d_inner // n_heads
    z, xs, bmat, cmat, dt_raw = _split_proj(params, x, d_inner, n_state,
                                            n_heads)
    # causal conv with the carried tail (raw inputs, before the conv)
    hist = torch.cat([state.conv, xs.transpose(1, 2)], dim=-1)
    w = params["conv_w"].to(COMPUTE_DTYPE)                 # (K, d_inner)
    conv_out = torch.einsum("bdk,kd->bd", hist[:, :, -CONV_K:], w)
    xs1 = silu(conv_out)[:, None, :]
    new_tail = hist[:, :, -(CONV_K - 1):]

    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])   # (B,H)
    a = torch.exp(-dt * torch.exp(params["A_log"]))              # (B,H)
    xh = xs1.reshape(B, n_heads, hd)
    u = xh.float() * dt[..., None]
    outer = torch.einsum("bhd,bn->bhdn", u, bmat[:, 0].float())
    s_new = a[..., None, None] * state.s + outer
    y = torch.einsum("bhdn,bn->bhd", s_new, cmat[:, 0].float())
    y = y + params["D"].float()[None, :, None] * xh.float()
    y = y.reshape(B, 1, d_inner).to(COMPUTE_DTYPE) * silu(z)
    out = y @ params["w_out"].to(COMPUTE_DTYPE)
    return out, SSMState(s_new, new_tail)
