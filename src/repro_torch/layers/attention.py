"""GQA attention: chunked (flash-style) causal training/prefill path and a
single-token KV-cache decode path.

The full-sequence path streams KV chunks past each query chunk with an
online softmax (running max and denominator), so the S x S score matrix
never materializes. It keeps the reference's precisions: scores in f32 from
bf16 operands, rounded to bf16 before the mask; ``p`` in bf16; the running
max, the denominator and the accumulator in f32. Products whose reference
asks for an f32 result are taken on f32 copies of the bf16 operands, whose
products are exact in f32. No fused attention call is used: the
reference's numerics are what the port is held to. Nothing here copies
from the host, so a step queues on the card without waiting for it.

Only the mesh-free path is ported; the tensor- and sequence-parallel
constraints come with ``ROADMAP.md`` queue 1, item 5.
"""

from __future__ import annotations

import torch

from .common import COMPUTE_DTYPE, _dense_init, apply_rope, require_no_mesh

NEG_INF = -1e30


def attn_init(gen: torch.Generator, d_model: int, n_heads: int,
              kv_heads: int, head_dim: int, device, lead=()):
    fan = len(lead)

    def dense(shape, scale=None):
        return _dense_init(gen, (*lead, *shape), device, scale=scale,
                           fan_in_dim=fan)
    return {
        "w_q": dense((d_model, n_heads * head_dim)),
        "w_k": dense((d_model, kv_heads * head_dim)),
        "w_v": dense((d_model, kv_heads * head_dim)),
        "w_o": dense((n_heads * head_dim, d_model),
                     scale=(n_heads * head_dim) ** -0.5),
    }


def _project_qkv(params, x, n_heads, kv_heads, head_dim, positions, theta):
    B, S, _ = x.shape
    xc = x.to(COMPUTE_DTYPE)
    q = (xc @ params["w_q"].to(COMPUTE_DTYPE)).reshape(
        B, S, n_heads, head_dim)
    k = (xc @ params["w_k"].to(COMPUTE_DTYPE)).reshape(
        B, S, kv_heads, head_dim)
    v = (xc @ params["w_v"].to(COMPUTE_DTYPE)).reshape(
        B, S, kv_heads, head_dim)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    return q, k, v


def chunked_attention(q, k, v, *, kv_heads: int, causal: bool = True,
                      q_chunk: int = 256, k_chunk: int = 512,
                      window: int = 0,
                      lower_triangular_schedule: bool = False,
                      shard_ctx=None) -> torch.Tensor:
    """Online-softmax attention. q: (B,S,H,D); k,v: (B,S,G,D). Returns
    (B,S,H,D) bf16. ``window`` > 0 limits attention to the last ``window``
    keys. ``lower_triangular_schedule`` visits only the key chunks at or
    before each query chunk (causal, ``q_chunk == k_chunk``): the skipped
    chunks are fully masked, so the result is the same."""
    require_no_mesh(None if shard_ctx is None else shard_ctx[0])
    B, S, H, D = q.shape
    G = kv_heads
    q_chunk = min(q_chunk, S)
    k_chunk = min(k_chunk, S)
    if S % q_chunk or S % k_chunk:
        raise ValueError(f"sequence length {S} does not divide into query "
                         f"chunks of {q_chunk} and key chunks of {k_chunk}")
    if G != H:
        # GQA: query head h reads KV head h // (H // G), as jnp.repeat.
        k = k.repeat_interleave(H // G, dim=2)
        v = v.repeat_interleave(H // G, dim=2)
    nq, nk = S // q_chunk, S // k_chunk
    scale = D ** -0.5
    dev = q.device
    # (B, H, S, D): f32 copies of K for the f32 scores; V stays bf16 until
    # its product, which the reference also takes to f32.
    kt = k.permute(0, 2, 3, 1).float()                 # (B, H, D, S)
    vt = v.permute(0, 2, 1, 3).float()                 # (B, H, S, D)
    qt = q.permute(0, 2, 1, 3).float()                 # (B, H, S, D)
    pos = torch.arange(S, device=dev)
    lt = lower_triangular_schedule and causal and q_chunk == k_chunk

    outs = []
    for qi in range(nq):
        q0 = qi * q_chunk
        qb = qt[:, :, q0:q0 + q_chunk]                 # (B, H, Cq, D)
        qp = pos[q0:q0 + q_chunk]
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, q_chunk, D), dtype=torch.float32,
                          device=dev)
        for kj in range(qi + 1 if lt else nk):
            k0 = kj * k_chunk
            kp = pos[k0:k0 + k_chunk]
            s = ((qb @ kt[..., k0:k0 + k_chunk]) * scale).to(COMPUTE_DTYPE)
            mask = torch.ones((q_chunk, k_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= qp[:, None] >= kp[None, :]
            if window > 0:
                mask &= kp[None, :] > qp[:, None] - window
            s = s.masked_fill(~mask, NEG_INF)      # NEG_INF rounded to bf16
            m_new = torch.maximum(m, s.amax(dim=-1).float())
            p = torch.exp(s.float() - m_new[..., None]).to(COMPUTE_DTYPE)
            corr = torch.exp(m - m_new)
            l = l * corr + p.float().sum(dim=-1)
            pv = p.float() @ vt[:, :, k0:k0 + k_chunk]
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.to(COMPUTE_DTYPE))
    # (B, H, S, D) -> (B, S, H, D)
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3).contiguous()


def attn_apply(params, x, *, n_heads, kv_heads, head_dim, theta,
               positions=None, q_chunk=256, k_chunk=512, window=0,
               lower_triangular_schedule=False, shard_ctx=None):
    """Full-sequence (train / prefill) attention, returns (y, (k, v))."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, n_heads, kv_heads, head_dim, positions,
                           theta)
    y = chunked_attention(
        q, k, v, kv_heads=kv_heads, causal=True, q_chunk=q_chunk,
        k_chunk=k_chunk, window=window,
        lower_triangular_schedule=lower_triangular_schedule,
        shard_ctx=shard_ctx)
    out = y.reshape(B, S, n_heads * head_dim) @ params["w_o"].to(
        COMPUTE_DTYPE)
    return out, (k, v)


def attn_decode(params, x, cache_k, cache_v, pos, *, n_heads, kv_heads,
                head_dim, theta, window=0):
    """One-token decode. x: (B,1,d); cache: (B,Smax,G,D); pos: (B,) current
    write position. Writes the new K/V into ``cache_k``/``cache_v`` in
    place at ``pos`` (a row whose ``pos`` is past the cache keeps its cache
    unchanged, as the reference's one-hot write does) and returns
    (y, cache_k, cache_v)."""
    B = x.shape[0]
    smax = cache_k.shape[1]
    positions = pos[:, None].to(torch.int32)
    q, k, v = _project_qkv(params, x, n_heads, kv_heads, head_dim, positions,
                           theta)
    rows = torch.arange(B, device=x.device)
    at = pos.long().clamp(max=smax - 1)
    fits = (pos < smax)[:, None, None]
    cache_k[rows, at] = torch.where(fits, k[:, 0].to(cache_k.dtype),
                                    cache_k[rows, at])
    cache_v[rows, at] = torch.where(fits, v[:, 0].to(cache_v.dtype),
                                    cache_v[rows, at])

    G, Hg = kv_heads, n_heads // kv_heads
    qh = q.reshape(B, G, Hg, head_dim).float()               # (B, G, Hg, D)
    kt = cache_k.permute(0, 2, 3, 1).float()                 # (B, G, D, Smax)
    s = (qh @ kt) * head_dim ** -0.5                         # (B, G, Hg, Smax)
    kpos = torch.arange(smax, device=x.device)[None, :]
    live = kpos <= pos[:, None]
    if window > 0:
        live &= kpos > (pos[:, None] - window)
    s = s.masked_fill(~live[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(COMPUTE_DTYPE)
    y = p @ cache_v.permute(0, 2, 1, 3)                      # (B, G, Hg, D)
    y = y.reshape(B, 1, n_heads * head_dim)
    out = y.to(COMPUTE_DTYPE) @ params["w_o"].to(COMPUTE_DTYPE)
    return out, cache_k, cache_v
