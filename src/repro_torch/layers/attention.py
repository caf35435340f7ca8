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

With a mesh (``shard_ctx``, a ``models.sharding.ShardCtx``) the reference's
GSPMD constraints become explicit collectives. ``attn_sharding_mode``
picks the reference's mode from the model axis's size: ``head`` (Megatron:
``w_q``, ``w_k``, ``w_v`` split by columns, the rank's heads, ``w_o``
split by rows and an all-reduce after it; KV heads repeated to the query
heads before the split when they do not divide), ``seq`` (each query
chunk's rows split over the model axis, KV replicated, the rows gathered
back) or ``batch`` (the rank's batch rows split over the model axis when
they divide, else the whole computation on every rank). Decode follows the
cache's placement: KV heads split over the model axis or whole, and a
sequence split over the batch axes (a batch that does not divide, long
contexts) takes its softmax across the shards.
"""

from __future__ import annotations

import torch

from ..models import sharding as sh
from .common import COMPUTE_DTYPE, _dense_init, apply_rope

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


def attn_sharding_mode(m: int, n_heads: int, q_chunk: int) -> str:
    """The reference's ``_attn_sharding_mode`` for a model axis of ``m``
    ranks: "head" when the heads divide, else "seq" when each query chunk's
    rows do, else "batch"."""
    if n_heads % m == 0:
        return "head"
    if q_chunk % m == 0:
        return "seq"
    return "batch"


def chunked_attention(q, k, v, *, kv_heads: int, causal: bool = True,
                      q_chunk: int = 256, k_chunk: int = 512,
                      window: int = 0,
                      lower_triangular_schedule: bool = False,
                      shard_ctx=None) -> torch.Tensor:
    """Online-softmax attention. q: (B,S,H,D); k,v: (B,S,G,D). Returns
    (B,S,H,D) bf16. ``window`` > 0 limits attention to the last ``window``
    keys. ``lower_triangular_schedule`` visits only the key chunks at or
    before each query chunk (causal, ``q_chunk == k_chunk``): the skipped
    chunks are fully masked, so the result is the same. ``shard_ctx``
    runs the query rows given: "seq" mode passes each chunk's rows of this
    rank as ``q`` and the whole K and V (see ``_attention_core``)."""
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
    pos = torch.arange(S, device=q.device)
    return _attention_core(q, k, v, pos.view(S // q_chunk, q_chunk),
                           k_chunk, causal, window,
                           lower_triangular_schedule and causal
                           and q_chunk == k_chunk)


def _attention_core(q, k, v, q_pos, k_chunk, causal, window, lt):
    """The online softmax over key chunks of ``k_chunk`` for query rows
    grouped in chunks: ``q_pos`` (nq, Cq) holds the positions of q's rows,
    chunk by chunk (q: (B, nq * Cq, H, D)); k, v: (B, S, H, D). ``lt``
    visits only key chunks up to the query chunk's index."""
    B, _, H, D = q.shape
    S = k.shape[1]
    nq, cq = q_pos.shape
    nk = S // k_chunk
    scale = D ** -0.5
    dev = q.device
    # (B, H, S, D): f32 copies of K for the f32 scores; V stays bf16 until
    # its product, which the reference also takes to f32.
    kt = k.permute(0, 2, 3, 1).float()                 # (B, H, D, S)
    vt = v.permute(0, 2, 1, 3).float()                 # (B, H, S, D)
    qt = q.permute(0, 2, 1, 3).float()                 # (B, H, nq*Cq, D)
    pos = torch.arange(S, device=dev)

    outs = []
    for qi in range(nq):
        qb = qt[:, :, qi * cq:(qi + 1) * cq]           # (B, H, Cq, D)
        qp = q_pos[qi]
        m = torch.full((B, H, cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, cq, D), dtype=torch.float32, device=dev)
        for kj in range(qi + 1 if lt else nk):
            k0 = kj * k_chunk
            kp = pos[k0:k0 + k_chunk]
            s = ((qb @ kt[..., k0:k0 + k_chunk]) * scale).to(COMPUTE_DTYPE)
            mask = torch.ones((cq, k_chunk), dtype=torch.bool, device=dev)
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
    # (B, H, nq*Cq, D) -> (B, nq*Cq, H, D)
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3).contiguous()


def attn_apply(params, x, *, n_heads, kv_heads, head_dim, theta,
               positions=None, q_chunk=256, k_chunk=512, window=0,
               lower_triangular_schedule=False, shard_ctx=None):
    """Full-sequence (train / prefill) attention, returns (y, (k, v))."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None, :]
    if shard_ctx is not None and shard_ctx.tp:
        return _attn_apply_tp(params, x, shard_ctx, n_heads, kv_heads,
                              head_dim, theta, positions, q_chunk, k_chunk,
                              window, lower_triangular_schedule)
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


def _project(x, w, heads, head_dim, positions=None, theta=None):
    B, S, _ = x.shape
    t = (x @ w.to(COMPUTE_DTYPE)).reshape(B, S, heads, head_dim)
    return t if positions is None else apply_rope(t, positions, theta)


def _attn_apply_tp(params, x, ctx, n_heads, kv_heads, head_dim, theta,
                   positions, q_chunk, k_chunk, window, lt_schedule):
    """The full-sequence path on a model axis: weights arrive split as
    ``param_specs`` stores them without the fsdp axis (``w_q``, ``w_k``,
    ``w_v`` by columns, ``w_o`` by rows); x is replicated over it."""
    mesh, M, m = ctx.mesh, ctx.model, ctx.m
    B, S, _ = x.shape
    H, G, D = n_heads, kv_heads, head_dim
    cq, ck = min(q_chunk, S), min(k_chunk, S)
    if S % cq or S % ck:
        raise ValueError(f"sequence length {S} does not divide into query "
                         f"chunks of {cq} and key chunks of {ck}")
    mode = attn_sharding_mode(m, H, cq)
    xc = x.to(COMPUTE_DTYPE)
    lt = lt_schedule and cq == ck

    def whole(name, dim, reduce_grad=False):
        return sh.gather(params[name].to(COMPUTE_DTYPE), mesh, M, dim,
                         reduce_grad=reduce_grad)

    if mode == "head":
        Hl = H // m
        xf = sh.reduce_bwd(xc, mesh, M)       # each rank's heads differ
        q = _project(xf, params["w_q"], Hl, D, positions, theta)
        if G % m == 0:
            k = _project(xf, params["w_k"], G // m, D, positions, theta)
            v = _project(xf, params["w_v"], G // m, D)
        else:
            # KV heads repeated to H on every rank, then the rank's heads
            k = _project(xc, whole("w_k", 1), G, D, positions, theta)
            v = _project(xc, whole("w_v", 1), G, D)
            k = sh.split(k.repeat_interleave(H // G, dim=2), mesh, M, 2)
            v = sh.split(v.repeat_interleave(H // G, dim=2), mesh, M, 2)
        if k.shape[2] != Hl:
            k = k.repeat_interleave(Hl // k.shape[2], dim=2)
            v = v.repeat_interleave(Hl // v.shape[2], dim=2)
        pos = torch.arange(S, device=x.device).view(S // cq, cq)
        y = _attention_core(q, k, v, pos, ck, True, window, lt)
        out = y.reshape(B, S, Hl * D) @ params["w_o"].to(COMPUTE_DTYPE)
        return sh.reduce_fwd(out, mesh, M), (k, v)

    if mode == "batch" and B % m == 0:
        # the rank's batch rows: the weights' consumers differ over M
        w = {n: whole(n, 0 if n == "w_o" else 1, reduce_grad=True)
             for n in ("w_q", "w_k", "w_v", "w_o")}
        xl = sh.split(xc, mesh, M, 0)
        y, kv = attn_apply(w, xl, n_heads=H, kv_heads=G, head_dim=D,
                           theta=theta, positions=positions, q_chunk=cq,
                           k_chunk=ck, window=window,
                           lower_triangular_schedule=lt_schedule)
        return sh.gather(y, mesh, M, 0, reduce_grad=False), kv

    w = {n: whole(n, 0 if n == "w_o" else 1)
         for n in ("w_q", "w_k", "w_v", "w_o")}
    if mode == "batch":
        return attn_apply(w, xc, n_heads=H, kv_heads=G, head_dim=D,
                          theta=theta, positions=positions, q_chunk=cq,
                          k_chunk=ck, window=window,
                          lower_triangular_schedule=lt_schedule)
    # "seq": each query chunk's rows split over M, K and V whole
    q, k, v = _project_qkv(w, xc, H, G, D, positions, theta)
    if G != H:
        k = k.repeat_interleave(H // G, dim=2)
        v = v.repeat_interleave(H // G, dim=2)
    k, v = sh.reduce_bwd(k, mesh, M), sh.reduce_bwd(v, mesh, M)
    nq, cl = S // cq, cq // m
    ql = sh.split(q.reshape(B, nq, cq, H, D), mesh, M, 2)
    r = mesh.index(M)
    pos = torch.arange(S, device=x.device).view(nq, cq)[:, r * cl:
                                                         (r + 1) * cl]
    y = _attention_core(ql.reshape(B, nq * cl, H, D), k, v, pos, ck, True,
                        window, lt)
    y = sh.gather(y.reshape(B, nq, cl, H, D), mesh, M, 2, reduce_grad=False)
    out = y.reshape(B, S, H * D) @ w["w_o"]
    return out, (k, v)


def attn_decode(params, x, cache_k, cache_v, pos, *, n_heads, kv_heads,
                head_dim, theta, window=0, shard_ctx=None):
    """One-token decode. x: (B,1,d); cache: (B,Smax,G,D); pos: (B,) current
    write position. Writes the new K/V into ``cache_k``/``cache_v`` in
    place at ``pos`` (a row whose ``pos`` is past the cache keeps its cache
    unchanged, as the reference's one-hot write does) and returns
    (y, cache_k, cache_v). With ``shard_ctx``, see ``_attn_decode_sharded``.
    """
    if shard_ctx is not None:
        return _attn_decode_sharded(params, x, cache_k, cache_v, pos,
                                    shard_ctx, n_heads, kv_heads, head_dim,
                                    theta, window)
    B = x.shape[0]
    positions = pos[:, None].to(torch.int32)
    q, k, v = _project_qkv(params, x, n_heads, kv_heads, head_dim, positions,
                           theta)
    _write_kv(cache_k, cache_v, k, v, pos)
    G, Hg = kv_heads, n_heads // kv_heads
    y = _decode_attend(q.reshape(B, G, Hg, head_dim), cache_k, cache_v, pos,
                       head_dim, window)                     # (B, G, Hg, D)
    y = y.reshape(B, 1, n_heads * head_dim)
    out = y.to(COMPUTE_DTYPE) @ params["w_o"].to(COMPUTE_DTYPE)
    return out, cache_k, cache_v


def _write_kv(cache_k, cache_v, k, v, pos, off: int = 0):
    """Each row's new K/V (B, 1, G, D) into the cache block (B, Smax, G, D)
    that holds positions ``off`` .. ``off + Smax - 1``, in place; a row
    whose ``pos`` falls outside the block keeps it unchanged."""
    B, smax = cache_k.shape[:2]
    rows = torch.arange(B, device=k.device)
    if off:
        at = (pos.long() - off).clamp(min=0, max=smax - 1)
        fits = ((pos >= off) & (pos < off + smax))[:, None, None]
    else:
        at = pos.long().clamp(max=smax - 1)
        fits = (pos < smax)[:, None, None]
    cache_k[rows, at] = torch.where(fits, k[:, 0].to(cache_k.dtype),
                                    cache_k[rows, at])
    cache_v[rows, at] = torch.where(fits, v[:, 0].to(cache_v.dtype),
                                    cache_v[rows, at])


def _decode_attend(q, cache_k, cache_v, pos, head_dim, window, off: int = 0,
                   seq=None):
    """One token's attention over a cache block: q (B, Gc, Hg, D), each of
    the block's Gc KV heads with the Hg query heads that read it; cache
    (B, Smax, Gc, D) at positions ``off`` on. Returns (B, Gc, Hg, D) in
    bf16. ``seq``: (mesh, axes) the sequence is split over; the softmax is
    then taken across the shards (max, denominator and weighted values
    reduced over ``axes``)."""
    smax = cache_k.shape[1]
    qh = q.float()
    kt = cache_k.permute(0, 2, 3, 1).float()                 # (B, Gc, D, S)
    s = (qh @ kt) * head_dim ** -0.5                         # (B,Gc,Hg,S)
    kpos = torch.arange(smax, device=q.device)[None, :]
    if off:
        kpos = kpos + off
    live = kpos <= pos[:, None]
    if window > 0:
        live &= kpos > (pos[:, None] - window)
    s = s.masked_fill(~live[:, None, None, :], NEG_INF)
    vt = cache_v.permute(0, 2, 1, 3)                         # (B, Gc, S, D)
    if seq is None:
        p = torch.softmax(s, dim=-1).to(COMPUTE_DTYPE)
        return p @ vt
    mesh, axes = seq
    mx = sh.all_reduce_max(s.amax(dim=-1, keepdim=True), mesh, axes)
    e = torch.exp(s - mx)
    den = sh.all_reduce_raw(mesh, e.sum(dim=-1, keepdim=True), axes)
    p = (e / den).to(COMPUTE_DTYPE)
    return sh.all_reduce_raw(mesh, p.float() @ vt.float(),
                             axes).to(COMPUTE_DTYPE)


@torch.no_grad()
def _attn_decode_sharded(params, x, cache_k, cache_v, pos, ctx, n_heads,
                         kv_heads, head_dim, theta, window):
    """Decode on a mesh. The cache block is placed as ``lm.cache_pspec``
    places it: its KV heads split over the model axis (``ctx.kv_model``)
    or whole, its sequence split over ``ctx.seq`` or whole. With tensor
    parallelism and heads that divide, the rank runs its query heads
    (``w_q`` columns, ``w_o`` rows, an all-reduce after); each reads its
    group's KV head, which the rank holds either way. Otherwise every rank
    runs every head."""
    mesh, M, m = ctx.mesh, ctx.model, ctx.m
    B = x.shape[0]
    H, G, D = n_heads, kv_heads, head_dim
    Hg = H // G
    xc = x.to(COMPUTE_DTYPE)
    positions = pos[:, None].to(torch.int32)
    head = ctx.tp and H % m == 0
    r = mesh.index(M)

    def whole(name, heads, rope=False):
        """Every head of a projection: the rank's columns of it, their
        outputs gathered over the model axis (a token's features, not the
        weight, cross it)."""
        t = xc @ params[name].to(COMPUTE_DTYPE)
        if ctx.tp:
            t = sh.all_gather_raw(mesh, t, M, 2)
        t = t.reshape(B, 1, heads, D)
        return apply_rope(t, positions, theta) if rope else t

    w_o = params["w_o"].to(COMPUTE_DTYPE)
    if head:                    # the rank's query heads h0 .. h0 + Hq - 1
        Hq, h0 = H // m, r * (H // m)
        q = _project(xc, params["w_q"], Hq, D, positions, theta)
    else:
        Hq, h0 = H, 0
        q = whole("w_q", H, rope=True)
        if ctx.tp:
            w_o = sh.all_gather_raw(mesh, w_o, M, 0)
    if ctx.kv_model:            # the cache block's groups g0 .. g0 + Gl - 1
        Gl, g0 = G // m, r * (G // m)
        k = _project(xc, params["w_k"], Gl, D, positions, theta)
        v = _project(xc, params["w_v"], Gl, D)
    else:
        g0 = 0
        k = whole("w_k", G, rope=True)
        v = whole("w_v", G)

    off = mesh.index(ctx.seq) * cache_k.shape[1] if ctx.seq else 0
    _write_kv(cache_k, cache_v, k, v, pos, off)
    if Hq % Hg == 0:
        # whole groups: the block's heads h0 // Hg - g0 on
        c0 = h0 // Hg - g0
        ck = cache_k.narrow(2, c0, Hq // Hg)
        cv = cache_v.narrow(2, c0, Hq // Hg)
        qg = q[:, 0].reshape(B, Hq // Hg, Hg, D)
    else:
        # parts of groups: each query head with its own group's K/V
        groups = (h0 + torch.arange(Hq, device=x.device)) // Hg - g0
        ck = cache_k.index_select(2, groups)
        cv = cache_v.index_select(2, groups)
        qg = q[:, 0].reshape(B, Hq, 1, D)
    y = _decode_attend(qg, ck, cv, pos, D, window, off,
                       (mesh, ctx.seq) if ctx.seq else None)
    out = y.reshape(B, 1, Hq * D).to(COMPUTE_DTYPE) @ w_o
    if head:
        out = sh.all_reduce_raw(mesh, out, M)
    return out, cache_k, cache_v
