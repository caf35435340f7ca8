"""Embedding lookup and LM head, planned by RelShard.

The lookup is an equi-join: token ids (probe side A) against the vocab
table (build side B). ``repro_torch.core.relshard`` chooses ``replicate``
(the broadcast-hash analogue: a local take from a replicated table) or
``vocab_parallel`` (the shuffle-hash analogue: vocab shards and a reduction
of |A|-sized partials). On one device, with no mesh, both strategies are
the local take, as in the reference.

On a mesh (``shard_ctx``, a ``models.sharding.ShardCtx``) the table block
arrives as ``param_specs`` stores it and is cast to bf16, then gathered
over the fsdp axis (the all-gather moves bf16; its backward reduce-scatters
the bf16 gradient). ``vocab_parallel`` keeps the vocab split over the model
axis: the lookup takes the rank's rows (others zero) and sums over the
model axis; the loss reduces the logsumexp's max and sum and the gold logit
over it; the logits stay vocab-split.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..models import sharding as sh
from .common import COMPUTE_DTYPE, PARAM_DTYPE


def embedding_init(gen: torch.Generator, vocab: int, d: int, device):
    return {"table": torch.randn((vocab, d), generator=gen,
                                 dtype=PARAM_DTYPE, device=device) * 0.02}


def head_init(gen: torch.Generator, vocab: int, d: int, device):
    return {"table": torch.randn((vocab, d), generator=gen,
                                 dtype=PARAM_DTYPE, device=device)
            * d ** -0.5}


def table_spec(strategy: str, ctx) -> sh.P:
    """The table's stored spec (``lm.param_specs``'s)."""
    return sh.P(ctx.model if strategy == "vocab_parallel" else None,
                ctx.fsdp)


def _table(params, strategy, ctx, stored=None):
    """The compute-time table: bf16, the vocab split over the model axis
    (``vocab_parallel``) or whole, the fsdp axis gathered. ``stored`` is
    the block's spec when it differs from ``strategy``'s (a tied head)."""
    stored = table_spec(strategy, ctx) if stored is None else stored
    compute = sh.P(ctx.model if strategy == "vocab_parallel" else None, None)
    return sh.to_compute(params["table"], stored, compute, ctx, ctx.vary(),
                         cast=COMPUTE_DTYPE)


def _check_strategy(strategy):
    if strategy not in ("replicate", "vocab_parallel"):
        raise ValueError(f"unknown embedding strategy {strategy}")


def _vocab_rows(ids, table_loc, ctx):
    """(local row of each id, whether this rank holds it)."""
    vshard = table_loc.shape[0]
    local = ids.long() - ctx.mesh.index(ctx.model) * vshard
    ok = (local >= 0) & (local < vshard)
    return local.clamp(0, vshard - 1), ok


def embed_apply(params, ids, *, mesh, batch_axes, model_axis, strategy,
                shard_ctx=None, stored_spec=None):
    """ids: (B, S) integer -> (B, S, d) bf16. Gathers the rows first and
    casts them after: the same bits as the reference's cast-then-take."""
    if shard_ctx is None:
        return params["table"][ids.long()].to(COMPUTE_DTYPE)
    _check_strategy(strategy)
    table = _table(params, strategy, shard_ctx, stored_spec)
    if strategy == "replicate":
        return table[ids.long()]
    safe, ok = _vocab_rows(ids, table, shard_ctx)
    out = torch.where(ok[..., None], table[safe], 0).to(COMPUTE_DTYPE)
    return sh.reduce_fwd(out, shard_ctx.mesh, shard_ctx.model)


CE_CHUNK = 512


def _seq_chunked(fn, h, labels):
    """Stream a per-token computation over sequence chunks of ``CE_CHUNK``
    positions, so that one (B, C, V) logits block is the only vocab-sized
    temporary. Returns (B, S). While autograd records a graph, each chunk
    is checkpointed, as the reference's ``jax.checkpoint``: its logits are
    recomputed in the backward instead of kept for every chunk."""
    S = h.shape[1]
    if S <= CE_CHUNK:
        return fn(h, labels)
    if torch.is_grad_enabled():
        def run(h_c, lab_c):
            return checkpoint(fn, h_c, lab_c, use_reentrant=False)
    else:
        run = fn
    return torch.cat([run(h[:, i:i + CE_CHUNK], labels[:, i:i + CE_CHUNK])
                      for i in range(0, S, CE_CHUNK)], dim=1)


def lm_head_loss(params, x, labels, *, mesh, batch_axes, model_axis,
                 strategy, label_mask=None, shard_ctx=None,
                 stored_spec=None):
    """Cross-entropy over the head. x: (B, S, d); labels: (B, S). Returns
    the mean loss (fp32 scalar) over ``label_mask``. On a mesh x and
    labels are the rank's rows and the mean is the global batch's."""
    if shard_ctx is not None:
        return _lm_head_loss_sharded(params, x, labels, strategy, label_mask,
                                     shard_ctx, stored_spec)
    xf = x.to(COMPUTE_DTYPE)
    if label_mask is None:
        label_mask = torch.ones(labels.shape, dtype=torch.float32,
                                device=x.device)
    table = params["table"].to(COMPUTE_DTYPE)

    def ce_chunk(h_c, lab_c):
        logits = (h_c @ table.T).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = (h_c.float() * table[lab_c.long()].float()).sum(dim=-1)
        return lse - gold

    loss = _seq_chunked(ce_chunk, xf, labels) * label_mask
    return loss.sum() / torch.clamp(label_mask.sum(), min=1.0)


def _lm_head_loss_sharded(params, x, labels, strategy, label_mask, ctx,
                          stored):
    _check_strategy(strategy)
    mesh, M = ctx.mesh, ctx.model
    xf = x.to(COMPUTE_DTYPE)
    if label_mask is None:
        label_mask = torch.ones(labels.shape, dtype=torch.float32,
                                device=x.device)
    table = _table(params, strategy, ctx, stored)
    if strategy == "replicate":
        def ce_chunk(h_c, lab_c):
            logits = (h_c @ table.T).float()
            lse = torch.logsumexp(logits, dim=-1)
            gold = (h_c.float() * table[lab_c.long()].float()).sum(dim=-1)
            return lse - gold
    else:
        xf = sh.reduce_bwd(xf, mesh, M)     # each rank's vocab rows differ

        def ce_chunk(h_c, lab_c):
            logits = (h_c @ table.T).float()              # (B, C, V/m)
            # distributed logsumexp: the shards' max (no gradient), then
            # the sum of exp over every shard
            mx = sh.all_reduce_max(logits.amax(dim=-1), mesh, M)
            se = sh.reduce_fwd(torch.exp(logits - mx[..., None]).sum(-1),
                               mesh, M)
            lse = mx + torch.log(se)
            safe, ok = _vocab_rows(lab_c, table, ctx)
            gold = (h_c.float() * table[safe].float()).sum(dim=-1)
            return lse - sh.reduce_fwd(torch.where(ok, gold, 0.0), mesh, M)
    loss = _seq_chunked(ce_chunk, xf, labels) * label_mask
    tot = sh.reduce_fwd(loss.sum(), mesh, ctx.batch)
    cnt = sh.reduce_fwd(label_mask.sum(), mesh, ctx.batch)
    return tot / torch.clamp(cnt, min=1.0)


def lm_head_logits(params, x, *, mesh, batch_axes, model_axis, strategy,
                   shard_ctx=None, stored_spec=None):
    """Logits (..., vocab) in fp32, rounded through bf16 as the reference's
    bf16 product is. On a mesh with ``vocab_parallel`` they are the
    rank's vocab block (the reference's output spec is vocab-split)."""
    if shard_ctx is not None:
        _check_strategy(strategy)
        table = _table(params, strategy, shard_ctx, stored_spec)
        return (x.to(COMPUTE_DTYPE) @ table.T).float()
    xf = x.to(COMPUTE_DTYPE)
    return (xf @ params["table"].to(COMPUTE_DTYPE).T).float()
