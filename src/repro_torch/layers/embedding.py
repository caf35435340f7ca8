"""Embedding lookup and LM head, planned by RelShard.

The lookup is an equi-join: token ids (probe side A) against the vocab
table (build side B). ``repro_torch.core.relshard`` chooses ``replicate``
(the broadcast-hash analogue: a local take from a replicated table) or
``vocab_parallel`` (the shuffle-hash analogue: vocab shards and a reduction
of |A|-sized partials). On one device, with no mesh, both strategies are
the local take, as in the reference; the sharded paths are not ported yet
(``ROADMAP.md`` queue 1, item 5).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .common import COMPUTE_DTYPE, PARAM_DTYPE, require_no_mesh


def embedding_init(gen: torch.Generator, vocab: int, d: int, device):
    return {"table": torch.randn((vocab, d), generator=gen,
                                 dtype=PARAM_DTYPE, device=device) * 0.02}


def head_init(gen: torch.Generator, vocab: int, d: int, device):
    return {"table": torch.randn((vocab, d), generator=gen,
                                 dtype=PARAM_DTYPE, device=device)
            * d ** -0.5}


def embed_apply(params, ids, *, mesh, batch_axes, model_axis, strategy):
    """ids: (B, S) integer -> (B, S, d) bf16. Gathers the rows first and
    casts them after: the same bits as the reference's cast-then-take."""
    require_no_mesh(mesh)
    return params["table"][ids.long()].to(COMPUTE_DTYPE)


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
                 strategy, label_mask=None):
    """Cross-entropy over the head. x: (B, S, d); labels: (B, S). Returns
    the mean loss (fp32 scalar) over ``label_mask``."""
    require_no_mesh(mesh)
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


def lm_head_logits(params, x, *, mesh, batch_axes, model_axis, strategy):
    """Logits (..., vocab) in fp32, rounded through bf16 as the reference's
    bf16 product is."""
    require_no_mesh(mesh)
    xf = x.to(COMPUTE_DTYPE)
    return (xf @ params["table"].to(COMPUTE_DTYPE).T).float()
