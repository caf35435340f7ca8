"""Deterministic synthetic token pipeline.

Stateless step->batch mapping: ``batch_for_step(cfg, step)`` is a pure
function of (seed, step), so a restarted job replays the exact token
stream, the property checkpoint/restart correctness depends on. Tokens
follow the reference's Zipf-like unigram draw, ``floor(exp(u ln V)) - 1
mod V`` for u uniform in [1e-6, 1), with every odd position its
predecessor plus one (mod V), so that the loss can fall. The bits are not
``jax.random``'s: the draw comes from a CPU ``torch.Generator`` seeded from
(seed, step), so the card and the CPU get the same batch.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..joins.table import resolve_device
from ..layers.common import COMPUTE_DTYPE


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_cond_tokens: int = 0
    d_model: int = 0  # for cond_emb stubs


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator whose state depends on (seed, step) alone."""
    (state,) = np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)
    return torch.Generator(device="cpu").manual_seed(int(state))


def batch_for_step(cfg: DataConfig, step: int, device=None):
    """Pure (seed, step) -> batch on ``device`` (the CUDA card unless the
    caller names another): {"tokens": (B, S) int32} and, with conditioning
    tokens, {"cond_emb": (B, n_cond, d) bf16}."""
    dev = resolve_device(device)
    gen = _generator(cfg.seed, step)
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    u = torch.rand((B, S), generator=gen) * (1.0 - 1e-6) + 1e-6
    ranks = torch.floor(torch.exp(u * math.log(V))) - 1
    base = ranks.to(torch.int32) % V
    # structure: every other token repeats its predecessor + 1 (learnable)
    shifted = torch.roll(base, 1, dims=1)
    alt = (torch.arange(S) % 2 == 1)[None, :]
    tokens = torch.where(alt, (shifted + 1) % V, base)
    batch = {"tokens": tokens.to(dev)}
    if cfg.n_cond_tokens:
        noise = torch.randn((B, cfg.n_cond_tokens, cfg.d_model),
                            generator=gen).to(COMPUTE_DTYPE)
        batch["cond_emb"] = (0.02 * noise).to(dev)
    return batch
