"""zamba2-7b [hybrid]: Mamba2 + shared attention blocks
[arXiv:2411.15242; unverified]. 81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64. Shared attn block applied every 6 mamba blocks
(weights shared). long_500k uses a 4096-token sliding window for the shared
attention (DESIGN.md §Arch-applicability)."""

import dataclasses

from ..models.config import Family, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family=Family.HYBRID,
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, ssm_state=64, attn_every=6,
)

SMOKE = dataclasses.replace(CONFIG, n_layers=5, d_model=64, n_heads=4,
                            n_kv_heads=4, d_ff=128, vocab=128, ssm_state=8,
                            attn_every=2)
