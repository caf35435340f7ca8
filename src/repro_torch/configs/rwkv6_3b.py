"""rwkv6-3b [ssm]: Finch — data-dependent decay [arXiv:2404.05892; hf].
32L d_model=2560 (attn-free) d_ff=8960 vocab=65536."""

import dataclasses

from ..models.config import Family, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family=Family.SSM,
    n_layers=32, d_model=2560, n_heads=40, d_ff=8960, vocab=65536,
    rwkv_head_dim=64,
)

SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                            d_ff=128, vocab=128, rwkv_head_dim=16)
