"""qwen3-moe-235b-a22b [moe]: 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].
94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936, MoE 128e top-8.
head_dim=128 (Qwen3 convention). Adafactor optimizer (memory)."""

import dataclasses

from ..models.config import Family, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family=Family.MOE,
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936, n_experts=128, top_k=8,
    optimizer="adafactor",
)

SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=2, head_dim=16, d_ff=64, vocab=128,
                            n_experts=8, top_k=2)
