"""dbrx-132b [moe]: 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified]. 40L d_model=6144 48H (GQA kv=8)
d_ff=10752 vocab=100352, MoE 16e top-4. Adafactor optimizer (memory)."""

import dataclasses

from ..models.config import Family, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family=Family.MOE,
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352, n_experts=16, top_k=4,
    optimizer="adafactor",
)

SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=2, d_ff=128, vocab=128, n_experts=4,
                            top_k=2)
