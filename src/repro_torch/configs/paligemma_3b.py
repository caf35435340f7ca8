"""paligemma-3b [vlm]: SigLIP + gemma [arXiv:2407.07726; hf].
18L d_model=2048 8H (GQA kv=1, MQA) d_ff=16384 vocab=257216. head_dim=256
(gemma convention). The SigLIP frontend is a STUB: input_specs provides
precomputed patch embeddings (B, 256, d)."""

import dataclasses

from ..models.config import Family, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family=Family.VLM,
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257216, n_cond_tokens=256, mlp_activation="geglu",
)

SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=1, head_dim=16, d_ff=256, vocab=256,
                            n_cond_tokens=8)
