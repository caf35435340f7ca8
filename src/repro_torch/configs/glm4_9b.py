"""glm4-9b [dense]: RoPE, GQA [hf:THUDM/glm-4-9b; hf].
40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552."""

import dataclasses

from ..models.config import Family, ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family=Family.DENSE,
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=151552,
)

SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=2, d_ff=256, vocab=160)
