"""starcoder2-3b [dense]: GQA, RoPE [arXiv:2402.19173; hf].
30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152."""

import dataclasses

from ..models.config import Family, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family=Family.DENSE,
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab=49152, mlp_activation="gelu",
)

SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_model=96, n_heads=4,
                            n_kv_heads=2, d_ff=256, vocab=128)
