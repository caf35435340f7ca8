"""tinyllama-1.1b [dense]: llama2-arch small [arXiv:2401.02385; hf].
22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000."""

import dataclasses

from ..models.config import Family, ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family=Family.DENSE,
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab=32000,
)

SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=2, d_ff=256, vocab=128)
