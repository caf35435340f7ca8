"""musicgen-large [audio]: decoder-only over EnCodec tokens
[arXiv:2306.05284; hf]. 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.
The EnCodec/text frontend is a STUB: input_specs provides precomputed
conditioning frame embeddings (B, n_cond, d)."""

import dataclasses

from ..models.config import Family, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family=Family.AUDIO,
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, n_cond_tokens=64, mlp_activation="gelu",
)

SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=4, d_ff=256, vocab=128,
                            n_cond_tokens=4)
