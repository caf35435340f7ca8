"""Assigned architecture configs (exact public-literature values; sources
in each module docstring) + reduced smoke variants + the engine benchmark
config."""

import importlib
from typing import Dict

from ..models.config import ModelConfig

ARCH_IDS = [
    "musicgen_large", "granite_8b", "tinyllama_1_1b", "starcoder2_3b",
    "glm4_9b", "dbrx_132b", "qwen3_moe_235b_a22b", "zamba2_7b",
    "paligemma_3b", "rwkv6_3b",
]

#: CLI-facing ids (hyphenated, as assigned) -> module names.
ARCH_ALIASES = {
    "musicgen-large": "musicgen_large",
    "granite-8b": "granite_8b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "starcoder2-3b": "starcoder2_3b",
    "glm4-9b": "glm4_9b",
    "dbrx-132b": "dbrx_132b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "zamba2-7b": "zamba2_7b",
    "paligemma-3b": "paligemma_3b",
    "rwkv6-3b": "rwkv6_3b",
}


def get_config(arch: str) -> ModelConfig:
    mod = ARCH_ALIASES.get(arch, arch)
    m = importlib.import_module(f"repro_torch.configs.{mod}")
    return m.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = ARCH_ALIASES.get(arch, arch)
    m = importlib.import_module(f"repro_torch.configs.{mod}")
    return m.SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
