"""Model configuration covering all assigned architecture families.

One dataclass spans dense / MoE / hybrid-SSM / pure-SSM (RWKV) / VLM / audio
backbones; family-specific fields are ignored elsewhere. Exact assigned
configs live in ``repro_torch.configs.<arch>``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    HYBRID = "hybrid"   # Mamba2 blocks + shared attention (zamba2)
    SSM = "ssm"         # attention-free (rwkv6)
    VLM = "vlm"         # vision-stub frontend + dense decoder
    AUDIO = "audio"     # audio-token decoder (musicgen)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_kv_heads: int = 0             # 0 -> = n_heads (MHA)
    head_dim: int = 0               # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_heads: int = 0              # 0 -> d_model // 64
    attn_every: int = 0             # hybrid: shared attn block period
    # --- RWKV ---
    rwkv_head_dim: int = 64
    # --- frontends (stubs) ---
    n_cond_tokens: int = 0          # VLM patches / audio conditioning prefix
    # --- common ---
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    mlp_activation: str = "swiglu"  # "swiglu" | "gelu" | "geglu"
    optimizer: str = "adamw"        # "adamw" | "adafactor"
    remat_policy: str = "full"      # "full" | "dots" | "none"
    # long-context: attention window for hybrid shared-attn at huge S (0=full)
    attn_window: int = 0

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def attention_free(self) -> bool:
        return self.family is Family.SSM

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / linear attention)."""
        return self.family in (Family.SSM, Family.HYBRID)

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs accounting)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family is Family.SSM:  # rwkv6
            per = _rwkv_params(self)
            return emb + self.n_layers * per
        att = d * self.n_heads * self.hd + d * self.hd * self.kv_heads * 2 \
            + self.n_heads * self.hd * d
        if self.mlp_activation in ("swiglu", "geglu"):
            mlp = 3 * d * ff
        else:
            mlp = 2 * d * ff
        if self.is_moe:
            mlp = self.n_experts * mlp + d * self.n_experts  # + router
        if self.family is Family.HYBRID:
            mamba = _mamba_params(self)
            n_attn = self.n_layers // max(self.attn_every, 1)
            mlp_h = 3 * d * ff
            return emb + self.n_layers * mamba + 1 * (att + mlp_h) * min(
                n_attn, 1) + 0 * n_attn
        return emb + self.n_layers * (att + mlp)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        mlp_all = self.n_experts * 3 * d * ff
        mlp_act = self.top_k * 3 * d * ff
        return self.param_count() - self.n_layers * (mlp_all - mlp_act)


def _mamba_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    d_inner = 2 * d
    heads = cfg.ssm_heads or d_inner // 64
    return (d * (2 * d_inner + 2 * cfg.ssm_state * heads + heads)  # in_proj
            + d_inner * d                                          # out_proj
            + heads * (2 + cfg.ssm_state))                         # A, D, dt


def _rwkv_params(cfg: ModelConfig) -> int:
    d, ff = cfg.d_model, cfg.d_ff
    # time-mix: r,k,v,g,o projections + decay MLP; channel-mix: 2 mats
    return 5 * d * d + 2 * d * 64 + d * ff + ff * d


# ---------------------------------------------------------------------------
# Input shape sets (assigned): every LM arch pairs with these four.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("SKIP(full-attention): long_500k requires sub-quadratic "
                "attention (assignment instruction); noted in DESIGN.md")
    return None
