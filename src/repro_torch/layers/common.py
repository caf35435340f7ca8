"""Shared building blocks: RMSNorm, rotary embeddings, MLP variants.

Parameters are plain dicts of tensors, laid out as the JAX package's
pytrees; every layer exposes an ``init`` and a pure ``apply``. Compute dtype
is bf16 with fp32 params and fp32 softmax/norm accumulation (mixed
precision), rounding where the reference rounds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models import sharding as sh

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


def _dense_init(gen: torch.Generator, shape, device, scale=None,
                fan_in_dim: int = 0) -> torch.Tensor:
    """Normal(0, 1) * fan_in ** -0.5, the fan-in read from ``shape``'s
    ``fan_in_dim`` (1 for weights stacked on a leading layer axis)."""
    scale = scale if scale is not None else shape[fan_in_dim] ** -0.5
    return torch.randn(shape, generator=gen, dtype=PARAM_DTYPE,
                       device=device).mul_(scale)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, device, lead=()):
    return {"scale": torch.ones((*lead, d), dtype=PARAM_DTYPE, device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    """f32 only for the per-row variance; the normalize and scale
    multiplies run in bf16, as in the reference."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(COMPUTE_DTYPE)
    return x.to(COMPUTE_DTYPE) * inv * params["scale"].to(COMPUTE_DTYPE)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-dim rotation, NTK-free base theta)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). Rotates the
    two halves of the head dimension (not interleaved pairs)."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (half,)
    angles = positions[..., :, None].float() * freqs        # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GEGLU / GELU)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, ff: int, device,
             activation: str = "swiglu", lead=()):
    fan = len(lead)
    if activation in ("swiglu", "geglu"):
        names = (("w_gate", (d, ff)), ("w_up", (d, ff)), ("w_down", (ff, d)))
    else:
        names = (("w_up", (d, ff)), ("w_down", (ff, d)))
    return {name: _dense_init(gen, (*lead, *shape), device, fan_in_dim=fan)
            for name, shape in names}


def _sigmoid(x):
    return torch.reciprocal(1 + torch.exp(-x))


class _SiLU(torch.autograd.Function):
    """silu with the gradient XLA computes for ``jax.nn.silu``, each step
    rounded to x's dtype: g * s + (x * g) * (s * (1 - s)), s = sigmoid(x).
    Autograd's chain through ``exp`` and ``reciprocal`` rounds elsewhere
    and moves the recurrent families' gradients by several bf16 steps."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * _sigmoid(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = _sigmoid(x)
        return g * s + (x * g) * (s * (1 - s))


def silu(x):
    """x * sigmoid(x), the sigmoid taken as 1 / (1 + exp(-x)) with each step
    rounded to x's dtype: the bits jax.nn.silu gives in bf16 on the CPU. A
    fused ``F.silu`` rounds once, which differs from it by a bf16 step in
    about 40% of normally spread inputs, and those steps add up over the
    recurrent families' layers. Its gradient is ``_SiLU``'s."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SiLU.apply(x)
    return x * _sigmoid(x)


def gelu(x):
    # jax.nn.gelu's default is the tanh approximation.
    return F.gelu(x, approximate="tanh")


def mlp_apply(params, x, activation: str = "swiglu", shard_ctx=None):
    """With ``shard_ctx`` running tensor parallelism, the weights arrive
    split as Megatron splits them (``w_gate``, ``w_up`` by columns,
    ``w_down`` by rows): x enters through f and the output leaves through
    an all-reduce (g)."""
    if shard_ctx is not None and shard_ctx.tp:
        mesh, M = shard_ctx.mesh, shard_ctx.model
        y = mlp_apply(params, sh.reduce_bwd(x.to(COMPUTE_DTYPE), mesh, M),
                      activation)
        return sh.reduce_fwd(y, mesh, M)
    xc = x.to(COMPUTE_DTYPE)
    if activation in ("swiglu", "geglu"):
        gate = xc @ params["w_gate"].to(COMPUTE_DTYPE)
        up = xc @ params["w_up"].to(COMPUTE_DTYPE)
        act = silu(gate) if activation == "swiglu" else gelu(gate)
        return (act * up) @ params["w_down"].to(COMPUTE_DTYPE)
    up = xc @ params["w_up"].to(COMPUTE_DTYPE)
    return gelu(up) @ params["w_down"].to(COMPUTE_DTYPE)
