"""The recurrent families' decode against their forward beyond the smoke
size: a fact of the reference's numerics, pinned, and the port's f32 twin.

tests/test_models.py holds teacher-forced decode to forward within rtol
0.2, atol 0.25 at the smoke sizes (zamba2: 5 blocks of d 64; rwkv6: 2
of d 64). The chunked forms (``ssm_apply``, ``rwkv_time_mix``) and the
step forms (``ssm_decode``, ``rwkv_decode``) round to bf16 at different
points (the dt-scaled input, ``D``, the conv taps, the decayed r and k,
the state's bf16 copy), and with random weights the residual stream
grows, so the two drift apart as depth and width grow. At zamba2 with 7
blocks of d 128 and rwkv6 with 8 of d 128 (S = 64) the reference's own
decode leaves its forward beyond that tolerance, and so does the port's on
the reference's params; with every layer in f32 the port's two forms agree
within 1e-3, which is what ``chip_smoke.py`` phase 8 holds them to at full
width (``ROADMAP.md`` §3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.relshard import plan_model as ref_plan_model
from repro.layers import embedding as ref_emb
from repro.models import lm as ref_lm
from repro.models.config import SHAPE_BY_NAME as REF_SHAPES
from repro_torch.configs import get_config
from repro_torch.core.relshard import plan_model
from repro_torch.layers import attention, common, embedding, moe, rwkv, ssm
from repro_torch.models import lm
from repro_torch.models.config import SHAPE_BY_NAME

MESH1 = (("data", 1), ("model", 1))
DECODE_RTOL, DECODE_ATOL = 0.2, 0.25
B, S = 2, 64
SIZES = {
    "zamba2_7b": dict(n_layers=7, d_model=128, d_ff=256, n_heads=4,
                      n_kv_heads=4, vocab=512, ssm_state=16),
    "rwkv6_3b": dict(n_layers=8, d_model=128, d_ff=256, vocab=512),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small tensors: the suite runs in
    parallel worker processes, and idle OpenMP threads spin between ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def outside(dec, full) -> int:
    dec, full = np.asarray(dec, np.float32), np.asarray(full, np.float32)
    return int((np.abs(dec - full)
                > DECODE_ATOL + DECODE_RTOL * np.abs(full)).sum())


def port_decode_and_forward(params, cfg, plan, tokens):
    hidden, _ = lm.forward(params, cfg, plan, None, tokens)
    full = embedding.lm_head_logits(params["head"], hidden, mesh=None,
                                    batch_axes=(), model_axis="model",
                                    strategy="replicate")
    cache = lm.init_cache(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        logits, cache = lm.decode_step(params, cfg, plan, None,
                                       tokens[:, t:t + 1], cache)
        outs.append(logits)
    return torch.stack(outs, dim=1), full


@pytest.mark.parametrize("arch", sorted(SIZES))
def test_decode_leaves_forward_beyond_the_smoke_size(arch, monkeypatch):
    ref_cfg = dataclasses.replace(ref_get_config(arch), **SIZES[arch])
    ref_plan = ref_plan_model(ref_cfg, MESH1, REF_SHAPES["decode_32k"],
                              fsdp=False)
    ref_params = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, 512, (B, S)).astype(
        np.int32)
    hidden, _ = ref_lm.forward(ref_params, ref_cfg, ref_plan, None,
                               jnp.asarray(tokens))
    ref_full = ref_emb.lm_head_logits(ref_params["head"], hidden, mesh=None,
                                      batch_axes=(), model_axis="model",
                                      strategy="replicate")
    step = jax.jit(lambda p, t, c: ref_lm.decode_step(p, ref_cfg, ref_plan,
                                                      None, t, c))
    cache = ref_lm.init_cache(ref_cfg, B, S)
    outs = []
    for t in range(S):
        logits, cache = step(ref_params, jnp.asarray(tokens[:, t:t + 1]),
                             cache)
        outs.append(logits)
    assert outside(jnp.stack(outs, axis=1), ref_full) > 0

    cfg = dataclasses.replace(get_config(arch), **SIZES[arch])
    plan = plan_model(cfg, MESH1, SHAPE_BY_NAME["decode_32k"], fsdp=False)
    params = lm.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                  "cpu")
    dec, full = port_decode_and_forward(params, cfg, plan,
                                        torch.from_numpy(tokens))
    assert outside(dec, full) > 0

    for module in (attention, common, embedding, moe, rwkv, ssm):
        monkeypatch.setattr(module, "COMPUTE_DTYPE", torch.float32)
    dec, full = port_decode_and_forward(params, cfg, plan,
                                        torch.from_numpy(tokens))
    assert dec.dtype == torch.float32
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=1e-3,
                               atol=1e-3)
