"""The dense decoder of the port (``repro_torch.models.lm`` and
``repro_torch.layers``) against the JAX package's, on the reference's own
parameters carried across through numpy, for the six smoke configs of the
families built from uniform transformer blocks (DENSE, VLM, AUDIO).

Tolerances. Both sides compute in bf16 (8 significant bits, a relative
step of 2^-8) and round at slightly different points: XLA on the CPU may
keep an elementwise chain in f32 where PyTorch rounds after each op, and
the two libraries sum matrix products in other orders. Over two blocks
with residual adds that gives differences of a few bf16 steps. Hidden
states and logits are held to rtol 2^-5 and atol 2^-4 element by element
(8 steps at 1.0) and to a mean absolute difference of at most 2^-6; the
mean next-token loss, an average over all tokens, to rtol 2^-8. A wrong
mask, head grouping, rotation or cache index moves values by O(1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.core.relshard import plan_model as ref_plan_model
from repro.layers import attention as ref_attn
from repro.layers import common as ref_cm
from repro.layers import embedding as ref_emb
from repro.models import lm as ref_lm
from repro.models.config import SHAPE_BY_NAME as REF_SHAPES
from repro_torch.configs import get_smoke_config
from repro_torch.core.relshard import plan_model
from repro_torch.layers import attention as attn
from repro_torch.layers import common as cm
from repro_torch.layers import embedding as emb
from repro_torch.models import lm
from repro_torch.models.config import SHAPE_BY_NAME

MESH1 = (("data", 1), ("model", 1))
ARCHS = ["musicgen_large", "granite_8b", "tinyllama_1_1b", "starcoder2_3b",
         "glm4_9b", "paligemma_3b"]
RTOL, ATOL, MEAN_ATOL, LOSS_RTOL = 2 ** -5, 2 ** -4, 2 ** -6, 2 ** -8
B, S, S_DECODE = 2, 64, 16


def assert_close(port, ref, rtol=RTOL, atol=ATOL, mean_atol=MEAN_ATOL):
    port = np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)
    assert np.abs(port - ref).mean() <= mean_atol


def t(a, dtype=None):
    x = torch.from_numpy(np.ascontiguousarray(a))
    return x if dtype is None else x.to(dtype)


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


class Run:
    """One smoke config's inputs, the reference's params and outputs, and
    the port's outputs on the same params."""

    def __init__(self, arch):
        self.arch = arch
        self.ref_cfg, self.cfg = ref_smoke(arch), get_smoke_config(arch)
        shape = "train_4k"
        self.ref_plan = ref_plan_model(self.ref_cfg, MESH1, REF_SHAPES[shape],
                                       fsdp=False)
        self.plan = plan_model(self.cfg, MESH1, SHAPE_BY_NAME[shape],
                               fsdp=False)
        self.ref_params = ref_lm.init_params(self.ref_cfg,
                                             jax.random.PRNGKey(0))
        self.np_params = jax.tree.map(np.asarray, self.ref_params)
        self.params = lm.params_from_numpy(self.np_params, "cpu")
        rng = np.random.default_rng(ARCHS.index(arch))
        self.tokens = rng.integers(0, self.cfg.vocab, (B, S)).astype(np.int32)
        self.cond = None
        if self.cfg.n_cond_tokens:
            self.cond = (0.01 * rng.standard_normal(
                (B, self.cfg.n_cond_tokens, self.cfg.d_model))).astype(
                    np.float32)

    def ref_inputs(self):
        cond = None if self.cond is None else jnp.asarray(
            self.cond).astype(jnp.bfloat16)
        return jnp.asarray(self.tokens), cond

    def port_inputs(self):
        cond = None if self.cond is None else t(self.cond, torch.bfloat16)
        return t(self.tokens), cond


_RUNS = {}


@pytest.fixture
def run(arch):
    if arch not in _RUNS:
        _RUNS[arch] = Run(arch)
    return _RUNS[arch]


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_equals_reference(run):
    port = flat(lm.init_params(run.cfg, seed=0, device="cpu"))
    ref = flat(run.np_params)
    assert sorted(port) == sorted(ref)
    for path, leaf in port.items():
        assert tuple(leaf.shape) == ref[path].shape, path
        assert leaf.dtype == torch.float32 and ref[path].dtype == np.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_init_distributions_follow_the_reference(run):
    """Every leaf's spread within 10% of the reference's (the scales of
    repro/layers/common.py, embedding.py and attention.py)."""
    port = flat(lm.init_params(run.cfg, seed=1, device="cpu"))
    ref = flat(run.np_params)
    for path, leaf in port.items():
        r = ref[path]
        if path[-1] == "scale":
            assert torch.equal(leaf, torch.ones_like(leaf))
            continue
        assert float(leaf.std()) == pytest.approx(float(r.std()), rel=0.1)
        assert abs(float(leaf.mean())) < 0.1 * float(r.std())


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_through_numpy(run):
    back = flat(lm.params_to_numpy(run.params))
    for path, leaf in flat(run.np_params).items():
        assert np.array_equal(back[path], leaf)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_analytic(run):
    """tests/test_models.py's check: the analytic count excludes the
    norms, within 2%."""
    actual = sum(x.numel() for x in flat(lm.init_params(
        run.cfg, device="cpu")).values())
    assert abs(actual - run.cfg.param_count()) / actual < 0.02


# ---------------------------------------------------------------------------
# Forward, prefill, train loss and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_equals_reference(run):
    ref, ref_aux = ref_lm.forward(run.ref_params, run.ref_cfg, run.ref_plan,
                                  None, *run.ref_inputs())
    port, aux = lm.forward(run.params, run.cfg, run.plan, None,
                           *run.port_inputs())
    assert port.dtype == torch.bfloat16
    assert port.shape == (B, S + run.cfg.n_cond_tokens, run.cfg.d_model)
    assert_close(port.float(), np.asarray(ref, np.float32))
    assert aux.moe_load is None and ref_aux.moe_load is None
    assert float(aux.moe_aux_loss) == float(ref_aux.moe_aux_loss) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_equal_reference(run):
    ref = ref_lm.prefill(run.ref_params, run.ref_cfg, run.ref_plan, None,
                         *run.ref_inputs())
    port = lm.prefill(run.params, run.cfg, run.plan, None,
                      *run.port_inputs())
    assert port.dtype == torch.float32 and port.shape == (B, run.cfg.vocab)
    assert_close(port, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_equals_reference(run):
    tokens, cond = run.ref_inputs()
    batch = {"tokens": tokens} if cond is None else {"tokens": tokens,
                                                     "cond_emb": cond}
    ref, ref_metrics = ref_lm.train_loss(run.ref_params, run.ref_cfg,
                                         run.ref_plan, None, batch)
    tokens, cond = run.port_inputs()
    batch = {"tokens": tokens} if cond is None else {"tokens": tokens,
                                                     "cond_emb": cond}
    port, metrics = lm.train_loss(run.params, run.cfg, run.plan, None, batch)
    assert float(port) == pytest.approx(float(ref), rel=LOSS_RTOL)
    assert float(metrics["ce_loss"]) == pytest.approx(
        float(ref_metrics["ce_loss"]), rel=LOSS_RTOL)
    assert float(metrics["moe_aux"]) == float(metrics["moe_dropped"]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_equal_reference(run):
    """Every step's logits, and the cache written, on the reference's
    params (conditioning off, as tests/test_models.py decodes)."""
    ref_cfg = dataclasses.replace(run.ref_cfg, n_cond_tokens=0)
    cfg = dataclasses.replace(run.cfg, n_cond_tokens=0)
    ref_cache = ref_lm.init_cache(ref_cfg, B, S_DECODE)
    cache = lm.init_cache(cfg, B, S_DECODE, device="cpu")
    # one compile for every step (called eagerly, each step's scan
    # compiled its block again)
    ref_step = jax.jit(lambda p, tok, c: ref_lm.decode_step(
        p, ref_cfg, run.ref_plan, None, tok, c))
    for step in range(S_DECODE):
        tok = run.tokens[:, step:step + 1]
        ref, ref_cache = ref_step(run.ref_params, jnp.asarray(tok),
                                  ref_cache)
        port, cache = lm.decode_step(run.params, cfg, run.plan, None, t(tok),
                                     cache)
        assert_close(port, ref)
        assert np.array_equal(cache["pos"].numpy(), np.asarray(
            ref_cache["pos"]))
    for name in ("k", "v"):
        assert_close(cache[name].float(),
                     np.asarray(ref_cache[name], np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(run):
    """tests/test_models.py's check on the port, with the port's own
    random params: teacher-forced decode reproduces the full-sequence
    logits (rtol 0.2, atol 0.25, the reference's tolerance)."""
    cfg = dataclasses.replace(run.cfg, n_cond_tokens=0)
    plan = plan_model(cfg, MESH1, SHAPE_BY_NAME["decode_32k"], fsdp=False)
    params = lm.init_params(cfg, seed=2, device="cpu")
    tokens = t(run.tokens[:, :S_DECODE])
    hidden, _ = lm.forward(params, cfg, plan, None, tokens)
    full = emb.lm_head_logits(params["head"], hidden, mesh=None,
                              batch_axes=plan.batch_axes,
                              model_axis=plan.model_axis,
                              strategy="replicate")
    cache = lm.init_cache(cfg, B, max_seq=S_DECODE, device="cpu")
    outs = []
    for step in range(S_DECODE):
        logits, cache = lm.decode_step(params, cfg, plan, None,
                                       tokens[:, step:step + 1], cache)
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, dim=1).numpy(),
                               full.numpy(), rtol=0.2, atol=0.25)


@pytest.mark.parametrize("arch", ARCHS)
def test_resident_bf16_copy_gives_the_same_bits(run):
    """The serving engine's bf16 copy of the weights: the same logits, bit
    for bit, as casting the fp32 weights at every use."""
    tokens, cond = run.port_inputs()
    ref = lm.prefill(run.params, run.cfg, run.plan, None, tokens, cond)
    port = lm.prefill(lm.cast_params(run.params), run.cfg, run.plan, None,
                      tokens, cond)
    assert torch.equal(port, ref)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,lt,q_chunk,k_chunk", [
    (0, False, 256, 512), (300, False, 256, 512), (0, True, 256, 256),
    (200, True, 128, 128)])
def test_chunked_attention_equals_reference(window, lt, q_chunk, k_chunk):
    rng = np.random.default_rng(window + q_chunk)
    Bq, Sq, H, G, D = 1, 1024, 4, 2, 16
    q = rng.standard_normal((Bq, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((Bq, Sq, G, D)).astype(np.float32)
    v = rng.standard_normal((Bq, Sq, G, D)).astype(np.float32)
    kw = dict(kv_heads=G, causal=True, q_chunk=q_chunk, k_chunk=k_chunk,
              window=window, lower_triangular_schedule=lt)
    ref = ref_attn.chunked_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)), **kw)
    port = attn.chunked_attention(
        *(t(a, torch.bfloat16) for a in (q, k, v)), **kw)
    assert port.dtype == torch.bfloat16
    assert_close(port.float(), np.asarray(ref, np.float32))


def test_chunked_attention_needs_whole_chunks():
    x = torch.zeros(1, 96, 2, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not divide"):
        attn.chunked_attention(x, x, x, kv_heads=2, q_chunk=64, k_chunk=64)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlp_equals_reference(activation):
    """GELU is the tanh approximation, as jax.nn.gelu's default."""
    params = ref_cm.mlp_init(jax.random.PRNGKey(3), 64, 256, activation)
    x = np.random.default_rng(3).standard_normal((2, 8, 64)).astype(
        np.float32)
    ref = ref_cm.mlp_apply(params, jnp.asarray(x), activation)
    port = cm.mlp_apply(lm.params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"), t(x), activation)
    assert_close(port.float(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_loss_equals_reference(masked):
    """lm_head_loss over 1,100 positions: three CE_CHUNK chunks, the last
    one short, with and without a label mask."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 1100, 64)).astype(np.float32)
    labels = rng.integers(0, 128, (2, 1100)).astype(np.int32)
    table = (rng.standard_normal((128, 64)) * 0.125).astype(np.float32)
    mask = (rng.random((2, 1100)) < 0.7).astype(np.float32) if masked \
        else None
    kw = dict(mesh=None, batch_axes=(), model_axis="model",
              strategy="replicate")
    ref = ref_emb.lm_head_loss(
        {"table": jnp.asarray(table)}, jnp.asarray(x), jnp.asarray(labels),
        label_mask=None if mask is None else jnp.asarray(mask), **kw)
    port = emb.lm_head_loss({"table": t(table)}, t(x), t(labels),
                            label_mask=None if mask is None else t(mask),
                            **kw)
    assert emb.CE_CHUNK == ref_emb.CE_CHUNK == 512
    assert float(port) == pytest.approx(float(ref), rel=LOSS_RTOL)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to the tanh form, which differs from the exact
    one by up to ~5e-4, below bf16's step: held in f32 here."""
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    np.testing.assert_allclose(cm.gelu(t(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_rope_and_rmsnorm_equal_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)[None, :] + 500
    ref = ref_cm.apply_rope(jnp.asarray(x).astype(jnp.bfloat16),
                            jnp.asarray(pos), 10_000.0)
    port = cm.apply_rope(t(x, torch.bfloat16), t(pos), 10_000.0)
    assert_close(port.float(), np.asarray(ref, np.float32))
    scale = rng.standard_normal(32).astype(np.float32)
    ref = ref_cm.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    port = cm.rmsnorm({"scale": t(scale)}, t(x))
    assert port.dtype == torch.bfloat16
    assert_close(port.float(), np.asarray(ref, np.float32))


# ---------------------------------------------------------------------------
# A one-rank mesh equals mesh=None; without a card, init raises
# ---------------------------------------------------------------------------

def test_a_mesh_raises(monkeypatch):
    """A mesh no longer raises: on a one-rank mesh (every collective a
    no-op, the sharded code paths taken) forward and decode equal
    mesh=None within one bf16 rounding step."""
    from tests.helpers.lm_shard import one_rank_mesh
    cfg = get_smoke_config("granite_8b")
    plan = plan_model(cfg, MESH1, SHAPE_BY_NAME["train_4k"], fsdp=False)
    params = lm.init_params(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), one_rank_mesh() as mesh:
        for m in (None, mesh):
            h, _ = lm.forward(params, cfg, plan, m, tokens)
            lg, _ = lm.decode_step(params, cfg, plan, m, tokens[:, :1],
                                   lm.init_cache(cfg, 2, 8, device="cpu",
                                                 mesh=m, plan=plan))
            if m is None:
                want = (h.float(), lg)
    torch.testing.assert_close(h.float(), want[0], rtol=2 ** -7, atol=2 ** -6)
    torch.testing.assert_close(lg, want[1], rtol=2 ** -7, atol=2 ** -6)


def test_without_a_card_init_raises(monkeypatch):
    cfg = get_smoke_config("tinyllama_1_1b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_cache(cfg, 2, 8)
    assert lm.init_cache(cfg, 2, 8, device="cpu")["k"].device.type == "cpu"
