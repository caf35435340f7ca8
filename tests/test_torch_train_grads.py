"""The port's LM backward (``repro_torch.models.lm.train_loss`` under
autograd) and train step against the JAX package's ``jax.grad`` and
``make_train_step``, on the reference's own parameters and batch, for the
smoke configs of tinyllama_1_1b (DENSE), musicgen_large (AUDIO, with
``cond_emb``), qwen3_moe_235b_a22b (MoE, on the reference's recorded
routing), zamba2_7b (HYBRID) and rwkv6_3b (SSM).

Tolerances. The loss is held to test_torch_lm.py's rtol 2^-8. Each
gradient leaf is held to a relative L2 error of at most 2^-4 against
``jax.grad``. Both backward passes compute in bf16 (a relative step of
2^-8), and they round at other points. XLA transposes an f32-result bf16
product into a product rounded to bf16, where the port takes its products
on f32 copies and rounds at the cast. The reductions add in other orders.
Over a two-to-five-block model with residual adds that leaves errors of
2^-7 to 2^-5 (the recurrent families' at the top). A wrong transpose, a
missing path or a gradient taken through the wrong rounding (autograd's
chain through ``exp`` and ``reciprocal`` in SiLU) moves a leaf by far more.

One cause sits in the reference. XLA's CPU backend sums a bf16 reduction
with a bf16 accumulator, rounding after every add. The gradient of a
weight cast to bf16 and broadcast over the batch is such a sum. For
zamba2's ``D`` (one value a head, summed over B x S x head_dim = 8,192
products) and ``dt_bias`` this leaves the reference's own gradient several
percent off the exact sum of its bf16 products. The port accumulates in
fp32 and rounds once. Those two leaves are held to 2^-3 instead, and
``test_reference_sums_bf16_with_a_bf16_accumulator`` pins the cause: on
the same construct the reference returns the sequential bf16 sum, and the
port the exact sum within one bf16 step.

One train step from the same params and state, at remat "none": each
param within twice the larger of lr and the reference's own step of it
(its update but the weight decay, plus 2^-8 of that), and a mean
absolute difference of at most lr / 8. At step 1 AdamW moves every weight
by lr times the sign of its gradient, so a gradient near 0 may flip by
the rounding above and move a weight by 2 lr.
Adafactor's first update of a weight is its gradient over the factored
root mean square, up to 7-9 lr on the smoke qwen3, and a sign for an
expert that saw one token (a rank-1 gradient): a flip there moves the
weight by twice its update. Such flips must stay rare.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.core.relshard import plan_model as ref_plan_model
from repro.models import lm as ref_lm
from repro.models.config import SHAPE_BY_NAME as REF_SHAPES
from repro.training import optimizer as ref_opt
from repro.training.data import DataConfig as RefDataConfig
from repro.training.data import batch_for_step as ref_batch_for_step
from repro.training.train_loop import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.core.relshard import plan_model
from repro_torch.models import lm
from repro_torch.models.config import SHAPE_BY_NAME
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import make_train_step
from repro_torch.training.tree import tree_leaves, tree_map
from test_torch_lm_families import forcing_routing, reference_call

MESH1 = (("data", 1), ("model", 1))
ARCHS = ["tinyllama_1_1b", "musicgen_large", "qwen3_moe_235b_a22b",
         "zamba2_7b", "rwkv6_3b"]
B, S = 2, 64
LOSS_RTOL, GRAD_RTOL = 2 ** -8, 2 ** -4
#: leaves whose reference gradient is a long bf16-accumulated sum (see the
#: module docstring), and their bound
BF16_SUMMED = {("zamba2_7b", "blocks.ssm.D"),
               ("zamba2_7b", "blocks.ssm.dt_bias")}
BF16_SUMMED_RTOL = 2 ** -3
STEP_CFG = dict(lr=1e-3, warmup_steps=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flat_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in flat_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def torch_batch(batch):
    out = {"tokens": torch.from_numpy(np.array(batch["tokens"]))}
    if "cond_emb" in batch:
        out["cond_emb"] = torch.from_numpy(np.asarray(
            batch["cond_emb"].astype(jnp.float32))).to(torch.bfloat16)
    return out


class Case:
    """One smoke config at remat "none" on both sides: the reference's
    params and batch, its loss, metrics and gradients, and its routing."""

    def __init__(self, arch):
        self.ref_cfg = dataclasses.replace(ref_smoke(arch),
                                           remat_policy="none")
        self.cfg = dataclasses.replace(get_smoke_config(arch),
                                       remat_policy="none")
        self.ref_plan = ref_plan_model(self.ref_cfg, MESH1,
                                       REF_SHAPES["train_4k"], fsdp=False)
        self.plan = plan_model(self.cfg, MESH1, SHAPE_BY_NAME["train_4k"],
                               fsdp=False)
        self.ref_params = ref_lm.init_params(self.ref_cfg,
                                             jax.random.PRNGKey(0))
        self.np_params = jax.tree.map(np.asarray, self.ref_params)
        dc = RefDataConfig(self.cfg.vocab, S, B, ARCHS.index(arch),
                           self.cfg.n_cond_tokens, self.cfg.d_model)
        self.ref_batch = ref_batch_for_step(dc, 0)
        self.batch = torch_batch(self.ref_batch)
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, b: ref_lm.train_loss(p, self.ref_cfg, self.ref_plan,
                                           None, b), has_aux=True))
        ((self.loss, self.metrics), self.grads), self.routing = \
            reference_call(grad_fn, self.ref_params, self.ref_batch)

    def params(self):
        return lm.params_from_numpy(self.np_params, "cpu")

    def routed(self):
        return forcing_routing(self.routing) if self.cfg.is_moe else \
            _no_routing()


class _no_routing:
    def __enter__(self):
        return {}

    def __exit__(self, *exc):
        return False


_CASES = {}


@pytest.fixture
def case(arch):
    if arch not in _CASES:
        _CASES[arch] = Case(arch)
    return _CASES[arch]


def port_loss_and_grads(cfg, plan, params, batch):
    work = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = lm.train_loss(work, cfg, plan, None, batch)
    return loss, metrics, torch.autograd.grad(loss, tree_leaves(work))


def rel_l2(port, ref):
    port = port.double().numpy()
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(port - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_reference(arch, case):
    with case.routed():
        loss, metrics, grads = port_loss_and_grads(case.cfg, case.plan,
                                                   case.params(), case.batch)
    assert float(loss.detach()) == pytest.approx(float(case.loss),
                                                 rel=LOSS_RTOL)
    assert float(metrics["ce_loss"].detach()) == pytest.approx(
        float(case.metrics["ce_loss"]), rel=LOSS_RTOL)
    if case.cfg.is_moe:
        assert np.array_equal(metrics["moe_load"].numpy(),
                              np.asarray(case.metrics["moe_load"]))
        assert float(metrics["moe_dropped"]) == float(
            case.metrics["moe_dropped"])
        assert float(metrics["moe_aux"].detach()) == pytest.approx(
            float(case.metrics["moe_aux"]), rel=LOSS_RTOL)
    names = flat_names(case.np_params)
    ref_grads = jax.tree.leaves(case.grads)
    assert len(grads) == len(ref_grads) == len(names)
    for name, g, r in zip(names, grads, ref_grads):
        assert tuple(g.shape) == r.shape and g.dtype == torch.float32
        bound = BF16_SUMMED_RTOL if (arch, name) in BF16_SUMMED else \
            GRAD_RTOL
        assert rel_l2(g, r) <= bound, (name, rel_l2(g, r))


def test_reference_sums_bf16_with_a_bf16_accumulator():
    """zamba2's ``D`` enters as ``D.astype(bf16)[None, None, :, None] *
    xh`` (B, S, H, head_dim = 2, 64, 2, 64). XLA's gradient of it is the
    bf16-accumulated sum of the bf16 products, windows of 2 x 32 x 32 added
    one product after the other and the windows then added, rounding at
    every add; the port's is their fp32 sum rounded once."""
    bf16 = ml_dtypes.bfloat16
    rng = np.random.default_rng(0)
    xh = rng.standard_normal((2, 64, 2, 64)).astype(bf16)
    g = rng.standard_normal((2, 64, 2, 64)).astype(bf16)
    d = np.ones(2, np.float32)
    ref = np.asarray(jax.jit(lambda d, xh, g: jax.vjp(
        lambda d: d.astype(jnp.bfloat16)[None, None, :, None] * xh,
        d)[1](g)[0])(d, xh, g))
    td = torch.from_numpy(d).requires_grad_()
    y = td.to(torch.bfloat16)[None, None, :, None] * torch.from_numpy(
        xh.astype(np.float32)).to(torch.bfloat16)
    (port,) = torch.autograd.grad(y, td, torch.from_numpy(
        g.astype(np.float32)).to(torch.bfloat16))

    prods = (xh.astype(np.float32) * g.astype(np.float32)).astype(bf16)

    def bf16_sum(values):
        acc = bf16(0)
        for v in values:
            acc = bf16(np.float32(acc) + np.float32(v))
        return acc
    ref_err = []
    for h in range(2):
        windows = [prods[:, s:s + 32, h, k:k + 32].reshape(-1)
                   for s in (0, 32) for k in (0, 32)]
        assert ref[h] == np.float32(bf16_sum(bf16_sum(w) for w in windows))
        exact = prods[:, :, h].astype(np.float64).sum()
        assert abs(float(port[h]) - exact) <= 2 ** -8 * abs(exact)
        ref_err.append(abs(float(ref[h]) - exact) / abs(exact))
    assert max(ref_err) > 2 ** -4


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_equal_none(arch, case):
    """"full" and "dots" rematerialize every block (and "full" each CE
    chunk beyond 512 positions); on the CPU the recomputed blocks give the
    same loss and gradients bit for bit."""
    out = {}
    for policy in ("none", "full", "dots"):
        cfg = dataclasses.replace(case.cfg, remat_policy=policy)
        loss, _, grads = port_loss_and_grads(cfg, case.plan, case.params(),
                                             case.batch)
        out[policy] = [loss, *grads]
    for policy in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(out["none"],
                                                     out[policy])), policy


STEP_ARCHS = {"tinyllama_1_1b": "adamw", "qwen3_moe_235b_a22b": "adafactor"}


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_equals_reference(arch, case):
    """One step of ``make_train_step`` against the reference's under
    ``jax.jit``, from the same params, state and batch, each config with
    its own optimizer (tinyllama: AdamW; qwen3: Adafactor)."""
    kw = dict(STEP_CFG, name=STEP_ARCHS[arch])
    ref_cfg, cfg = ref_opt.OptConfig(**kw), opt.OptConfig(**kw)
    ref_state = ref_opt.init_opt_state(ref_cfg, case.ref_params)
    ref_step = jax.jit(ref_make_train_step(case.ref_cfg, case.ref_plan, None,
                                           ref_cfg))
    (r_params, r_state, r_metrics), routing = reference_call(
        ref_step, case.ref_params, ref_state, case.ref_batch)
    params = case.params()
    state = opt.init_opt_state(cfg, params)
    step = make_train_step(case.cfg, case.plan, None, cfg)
    with (forcing_routing(routing) if case.cfg.is_moe else _no_routing()):
        p2, s2, metrics = step(params, state, case.batch)
    assert p2 is params and s2 is state
    want = {"loss", "ce_loss", "moe_aux", "moe_dropped", "grad_norm", "lr"}
    assert set(metrics) == want | ({"moe_load"} if case.cfg.is_moe else
                                   set())
    assert set(r_metrics) == set(metrics)
    assert float(metrics["loss"]) == pytest.approx(float(r_metrics["loss"]),
                                                   rel=LOSS_RTOL)
    assert float(metrics["lr"]) == float(r_metrics["lr"])
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(r_metrics["grad_norm"]), rel=GRAD_RTOL)
    lr = cfg.lr
    for p, r, p0 in zip(tree_leaves(p2), jax.tree.leaves(r_params),
                        jax.tree.leaves(case.np_params)):
        r = np.asarray(r)
        diff = np.abs(p.numpy() - r)
        # lr times the reference's update without its weight decay
        step_size = np.abs(r - (1 - lr * cfg.weight_decay) * p0)
        bound = 2 * np.maximum(lr, step_size) * (1 + 2 ** -8)
        assert (diff <= bound).all()
        assert diff.mean() <= lr / 8
    assert int(s2["step"]) == int(r_state["step"]) == 1
