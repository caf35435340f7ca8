"""The port's optimizers (``repro_torch.training.optimizer``) against the JAX
package's ``repro.training.optimizer``, and tests/test_training.py's
optimizer cases in the port.

Tolerance. Both sides compute every update in fp32 with the same
operations in the same order, so the port equals the reference to fp32
rounding: params and state within rtol 2^-20 (8 fp32 steps) and atol 1e-8
after 5 steps. The steps that remain come from two places. XLA's CPU
backend contracts a product that feeds a sum into one fused multiply-add
(``b1 * m + (1 - b1) * g`` rounds once where PyTorch rounds twice), and
the per-leaf sums of squares and Adafactor's means add in another order.
Each moves a value by about one fp32 step a step. The learning rate, the
warm-up ratio and the bias corrections are equal bit for bit (XLA turns
the warm-up's division by a constant into a multiplication by its fp32
reciprocal, and so does the port).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as ref_opt
from repro_torch.training import optimizer as opt
from repro_torch.training.tree import tree_leaves, tree_map

RTOL, ATOL = 2 ** -20, 1e-8
STEPS = 5
#: 1-, 2-, 3- and 4-D leaves (the 4-D one an (L, E, d, ff) expert stack)
SHAPES = {"b": (7,), "w": (5, 9),
          "blocks": {"attn": (3, 4, 6), "experts": (2, 3, 5, 8)}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def draw(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: draw(rng, v, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


def to_jax(tree):
    return tree_map(lambda a: jnp.asarray(np.array(a, copy=True)), tree)


def assert_trees_close(port, ref, rtol=RTOL, atol=ATOL):
    ref_leaves = jax.tree.leaves(ref)
    port_leaves = tree_leaves(port)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        r = np.asarray(r)
        assert tuple(p.shape) == r.shape
        assert p.numpy().dtype == r.dtype
        np.testing.assert_allclose(p.numpy(), r, rtol=rtol, atol=atol)


CASES = {
    "adamw": dict(name="adamw", lr=1e-2, warmup_steps=3),
    "adamw-unclipped": dict(name="adamw", lr=1e-2, warmup_steps=1,
                            grad_clip=100.0),
    "adamw-bf16-grads": dict(name="adamw", lr=1e-2, warmup_steps=100,
                             grad_dtype="bfloat16"),
    "adafactor": dict(name="adafactor", lr=1e-2, warmup_steps=3),
    "adafactor-unclipped": dict(name="adafactor", lr=1e-2, warmup_steps=1,
                                grad_clip=100.0),
    "adafactor-bf16-grads": dict(name="adafactor", lr=1e-2,
                                 warmup_steps=100, grad_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", CASES)
def test_init_state_tree_equals_reference(case):
    kw = CASES[case]
    params = draw(np.random.default_rng(0), SHAPES)
    ref = ref_opt.init_opt_state(ref_opt.OptConfig(**kw), to_jax(params))
    port = opt.init_opt_state(opt.OptConfig(**kw), to_torch(params))
    assert jax.tree_util.tree_structure(ref) == \
        jax.tree_util.tree_structure(tree_map(lambda t: 0, port))
    assert_trees_close(port, ref, rtol=0, atol=0)
    assert port["step"].dtype == torch.int32 and port["step"].dim() == 0


@pytest.mark.parametrize("case", CASES)
def test_apply_updates_equals_reference(case):
    """5 steps from identical params, state and grads; the clip is active
    (grad norm ~5 against 1) or not (against 100), the warm-up runs over
    the steps or ends at step 1. The port's tensors are updated in place
    and returned."""
    kw = CASES[case]
    rng = np.random.default_rng(1)
    params = draw(rng, SHAPES)
    ref_cfg, cfg = ref_opt.OptConfig(**kw), opt.OptConfig(**kw)
    r_params = to_jax(params)
    r_state = ref_opt.init_opt_state(ref_cfg, r_params)
    p_params = to_torch(params)
    p_state = opt.init_opt_state(cfg, p_params)
    step = jax.jit(lambda p, s, g: ref_opt.apply_updates(ref_cfg, p, s, g))
    for i in range(STEPS):
        grads = draw(rng, SHAPES, 0.3)
        r_params, r_state, r_m = step(r_params, r_state, to_jax(grads))
        before = [id(t) for t in tree_leaves((p_params, p_state))]
        out_p, out_s, p_m = opt.apply_updates(cfg, p_params, p_state,
                                              to_torch(grads))
        assert [id(t) for t in tree_leaves((out_p, out_s))] == before
        assert float(p_m["lr"]) == float(r_m["lr"])
        assert float(p_m["grad_norm"]) == pytest.approx(
            float(r_m["grad_norm"]), rel=RTOL)
        assert int(out_s["step"]) == int(r_state["step"]) == i + 1
        assert_trees_close(out_p, r_params)
        assert_trees_close(out_s, r_state)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_pieces_give_the_values_of_the_whole_leaf(name, monkeypatch):
    """The update walks each leaf in pieces; pieces of a single row (or a
    single matrix) give the same bits as one piece."""
    rng = np.random.default_rng(2)
    params, grads = draw(rng, SHAPES), draw(rng, SHAPES, 0.3)
    cfg = opt.OptConfig(name=name, lr=1e-2, warmup_steps=2)
    out = []
    for piece in (opt.PIECE_ELEMS, 1):
        monkeypatch.setattr(opt, "PIECE_ELEMS", piece)
        p = to_torch(params)
        s = opt.init_opt_state(cfg, p)
        for _ in range(2):
            opt.apply_updates(cfg, p, s, to_torch(grads))
        out.append(tree_leaves((p, s)))
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_lr_schedule_equals_reference():
    for warm in (1, 3, 7, 30, 100):
        ref_cfg = ref_opt.OptConfig(lr=1e-3, warmup_steps=warm)
        cfg = opt.OptConfig(lr=1e-3, warmup_steps=warm)
        fn = jax.jit(lambda s, c=ref_cfg: ref_opt.lr_at(c, s))
        for s in range(0, 2 * warm + 2):
            want = np.float32(fn(jnp.int32(s)))
            got = opt.lr_at(cfg, torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert np.float32(got.item()) == want, (warm, s)


def test_opt_state_round_trips_through_numpy():
    rng = np.random.default_rng(3)
    params = to_torch(draw(rng, SHAPES))
    for name in ("adamw", "adafactor"):
        cfg = opt.OptConfig(name=name)
        state = opt.init_opt_state(cfg, params)
        opt.apply_updates(cfg, params, state, to_torch(draw(rng, SHAPES)))
        back = opt.opt_state_from_numpy(opt.opt_state_to_numpy(state), "cpu")
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(state), tree_leaves(back)))


def test_opt_state_specs_raise_without_a_mesh_port():
    with pytest.raises(NotImplementedError, match="item 5"):
        opt.opt_state_specs(opt.OptConfig(), {"w": None})


# ---------------------------------------------------------------------------
# tests/test_training.py's optimizer cases, in the port
# ---------------------------------------------------------------------------

def test_adamw_reduces_loss_on_quadratic():
    cfg = opt.OptConfig(lr=0.1, warmup_steps=1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init_opt_state(cfg, params)
    for _ in range(100):
        g = {"w": 2 * params["w"]}  # d/dw of w^2
        params, state, _ = opt.apply_updates(cfg, params, state, g)
    assert float(params["w"].abs().max()) < 0.2


def test_adafactor_state_is_factored():
    cfg = opt.OptConfig(name="adafactor", lr=0.01)
    params = {"w": torch.ones((8, 16)), "b": torch.ones((16,))}
    state = opt.init_opt_state(cfg, params)
    assert state["fact"]["w"]["vr"].shape == (8,)
    assert state["fact"]["w"]["vc"].shape == (16,)
    assert state["fact"]["b"]["v"].shape == (16,)
    g = tree_map(torch.ones_like, params)
    p2, s2, _ = opt.apply_updates(cfg, params, state, g)
    assert float(p2["w"][0, 0]) < 1.0


def test_grad_compression_flag():
    cfg = opt.OptConfig(lr=0.01, grad_dtype="bfloat16")
    params = {"w": torch.ones((4, 4))}
    state = opt.init_opt_state(cfg, params)
    g = {"w": torch.full((4, 4), 0.137)}
    p2, _, m = opt.apply_updates(cfg, params, state, g)
    assert np.isfinite(float(m["grad_norm"]))
    assert float(p2["w"][0, 0]) < 1.0


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        opt.init_opt_state(dataclasses.replace(opt.OptConfig(), name="sgd"),
                           {"w": torch.ones(2)})
