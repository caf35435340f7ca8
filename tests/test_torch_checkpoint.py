"""The port's checkpoints (``repro_torch.training.checkpoint``): the JAX
package's on-disk layout and leaf order, so that a checkpoint of either
package restores in the other bit for bit; atomic publication; and
tests/test_training.py's checkpoint cases in the port."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import lm as ref_lm
from repro.training import checkpoint as ref_ck
from repro.training import optimizer as ref_opt
from repro_torch.models import lm
from repro_torch.training import checkpoint as ck
from repro_torch.training import optimizer as opt
from repro_torch.training.tree import tree_leaves, tree_map, treedef_str

ARCH = "qwen3_moe_235b_a22b"   # 1- to 4-D leaves, the expert stacks 4-D


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_checkpoint_atomicity(tmp_path):
    """A half-written checkpoint directory must never be selected."""
    d = str(tmp_path / "ck")
    os.makedirs(os.path.join(d, "step_00000009"))  # no manifest => ignored
    tree = {"a": torch.ones((3,)), "b": {"c": torch.zeros((2, 2))}}
    ck.save(d, 5, tree)
    assert ck.latest_step(d) == 5
    restored, _ = ck.restore(d, 5, tree)
    np.testing.assert_array_equal(restored["a"].numpy(), np.ones(3))


def test_a_writer_that_raises_leaves_nothing(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    tree = {"a": torch.ones((3,)), "b": torch.zeros((2,))}
    ck.save(d, 1, tree)
    calls = []
    real_save = np.save

    def failing_save(path, arr):
        calls.append(path)
        if len(calls) == 2:
            raise OSError("disk full")
        real_save(path, arr)
    monkeypatch.setattr(np, "save", failing_save)
    with pytest.raises(OSError, match="disk full"):
        ck.save(d, 2, tree)
    assert sorted(os.listdir(d)) == ["step_00000001"]
    assert ck.latest_step(d) == 1


def test_latest_step(tmp_path):
    d = str(tmp_path / "ck")
    assert ck.latest_step(d) is None
    os.makedirs(d)
    assert ck.latest_step(d) is None
    for step in (3, 12, 7):
        ck.save(d, step, {"w": torch.full((2,), float(step))})
    os.makedirs(os.path.join(d, "step_00000020"))  # unpublished
    assert ck.latest_step(d) == 12
    # saving a step again replaces it
    ck.save(d, 12, {"w": torch.zeros(2)})
    restored, _ = ck.restore(d, 12, {"w": torch.ones(2)})
    assert torch.equal(restored["w"], torch.zeros(2))


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    d = str(tmp_path / "ck")
    ck.save(d, 1, {"a": torch.ones((3,))})
    with pytest.raises(ValueError, match="shape"):
        ck.restore(d, 1, {"a": torch.ones((4,))})


def test_checkpoint_count_mismatch_rejected(tmp_path):
    d = str(tmp_path / "ck")
    ck.save(d, 1, {"a": torch.ones((3,))})
    with pytest.raises(ValueError, match="architecture mismatch"):
        ck.restore(d, 1, {"a": torch.ones((3,)), "b": torch.ones((3,))})


def test_restore_casts_to_like(tmp_path):
    d = str(tmp_path / "ck")
    ck.save(d, 1, {"a": torch.tensor([1.5, 2.5], dtype=torch.float64),
                   "s": torch.tensor(4, dtype=torch.int64)},
            extra={"arch": "x"})
    out, extra = ck.restore(d, 1, {"a": torch.zeros(2),
                                   "s": torch.zeros((), dtype=torch.int32)})
    assert out["a"].dtype == torch.float32 and out["s"].dtype == torch.int32
    assert out["a"].tolist() == [1.5, 2.5] and int(out["s"]) == 4
    assert extra == {"arch": "x"}


def test_restore_onto_shardings_raises(tmp_path):
    d = str(tmp_path / "ck")
    ck.save(d, 1, {"w": torch.ones(2)})
    with pytest.raises(NotImplementedError, match="item 5"):
        ck.restore(d, 1, {"w": torch.ones(2)}, shardings={"w": object()})


def test_leaf_order_is_jax_tree_flatten():
    tree = {"params": {"b": 1, "a": {"z": 2, "y": 3}}, "opt": {"vr": 4,
                                                             "vc": 5}}
    assert tree_leaves(tree) == jax.tree_util.tree_leaves(tree)
    assert treedef_str(tree) == str(jax.tree_util.tree_structure(tree))


# ---------------------------------------------------------------------------
# Across the two packages
# ---------------------------------------------------------------------------

@functools.cache
def reference_state(name):
    """A smoke config's {"params", "opt"} from the reference, after one
    update, so that every state leaf holds values (read-only)."""
    cfg = ref_smoke(ARCH)
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(0))
    ocfg = ref_opt.OptConfig(name=name)
    state = ref_opt.init_opt_state(ocfg, params)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01), params)
    params, state, _ = ref_opt.apply_updates(ocfg, params, state, grads)
    return {"params": params, "opt": state}


def port_like(ref_tree, name):
    params = lm.params_from_numpy(
        jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                     ref_tree["params"]), "cpu")
    return {"params": params,
            "opt": opt.init_opt_state(opt.OptConfig(name=name), params)}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, name):
    d = str(tmp_path / "ck")
    ref_tree = reference_state(name)
    ref_ck.save(d, 3, ref_tree, extra={"arch": ARCH})
    assert ck.latest_step(d) == 3
    like = port_like(ref_tree, name)
    out, extra = ck.restore(d, 3, like)
    assert extra == {"arch": ARCH}
    ref_leaves = jax.tree.leaves(ref_tree)
    assert len(tree_leaves(out)) == len(ref_leaves)
    for p, r in zip(tree_leaves(out), ref_leaves):
        r = np.asarray(r)
        assert p.numpy().dtype == r.dtype and tuple(p.shape) == r.shape
        assert np.array_equal(p.numpy(), r)
    # the restored tree runs: an update of the restored state
    opt.apply_updates(opt.OptConfig(name=name), out["params"], out["opt"],
                      tree_map(torch.zeros_like, out["params"]))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, name):
    d = str(tmp_path / "ck")
    ref_tree = reference_state(name)
    port_tree = lm.params_from_numpy(jax.tree.map(np.asarray, ref_tree),
                                     "cpu")
    ck.save(d, 4, port_tree, extra={"arch": ARCH})
    with open(os.path.join(d, "step_00000004", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["treedef"] == str(jax.tree_util.tree_structure(
        ref_tree))
    zeros = jax.tree.map(jnp.zeros_like, ref_tree)
    out, extra = ref_ck.restore(d, 4, zeros)
    assert extra == {"arch": ARCH}
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(ref_tree)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
