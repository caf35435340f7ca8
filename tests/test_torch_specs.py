"""The port's partition specs equal the reference's, entry for entry (JAX's
``PartitionSpec`` read as a tuple), with no process group: ``param_specs``,
``_strip_fsdp``, the specs under ``block_compute_shardings``,
``opt_state_specs`` (AdamW and Adafactor), ``batch_pspec`` and
``_cache_pspec``, and ``input_specs``' and ``model_shardings``' specs.

For every config of the ten, under ``plan_model``'s own plans (train and
decode shapes) at meshes (16, 16), (2, 16, 16), (2, 2) and (1, 4), and
under every strategy forced with ``dataclasses.replace`` on the (2, 2)
train plan: embed and head ``replicate`` / ``vocab_parallel``, moe
``replicate`` / ``expert_parallel``, tp ``tensor_parallel`` /
``replicated``, fsdp on and off. Both packages get the same plan: the
port's, with the reference's constants, handed to the reference as its
fields (``tests/test_torch_relshard.py`` holds the plans themselves
equal).
"""

import dataclasses
import itertools

import jax
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as ref_config
from repro.core.relshard import ShardingPlan as RefPlan
from repro.launch import specs as ref_specs
from repro.models import lm as ref_lm
from repro.training import optimizer as ref_opt
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.relshard import plan_model
from repro_torch.launch import specs as port_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.models import sharding as sh
from repro_torch.models.config import ShapeConfig
from repro_torch.training import optimizer as opt
from tests.helpers.lm_shard import REF_HBM, REF_W, plan_fields

MESHES = {"16x16": (("data", 16), ("model", 16)),
          "2x16x16": (("pod", 2), ("data", 16), ("model", 16)),
          "2x2": (("data", 2), ("model", 2)),
          "1x4": (("data", 1), ("model", 4))}
SHAPES = (ShapeConfig("train", 4096, 256, "train"),
          ShapeConfig("decode", 4096, 128, "decode"))
FORCED = [dict(zip(("embed_strategy", "head_strategy", "moe_strategy",
                    "tp", "fsdp_axes"), combo))
          for combo in itertools.product(
              ("replicate", "vocab_parallel"), ("replicate",
                                                "vocab_parallel"),
              ("replicate", "expert_parallel"),
              ("tensor_parallel", "replicated"), (("data",), ()))]


def _plans(arch):
    cfg = get_config(arch)
    out = []
    for axes in MESHES.values():
        for shape in SHAPES:
            out.append((axes, plan_model(cfg, axes, shape, w=REF_W,
                                         hbm_bytes=REF_HBM,
                                         fsdp=shape.kind == "train")))
    base = plan_model(cfg, MESHES["2x2"], SHAPES[0], w=REF_W,
                      hbm_bytes=REF_HBM)
    out += [(MESHES["2x2"], dataclasses.replace(base, **f)) for f in FORCED]
    return out


@pytest.fixture(scope="module")
def shapes():
    """Per arch: (the port's params on meta, the reference's as
    ShapeDtypeStructs)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = (
                lm.init_params(get_config(arch), 0, device="meta"),
                jax.eval_shape(lambda: ref_lm.init_params(
                    ref_config(arch), jax.random.PRNGKey(0))))
        return cache[arch]
    return get


def _flat_ref(tree):
    return {"/".join(k.key for k in kp): tuple(s) for kp, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tuple(tree)}


def _ref_mesh(axes):
    return JAbstractMesh(tuple(s for _, s in axes),
                         tuple(n for n, _ in axes))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_state_specs_equal_the_reference(arch, shapes):
    port_p, ref_p = shapes(arch)
    for axes, plan in _plans(arch):
        rplan = RefPlan(**plan_fields(plan))
        specs = lm.param_specs(get_config(arch), port_p, plan)
        want = ref_lm.param_specs(ref_config(arch), ref_p, rplan)
        assert _flat(specs) == _flat_ref(want), (arch, axes, plan)
        for name in ("adamw", "adafactor"):
            got = opt.opt_state_specs(opt.OptConfig(name=name), specs)
            ref = ref_opt.opt_state_specs(ref_opt.OptConfig(name=name), want)
            assert _flat(got) == _flat_ref(ref), (arch, name, plan)
        for spec in _flat(specs).values():
            for strip in (None, plan.model_axis):
                assert tuple(lm._strip_fsdp(sh.P(*spec), plan.fsdp_axes,
                                            strip)) == tuple(
                    ref_lm._strip_fsdp(JP(*spec), plan.fsdp_axes, strip))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_block_compute_shardings_equal_the_reference(arch, shapes):
    port_p, ref_p = shapes(arch)
    for axes, plan in _plans(arch):
        mesh = sh.AbstractMesh(axes)
        got = lm.block_compute_shardings(get_config(arch), port_p, plan, mesh)
        want = ref_lm.block_compute_shardings(
            ref_config(arch), ref_p, RefPlan(**plan_fields(plan)),
            _ref_mesh(axes))
        got = lm._map_tree(lambda ns: ns.spec, got)
        want = jax.tree.map(lambda ns: ns.spec, want)
        assert _flat(got) == _flat_ref(want), (arch, axes, plan)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for axes, plan in _plans(arch):
        mesh, rmesh = sh.AbstractMesh(axes), _ref_mesh(axes)
        rplan = RefPlan(**plan_fields(plan))
        for B in (1, 2, 8, 128, 256, 24):
            assert tuple(port_specs.batch_pspec(plan, mesh, B)) == tuple(
                ref_specs.batch_pspec(rplan, rmesh, B))
            for S in (512, 1024, 32768):
                for name, shp in lm.cache_shapes(cfg, B, S).items():
                    assert tuple(port_specs._cache_pspec(
                        shp, cfg, plan, mesh, B)) == tuple(
                        ref_specs._cache_pspec(shp, rcfg, rplan, rmesh, B)), (
                        arch, name, shp, plan)


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "paligemma_3b",
                                  "qwen3_moe_235b_a22b", "zamba2_7b",
                                  "rwkv6_3b"])
def test_input_specs_and_model_shardings_equal_the_reference(arch, shapes):
    cfg, rcfg = get_config(arch), ref_config(arch)
    axes = MESHES["2x16x16"]
    mesh, rmesh = sh.AbstractMesh(axes), _ref_mesh(axes)
    for shape in SHAPES + (ShapeConfig("long", 524288, 1, "decode"),):
        plan = plan_model(cfg, axes, shape, w=REF_W, hbm_bytes=REF_HBM)
        rplan = RefPlan(**plan_fields(plan))
        got = port_specs.input_specs(cfg, shape, plan, mesh)
        want = ref_specs.input_specs(rcfg, shape, rplan, rmesh)
        assert set(got) == set(want)
        for k, v in want.items():
            if k == "cache":
                assert set(got["cache"]) == set(v)
                for name, s in v.items():
                    t, spec = got["cache"][name]
                    assert tuple(t.shape) == tuple(s.shape)
                    assert tuple(spec) == tuple(s.sharding.spec)
            else:
                t, spec = got[k]
                assert tuple(t.shape) == tuple(v.shape)
                assert tuple(spec) == tuple(v.sharding.spec)
        p_sds, o_sds, specs = port_specs.model_shardings(
            cfg, plan, mesh, opt.OptConfig(name=cfg.optimizer))
        assert _flat(lm._map_tree(lambda ts: ts[1], o_sds)) == _flat_ref(
            ref_opt.opt_state_specs(ref_opt.OptConfig(name=cfg.optimizer),
                                    ref_lm.param_specs(rcfg, shapes(arch)[1],
                                                       rplan)))
        pairs = []
        lm._map_tree(pairs.append, p_sds)
        assert all(t.device.type == "meta" for t, _ in pairs)
        assert _flat(lm._map_tree(lambda ts: ts[1], p_sds)) == _flat(specs)


def test_production_mesh_needs_its_world():
    with pytest.raises(ValueError, match="256 ranks; this one has 1"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks; this one has 1"):
        make_production_mesh(multi_pod=True)
