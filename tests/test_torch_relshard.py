"""RelShard in the port (``repro_torch.core.relshard``) against the JAX
package's: every case of tests/test_relshard.py with the reference's chip
constants passed in, the same OpDecisions and explain() text for every
config x shape x mesh, the H100 defaults, and the port's own configs."""

import dataclasses
import importlib
import sys

import pytest

from repro.configs import ARCH_ALIASES as REF_ALIASES
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core import relshard as ref_relshard
from repro.models.config import SHAPES as REF_SHAPES
from repro_torch.configs import (ARCH_ALIASES, ARCH_IDS, get_config,
                                 get_smoke_config)
from repro_torch.core.cost_model import CostParams, k0_threshold
from repro_torch.core.relshard import (HBM_BYTES, NVLINK_GBPS, HBM_GBPS,
                                       W_DEFAULT, ShardingPlan, plan_model,
                                       replan)
from repro_torch.models.config import SHAPE_BY_NAME, SHAPES, ModelConfig

MESH = (("data", 16), ("model", 16))
MESH_MP = (("pod", 2), ("data", 16), ("model", 16))

#: The reference's chip constants (repro/core/relshard.py), passed in so
#: that the port's decisions can be held to the reference's.
REF_W = 819.0 / 50.0
REF_HBM = 16 * 1024 ** 3


def ref_plan(cfg, mesh, shape, **kw):
    return plan_model(cfg, mesh, shape, w=REF_W, hbm_bytes=REF_HBM, **kw)


# ---------------------------------------------------------------------------
# tests/test_relshard.py, case by case, on the port
# ---------------------------------------------------------------------------

def test_small_vocab_replicates():
    plan = ref_plan(get_config("musicgen_large"), MESH,
                    SHAPE_BY_NAME["train_4k"])
    assert plan.embed_strategy == "replicate"
    d = [x for x in plan.decisions if x.op == "embedding"][0]
    assert d.k > d.k0
    assert d.cost_broadcast < d.cost_shuffle


def test_large_vocab_shards():
    plan = ref_plan(get_config("paligemma_3b"), MESH,
                    SHAPE_BY_NAME["train_4k"])
    assert plan.embed_strategy == "vocab_parallel"
    d = [x for x in plan.decisions if x.op == "embedding"][0]
    assert d.k <= d.k0


def test_k0_matches_cost_model():
    plan = ref_plan(get_config("glm4_9b"), MESH, SHAPE_BY_NAME["train_4k"])
    k0 = k0_threshold(CostParams(p=16, w=plan.w))
    for d in plan.decisions:
        assert d.k0 == pytest.approx(k0)


def test_w_derived_from_chip_constants():
    plan = ref_plan(get_config("glm4_9b"), MESH, SHAPE_BY_NAME["train_4k"])
    assert plan.w == pytest.approx(ref_relshard.W_TPU_DEFAULT)
    assert plan.w == pytest.approx(819.0 / 50.0)


def test_moe_dispatch_decision():
    plan = ref_plan(get_config("qwen3_moe_235b_a22b"), MESH,
                    SHAPE_BY_NAME["train_4k"])
    assert plan.moe_strategy == "expert_parallel"
    d = [x for x in plan.decisions if x.op == "moe_dispatch"][0]
    assert d.k <= d.k0


def test_decode_memory_gate():
    plan = ref_plan(get_config("glm4_9b"), MESH, SHAPE_BY_NAME["decode_32k"])
    assert plan.embed_strategy == "replicate"
    assert "decode" in plan.decisions[0].reason


def test_multi_pod_batch_axes():
    plan = ref_plan(get_config("granite_8b"), MESH_MP,
                    SHAPE_BY_NAME["train_4k"])
    assert plan.batch_axes == ("pod", "data")
    assert plan.fsdp_axes == ("data",)


def test_explain_is_auditable():
    plan = ref_plan(get_config("dbrx_132b"), MESH, SHAPE_BY_NAME["train_4k"])
    text = plan.explain()
    assert "moe_dispatch" in text and "k0=" in text


def test_replan_responds_to_occupancy():
    cfg = get_config("paligemma_3b")
    shape = SHAPE_BY_NAME["decode_32k"]
    plan = ref_plan(cfg, MESH, shape)
    new = replan(plan, cfg, MESH, shape, measured_tokens=1)
    assert isinstance(new, ShardingPlan)
    d = [x for x in new.decisions if x.op == "embedding"][0]
    assert d.size_a == 1 * cfg.d_model * 2
    assert new.w == REF_W and new.hbm_bytes == REF_HBM


def test_train_vs_decode_regime_differs():
    cfg = get_config("glm4_9b")
    train_plan = ref_plan(cfg, MESH, SHAPE_BY_NAME["train_4k"])
    decode_plan = ref_plan(cfg, MESH, SHAPE_BY_NAME["decode_32k"])
    assert train_plan.embed_strategy == "vocab_parallel"
    assert decode_plan.embed_strategy == "replicate"


# ---------------------------------------------------------------------------
# Every config x shape x mesh: the reference's decisions, exactly
# ---------------------------------------------------------------------------

def _plan_fields(plan):
    return (plan.batch_axes, plan.model_axis, plan.fsdp_axes,
            plan.embed_strategy, plan.head_strategy, plan.moe_strategy,
            plan.w, plan.tp,
            tuple(dataclasses.astuple(d) for d in plan.decisions),
            plan.explain())


@pytest.mark.parametrize("mesh", [MESH, MESH_MP], ids=["2d", "pod"])
@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_equals_reference(arch, shape, mesh):
    for fsdp in (True, False):
        ref = ref_relshard.plan_model(ref_get_config(arch), mesh,
                                      SHAPE_BY_NAME[shape], fsdp=fsdp)
        port = ref_plan(get_config(arch), mesh, SHAPE_BY_NAME[shape],
                        fsdp=fsdp)
        assert _plan_fields(port) == _plan_fields(ref)


@pytest.mark.parametrize("tokens", [1, 7, 4096])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_replan_equals_reference(arch, tokens):
    for shape in ("decode_32k", "train_4k"):
        s = SHAPE_BY_NAME[shape]
        ref = ref_relshard.plan_model(ref_get_config(arch), MESH, s)
        port = ref_plan(get_config(arch), MESH, s)
        assert _plan_fields(
            replan(port, get_config(arch), MESH, s, tokens)) == _plan_fields(
            ref_relshard.replan(ref, ref_get_config(arch), MESH, s, tokens))


# ---------------------------------------------------------------------------
# The H100 defaults
# ---------------------------------------------------------------------------

def test_h100_defaults():
    assert (HBM_GBPS, NVLINK_GBPS, HBM_BYTES) == (3350.0, 900.0, 80e9)
    assert W_DEFAULT == pytest.approx(3350.0 / 900.0)
    plan = plan_model(get_config("glm4_9b"), MESH, SHAPE_BY_NAME["train_4k"])
    assert plan.w == pytest.approx(W_DEFAULT)
    assert plan.hbm_bytes == HBM_BYTES
    k0 = k0_threshold(CostParams(p=16, w=W_DEFAULT))
    assert all(d.k0 == pytest.approx(k0) for d in plan.decisions)


def test_h100_budget_keeps_experts_resident():
    """One layer of qwen3's experts (9.7 GB in fp32) exceeds half of the
    reference's 16 GiB, but fits half of the H100's 80 GB: the decode-time
    gate flips, and replan keeps the budget the plan was made with."""
    cfg = get_config("qwen3_moe_235b_a22b")
    shape = SHAPE_BY_NAME["decode_32k"]
    assert ref_plan(cfg, MESH, shape).moe_strategy == "expert_parallel"
    plan = plan_model(cfg, MESH, shape)
    assert plan.moe_strategy == "replicate"
    assert replan(plan, cfg, MESH, shape, 3).moe_strategy == "replicate"
    assert replan(plan, cfg, MESH, shape, 3,
                  hbm_bytes=REF_HBM).moe_strategy == "expert_parallel"


# ---------------------------------------------------------------------------
# The port's configs come from the port
# ---------------------------------------------------------------------------

def test_configs_are_the_ports_own():
    assert ARCH_IDS == REF_ARCH_IDS and ARCH_ALIASES == REF_ALIASES
    for arch in ARCH_IDS + list(ARCH_ALIASES):
        for get, ref_get in ((get_config, ref_get_config),
                             (get_smoke_config, ref_get_smoke_config)):
            cfg = get(arch)
            assert type(cfg) is ModelConfig
            ref = ref_get(arch)
            assert type(ref) is not ModelConfig
            port_fields = dataclasses.asdict(cfg)
            ref_fields = dataclasses.asdict(ref)
            assert port_fields.pop("family").value == \
                ref_fields.pop("family").value
            assert port_fields == ref_fields
    mod = ARCH_ALIASES["granite-8b"]
    assert get_config("granite-8b") is importlib.import_module(
        f"repro_torch.configs.{mod}").CONFIG
    assert sys.modules[f"repro_torch.configs.{mod}"].SMOKE is \
        get_smoke_config("granite_8b")


def test_shapes_equal_the_reference():
    assert [dataclasses.astuple(s) for s in SHAPES] == \
        [dataclasses.astuple(s) for s in REF_SHAPES]
