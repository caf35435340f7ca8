"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's: the cases of ``tests/test_roofline.py`` that do not read HLO
text, on the port (the term arithmetic on the port's H100 constants),
``model_flops`` equal for all ten configs x four shapes, and
``roofline_from_counts``."""

import pytest

from repro.configs import get_config as ref_config
from repro.launch import roofline as ref_rf
from repro.models.config import SHAPE_BY_NAME as REF_SHAPES
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import roofline as rf
from repro_torch.launch.hlo_cost import CostSummary
from repro_torch.models.config import SHAPE_BY_NAME, SHAPES

def test_roofline_terms_arithmetic():
    """The reference's case on the port's constants: 989 TFLOP/s,
    3.35 TB/s, 450 GB/s."""
    assert (rf.PEAK_FLOPS, rf.HBM_BW, rf.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)
    r = rf.Roofline(flops=989e12 * 10, hbm_bytes=3.35e12,
                    collective_bytes=450e9, chips=10, per_collective={})
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(0.1)
    assert r.collective_s == pytest.approx(0.1)
    assert r.bound == "compute"
    assert r.step_time_s() == pytest.approx(1.0)
    assert r.model_flops_ratio(989e12 * 5) == pytest.approx(0.5)


@pytest.mark.parametrize("terms, bound", [
    ((1.0, 2.0, 0.5), "memory"), ((1.0, 0.5, 3.0), "collective"),
    ((0.0, 0.0, 0.0), "compute")])
def test_roofline_bound_is_the_largest_term(terms, bound):
    c, m, k = terms
    r = rf.Roofline(flops=c * 4 * rf.PEAK_FLOPS,
                    hbm_bytes=m * 4 * rf.HBM_BW,
                    collective_bytes=k * 4 * rf.LINK_BW, chips=4,
                    per_collective={})
    assert r.bound == bound
    assert r.step_time_s() == pytest.approx(max(terms))
    assert r.model_flops_ratio(1.0) == (1.0 / r.flops if r.flops else 0.0)


def test_roofline_from_counts_multiplies_by_the_chips():
    s = CostSummary(2e12, 3e9, {"all-reduce": 4e8, "all-gather": 1e8})
    r = rf.roofline_from_counts(s, 256)
    assert (r.flops, r.hbm_bytes, r.collective_bytes, r.chips) == (
        2e12 * 256, 3e9 * 256, 5e8 * 256, 256)
    assert r.per_collective == s.collective_wire_bytes
    assert r.compute_s == pytest.approx(2e12 / 989e12)
    assert r.memory_s == pytest.approx(3e9 / 3.35e12)
    assert r.collective_s == pytest.approx(5e8 / 450e9)


def test_model_flops_dense_vs_moe():
    dense = get_config("granite_8b")
    moe = get_config("qwen3_moe_235b_a22b")
    shape = SHAPE_BY_NAME["train_4k"]
    fd = rf.model_flops(dense, shape)
    n = dense.param_count()
    assert fd == pytest.approx(6 * n * 4096 * 256, rel=1e-6)
    fm = rf.model_flops(moe, shape)
    assert fm < 6 * moe.param_count() * 4096 * 256 * 0.25


def test_decode_flops_per_token():
    cfg = get_config("tinyllama_1_1b")
    shape = SHAPE_BY_NAME["decode_32k"]
    f = rf.model_flops(cfg, shape)
    assert f == pytest.approx(2 * cfg.param_count() * 128, rel=1e-6)


@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch, shape):
    assert rf.model_flops(get_config(arch), SHAPE_BY_NAME[shape]) == \
        ref_rf.model_flops(ref_config(arch), REF_SHAPES[shape])
