"""The port's serving engine on the MoE, hybrid and RWKV-6 families (the
smoke configs of dbrx_132b, qwen3_moe_235b_a22b, zamba2_7b and rwkv6_3b,
on the reference's params): a request's tokens are greedy decoding through
``forward`` (the oracle) whether it runs alone or in company, in a slot
reused after another request, and run alone they equal the reference
engine's.

The oracle is read as in tests/test_torch_serving.py: each emitted token's
logit lies within ``MARGIN`` (2^-4) of the largest of ``forward``'s over
the prompt and the tokens before it. Every oracle sequence here is at most
8 tokens, so an MoE forward over it (at least 8 slots an expert, one
assignment a token) drops nothing, as the engine's decode steps do not.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.core.relshard import plan_model as ref_plan_model
from repro.models import lm as ref_lm
from repro.models.config import ShapeConfig as RefShapeConfig
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServeEngine as RefServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core.relshard import plan_model
from repro_torch.layers import moe
from repro_torch.models import lm
from repro_torch.models.config import ShapeConfig
from repro_torch.serving.engine import Request, ServeEngine

MESH1 = (("data", 1), ("model", 1))
ARCHS = ["dbrx_132b", "qwen3_moe_235b_a22b", "zamba2_7b", "rwkv6_3b"]
MARGIN = 2 ** -4
MAX_SEQ = 16
PROMPTS = [[7, 9, 11], [1, 2, 3, 4], [100], [5, 6]]
NEW = 5


class Model:
    def __init__(self, arch):
        self.ref_cfg, self.cfg = ref_smoke(arch), get_smoke_config(arch)
        shape = ("serve", MAX_SEQ, 4, "decode")
        self.ref_plan = ref_plan_model(self.ref_cfg, MESH1,
                                       RefShapeConfig(*shape), fsdp=False)
        self.plan = plan_model(self.cfg, MESH1, ShapeConfig(*shape),
                               fsdp=False)
        self.ref_params = ref_lm.init_params(self.ref_cfg,
                                             jax.random.PRNGKey(0))
        self.params = lm.params_from_numpy(
            jax.tree.map(np.asarray, self.ref_params), "cpu")
        self.weights = lm.cast_params(self.params)

    def engine(self, max_batch=4):
        return ServeEngine(self.cfg, self.plan, None, self.params,
                           max_batch=max_batch, max_seq=MAX_SEQ,
                           device="cpu")


_MODELS = {}


@pytest.fixture
def model(arch):
    if arch not in _MODELS:
        _MODELS[arch] = Model(arch)
    return _MODELS[arch]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small tensors: the suite runs in
    parallel worker processes, and idle OpenMP threads spin between ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def drain(eng, limit=200):
    steps = 0
    while (eng.queue or eng.occupancy()) and steps < limit:
        eng.step()
        steps += 1
    assert steps < limit
    return steps


def serve(model, prompts, max_batch=4):
    eng = model.engine(max_batch)
    reqs = [Request(i, list(p), NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    drain(eng)
    assert eng.dropped_decode_calls == 0
    assert all(r.done and len(r.out) == NEW for r in reqs)
    return [r.out for r in reqs], eng


def oracle_gaps(model, prompt, out):
    gaps = []
    for j, tok in enumerate(out):
        seq = torch.tensor([list(prompt) + list(out[:j])])
        assert seq.shape[1] <= 8
        logits = lm.prefill(model.weights, model.cfg, model.plan, None,
                            seq)[0]
        gaps.append(float(logits.max() - logits[tok]))
    return gaps


@pytest.mark.parametrize("arch", ARCHS)
def test_alone_and_in_company_follow_the_oracle(model):
    """Each prompt alone, then all four with two slots (slots reused after
    other requests): the same tokens, bit for bit, and each the oracle's."""
    alone = [serve(model, [p])[0][0] for p in PROMPTS]
    company, eng = serve(model, PROMPTS, max_batch=2)
    assert company == alone
    for p, out in zip(PROMPTS, alone):
        assert max(oracle_gaps(model, p, out)) <= MARGIN, (p, out)


@pytest.mark.parametrize("arch", ARCHS)
def test_alone_equals_reference_engine(model):
    ref_eng = RefServeEngine(model.ref_cfg, model.ref_plan, None,
                             model.ref_params, max_batch=4, max_seq=MAX_SEQ)
    ref_req = RefRequest(0, list(PROMPTS[0]), NEW)
    ref_eng.submit(ref_req)
    drain(ref_eng)
    out, _ = serve(model, [PROMPTS[0]])
    assert out[0] == ref_req.out


@pytest.mark.parametrize("arch", ARCHS)
def test_admission_zeroes_only_its_slot(model):
    """A reused slot starts from the zero state: admission zeros that
    slot's rows of every cache leaf and no other slot's."""
    eng = model.engine()
    eng.submit(Request(0, [3, 1, 4, 1, 5], 8))
    eng.step()
    eng.step()
    before = {n: leaf.clone() for n, leaf in eng.cache.items()}
    assert any(bool(leaf[:, 0].abs().sum() > 0)
               for n, leaf in before.items() if n != "pos")
    eng._prefill_slot(0, [])
    for name, leaf in eng.cache.items():
        if name == "pos":
            assert eng.cache["pos"].tolist() == [0] + before["pos"][
                1:].tolist()
            continue
        assert bool((leaf[:, 0] == 0).all()), name
        assert torch.equal(leaf[:, 1:], before[name][:, 1:]), name


@pytest.mark.parametrize("arch", ["dbrx_132b", "qwen3_moe_235b_a22b"])
def test_the_moe_decode_step_drops_nothing_at_eight_slots(model):
    """Eight slots: an expert gets at most 8 assignments a step (a token
    picks it once), against moe_capacity's 8 or more."""
    cfg = model.cfg
    assert moe.moe_capacity(8 * cfg.top_k, cfg.n_experts) >= 8
    eng = model.engine(max_batch=8)
    for i in range(10):
        eng.submit(Request(i, [i + 1, 2 * i + 3], 4))
    drain(eng)
    assert eng.dropped_decode_calls == 0


def test_dropped_decode_calls_counts_a_drop(monkeypatch):
    """The counter is read from the MoE layers' own dropped share: a zero
    router ties every expert, so both tokens of a step take experts 0 and
    1 (the lower first), and with the capacity forced to 1 each step
    drops."""
    cfg = get_smoke_config("qwen3_moe_235b_a22b")
    plan = plan_model(cfg, MESH1, ShapeConfig("serve", 8, 2, "decode"),
                      fsdp=False)
    params = lm.init_params(cfg, device="cpu")
    params["blocks"]["moe"]["router"].zero_()
    eng = ServeEngine(cfg, plan, None, params, max_batch=2, max_seq=8,
                      device="cpu")
    monkeypatch.setattr(moe, "moe_capacity", lambda n, e, f=1.5: 1)
    for i in range(2):
        eng.submit(Request(i, [i + 1], 2))
    drain(eng)
    assert eng.dropped_decode_calls == 2
