"""The port's serving engine (``repro_torch.serving.engine``): every case of
tests/test_serving.py, its tokens against the reference engine's and
against greedy decoding through ``forward`` (the oracle), and the
reference engine's cross-slot divergence, pinned.

The oracle is read teacher-forced: at every position of a request's
output, ``forward`` over its prompt and the tokens before that position
must give the emitted token a logit within ``MARGIN`` of its largest
(2^-4, eight bf16 steps at 1.0, more than the decode and forward paths'
rounding differs by). So wherever the oracle's top-2 margin exceeds
``MARGIN``, the token is the oracle's argmax exactly."""

import collections
import dataclasses

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
from repro_torch.models import lm
from repro_torch.models.config import ShapeConfig
from repro_torch.serving.engine import Request, ServeEngine

MESH1 = (("data", 1), ("model", 1))
MARGIN = 2 ** -4
#: tests/test_serving.py's engine config
SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=128)


def small_cfg():
    return dataclasses.replace(get_smoke_config("tinyllama_1_1b"), **SMALL)


@pytest.fixture(scope="module")
def reference():
    cfg = dataclasses.replace(ref_smoke("tinyllama_1_1b"), **SMALL)
    shape = RefShapeConfig("serve", 64, 4, "decode")
    plan = ref_plan_model(cfg, MESH1, shape, fsdp=False)
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, plan, params


@pytest.fixture(scope="module")
def model(reference):
    """The port's config, plan and the reference's params carried across."""
    cfg = small_cfg()
    shape = ShapeConfig("serve", 64, 4, "decode")
    plan = plan_model(cfg, MESH1, shape, fsdp=False)
    params = lm.params_from_numpy(jax.tree.map(np.asarray, reference[2]),
                                  "cpu")
    return cfg, plan, params, shape


@pytest.fixture(scope="module")
def engine(model):
    cfg, plan, params, shape = model
    return ServeEngine(cfg, plan, None, params, max_batch=4, max_seq=64,
                       mesh_axes=MESH1, shape=shape, device="cpu")


def new_engine(model, max_batch=4, max_seq=64):
    cfg, plan, params, shape = model
    return ServeEngine(cfg, plan, None, params, max_batch=max_batch,
                       max_seq=max_seq, device="cpu")


def drain(eng, limit=500):
    steps = 0
    while (eng.queue or eng.occupancy()) and steps < limit:
        eng.step()
        steps += 1
    assert steps < limit
    return steps


def oracle_gaps(model, prompt, out):
    """For each emitted token, how far its logit lies below the largest of
    the oracle's: the last position's logits of ``forward`` over the
    prompt and the tokens emitted before it."""
    cfg, plan, params, _ = model
    gaps = []
    for j, tok in enumerate(out):
        seq = torch.tensor([list(prompt) + list(out[:j])])
        logits = lm.prefill(params, cfg, plan, None, seq)[0]
        gaps.append(float(logits.max() - logits[tok]))
    return gaps


def follows_oracle(model, prompt, out) -> bool:
    return all(g <= MARGIN for g in oracle_gaps(model, prompt, out))


# ---------------------------------------------------------------------------
# tests/test_serving.py, case by case, on the port (one shared engine)
# ---------------------------------------------------------------------------

def test_requests_complete(engine):
    for rid in range(6):
        engine.submit(Request(rid, prompt=[1 + rid, 2], max_new_tokens=5))
    reqs = list(engine.queue)
    drain(engine)
    for r in reqs:
        assert r.done and len(r.out) == 5
        assert all(0 <= t < 128 for t in r.out)


def test_continuous_batching_overlaps(engine):
    reqs = [Request(100 + i, prompt=[3, 4], max_new_tokens=3)
            for i in range(9)]
    for r in reqs:
        engine.submit(r)
    max_occ = 0
    steps = 0
    while (engine.queue or engine.occupancy()) and steps < 500:
        engine.step()
        max_occ = max(max_occ, engine.occupancy())
        steps += 1
    assert max_occ <= 4
    assert all(r.done for r in reqs)


def test_many_request_admission_order(engine):
    assert isinstance(engine.queue, collections.deque)
    reqs = [Request(200 + i, prompt=[2], max_new_tokens=3)
            for i in range(25)]
    for r in reqs:
        engine.submit(r)
    admitted = []
    seen = set()
    steps = 0
    while (engine.queue or engine.occupancy()) and steps < 500:
        engine.step()
        for slot in engine.slots:
            if slot is not None and slot.rid not in seen:
                seen.add(slot.rid)
                admitted.append(slot.rid)
        steps += 1
    assert all(r.done for r in reqs)
    assert admitted == sorted(admitted)


def test_maybe_replan_returns_plan_or_none(engine):
    engine.submit(Request(999, prompt=[5], max_new_tokens=2))
    engine.step()
    out = engine.maybe_replan()
    assert out is None or out.embed_strategy in ("replicate",
                                                 "vocab_parallel")


# ---------------------------------------------------------------------------
# Tokens against the reference engine and the oracle
# ---------------------------------------------------------------------------

def test_alone_equals_reference_engine(reference, model):
    cfg, plan, params = reference
    ref_eng = RefServeEngine(cfg, plan, None, params, max_batch=4,
                             max_seq=64)
    ref_req = RefRequest(0, [7, 9, 11], 6)
    ref_eng.submit(ref_req)
    drain(ref_eng)
    eng = new_engine(model)
    req = Request(0, [7, 9, 11], 6)
    eng.submit(req)
    drain(eng)
    assert ref_req.out == [72, 125, 118, 48, 48, 48]
    assert req.out == ref_req.out
    assert follows_oracle(model, req.prompt, req.out)


def test_mixed_batch_equals_oracle(model):
    """More requests than slots, prompts of other lengths, slots reused:
    every request's tokens are the oracle's."""
    prompts = [[1, 2, 3, 4, 5], [7, 9, 11], [2], [100, 3, 3, 3, 3, 3, 9],
               [5, 6], [40, 41, 42], [9]]
    eng = new_engine(model, max_batch=3, max_seq=24)
    reqs = [Request(i, p, 8) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    drain(eng)
    for r in reqs:
        assert follows_oracle(model, r.prompt, r.out), r


def test_batch_company_does_not_change_tokens(model):
    """A request's tokens, bit for bit, whatever shares the batch."""
    alone = new_engine(model)
    req = Request(0, [7, 9, 11], 6)
    alone.submit(req)
    drain(alone)
    mixed = new_engine(model)
    first = Request(1, [1, 2, 3, 4, 5], 6)
    again = Request(0, [7, 9, 11], 6)
    for r in (first, Request(2, [4, 4], 20), again):
        mixed.submit(r)
    drain(mixed)
    assert again.out == req.out


def test_reference_engine_divergence_is_pinned(reference, model):
    """The reference engine (repro/serving/engine.py) gives request 0 other
    tokens when request 1 is admitted first: admission advances and writes
    every slot's K/V, and a reused slot is never reset. The port's engine
    gives the oracle's tokens. ROADMAP.md §3 records the fault."""
    cfg, plan, params = reference
    ref_eng = RefServeEngine(cfg, plan, None, params, max_batch=4,
                             max_seq=64)
    ref_first = RefRequest(1, [1, 2, 3, 4, 5], 6)
    ref_req = RefRequest(0, [7, 9, 11], 6)
    ref_eng.submit(ref_first)
    ref_eng.submit(ref_req)
    drain(ref_eng)
    assert ref_req.out == [124] * 6
    assert np.asarray(ref_eng.cache["pos"]).tolist() == [12] * 4

    eng = new_engine(model)
    first = Request(1, [1, 2, 3, 4, 5], 6)
    req = Request(0, [7, 9, 11], 6)
    eng.submit(first)
    eng.submit(req)
    drain(eng)
    for r, ref_r in ((req, ref_req), (first, ref_first)):
        assert follows_oracle(model, r.prompt, r.out)
        assert max(oracle_gaps(model, r.prompt, ref_r.out)) > 0.5
    assert req.out == [72, 125, 118, 48, 48, 48]


# ---------------------------------------------------------------------------
# Slots, limits and devices
# ---------------------------------------------------------------------------

def test_admission_touches_only_its_slot(model):
    eng = new_engine(model)
    eng.submit(Request(0, [3, 1, 4, 1, 5], 10))
    eng.step()
    k, v = eng.cache["k"].clone(), eng.cache["v"].clone()
    pos = eng.cache["pos"].clone()
    eng._prefill_slot(2, [9, 2, 6])
    assert eng.cache["pos"].tolist() == [pos[0], pos[1], 3, pos[3]]
    for i in (0, 1, 3):
        assert torch.equal(eng.cache["k"][:, i], k[:, i])
        assert torch.equal(eng.cache["v"][:, i], v[:, i])
    assert not torch.equal(eng.cache["k"][:, 2, :3], k[:, 2, :3])


def test_submit_refuses_what_does_not_fit(model):
    eng = new_engine(model, max_seq=16)
    eng.submit(Request(0, [1] * 10, 6))
    with pytest.raises(ValueError, match="exceed max_seq"):
        eng.submit(Request(1, [1] * 10, 7))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(2, [], 4))
    assert [r.rid for r in eng.queue] == [0]


def test_a_full_cache_decodes_like_the_oracle(model):
    """A request that fills max_seq exactly, in a reused slot."""
    eng = new_engine(model, max_batch=1, max_seq=12)
    reqs = [Request(0, [5, 5, 5, 5], 8), Request(1, [8, 1, 3], 9)]
    for r in reqs:
        eng.submit(r)
    drain(eng)
    for r in reqs:
        assert len(r.prompt) + r.max_new_tokens == 12
        assert follows_oracle(model, r.prompt, r.out)


def test_without_a_card_the_engine_raises(model, monkeypatch):
    cfg, plan, params, _ = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, plan, None, params, max_batch=2, max_seq=8)
    eng = ServeEngine(cfg, plan, None, params, max_batch=2, max_seq=8,
                      device="cpu")
    assert eng.cache["k"].device.type == "cpu"
    assert all(w.dtype == torch.bfloat16 for w in
               (eng.weights["head"]["table"],
                eng.weights["blocks"]["attn"]["w_q"]))
