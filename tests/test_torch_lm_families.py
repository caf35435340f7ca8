"""The MoE, hybrid (Mamba2 + shared attention) and RWKV-6 families of the
port (``repro_torch.models.lm`` and ``repro_torch.layers``) against the
JAX package's, on the reference's own parameters carried across through
numpy, for the four smoke configs dbrx_132b, qwen3_moe_235b_a22b,
zamba2_7b and rwkv6_3b.

Tolerances are tests/test_torch_lm.py's: hidden states and logits within
rtol 2^-5 and atol 2^-4 element by element and a mean absolute difference
of 2^-6; the mean next-token loss within rtol 2^-8.

Routing. The router's top-k is a discrete choice: where two experts'
probabilities lie within a few bf16 steps of each other, the two packages'
rounding (held to the tolerances above) can pick different experts, and a
token that takes another expert moves by O(1). So every MoE comparison
runs the port on the routing of the side it is compared with: the
reference's choices are recorded (``jax.debug.callback``) and forced on
the port's ``moe.top_k_lowest_first``, after checking that the port's own
choice is as good within ``ROUTE_GAP``: at every rank, the source's
probability of the port's own pick lies within ``ROUTE_GAP`` of the
source's own pick's. ``ROUTE_GAP`` is 2^-5, RTOL applied to probabilities
(which lie below 1). A wrong softmax, tie order or top-k moves a pick by
far more. With the routing alike, ``moe_load`` and ``moe_dropped`` must
equal the reference's exactly.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.core.relshard import plan_model as ref_plan_model
from repro.layers import moe as ref_moe
from repro.models import lm as ref_lm
from repro.models.config import SHAPE_BY_NAME as REF_SHAPES
from repro_torch.configs import get_smoke_config
from repro_torch.core.relshard import plan_model
from repro_torch.layers import embedding as emb
from repro_torch.layers import moe
from repro_torch.models import lm
from repro_torch.models.config import SHAPE_BY_NAME, Family

MESH1 = (("data", 1), ("model", 1))
ARCHS = ["dbrx_132b", "qwen3_moe_235b_a22b", "zamba2_7b", "rwkv6_3b"]
MOE_ARCHS = ARCHS[:2]
RTOL, ATOL, MEAN_ATOL, LOSS_RTOL = 2 ** -5, 2 ** -4, 2 ** -6, 2 ** -8
ROUTE_GAP = 2 ** -5
B, S, S_DECODE = 2, 64, 16
#: the leaves ``cast_params`` keeps in fp32, and their init values
F32_INIT = {"A_log": 0.0, "dt_bias": -2.0, "D": 1.0, "decay_base": -4.0,
            "bonus_u": 0.0}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small tensors: the suite runs in
    parallel worker processes, and idle OpenMP threads spin between ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# ---------------------------------------------------------------------------
# Routing: recorded on one side, forced on the port
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recording_reference_routing(out: list):
    """Append (ids (N, k), probs (N, E)) of every reference routing call,
    in call order, to ``out``."""
    orig = ref_moe._route

    def route(params, x2d, n_experts, top_k):
        res = orig(params, x2d, n_experts, top_k)
        logits = (x2d @ params["router"].astype(jnp.bfloat16)).astype(
            jnp.float32)
        jax.debug.callback(
            lambda ids, p: out.append((np.asarray(ids), np.asarray(p))),
            res[1], jax.nn.softmax(logits, axis=-1), ordered=True)
        return res
    ref_moe._route = route
    try:
        yield out
    finally:
        ref_moe._route = orig


@contextlib.contextmanager
def recording_port_routing(out: list):
    """The same for the port's own routing calls."""
    orig = moe.top_k_lowest_first

    def top_k(probs, k):
        vals, ids = orig(probs, k)
        out.append((ids.cpu().numpy(), probs.cpu().numpy()))
        return vals, ids
    moe.top_k_lowest_first = top_k
    try:
        yield out
    finally:
        moe.top_k_lowest_first = orig


def pick_gap(own_ids, src_probs) -> float:
    """The largest, over tokens and ranks, of how far the source's
    probability of the port's pick lies below the source's own pick's."""
    srt = -np.sort(-src_probs, axis=-1)[:, :own_ids.shape[1]]
    return float(np.abs(np.take_along_axis(src_probs, own_ids, axis=1)
                        - srt).max())


@contextlib.contextmanager
def forcing_routing(recorded: list):
    """Give the port's routing calls, in order, the recorded choices, after
    checking each port choice is within ``ROUTE_GAP`` of the recorded.
    Yields a dict that counts the calls and the tokens whose own pick
    differed."""
    orig = moe.top_k_lowest_first
    queue = list(recorded)
    stats = {"calls": 0, "differed": 0, "largest_gap": 0.0}

    def top_k(probs, k):
        _, own = orig(probs, k)
        ids, src_probs = queue.pop(0)
        own = own.cpu().numpy()
        gap = pick_gap(own, src_probs)
        assert gap <= ROUTE_GAP, f"a pick {gap:.4f} below the source's"
        stats["calls"] += 1
        stats["differed"] += int((own != ids).any(axis=1).sum())
        stats["largest_gap"] = max(stats["largest_gap"], gap)
        ids = torch.from_numpy(np.array(ids)).to(device=probs.device,
                                       dtype=torch.int64)
        return probs.gather(-1, ids), ids
    moe.top_k_lowest_first = top_k
    try:
        yield stats
    finally:
        moe.top_k_lowest_first = orig
    assert not queue, f"{len(queue)} recorded routings were not used"


def reference_call(fn, *args, **kw):
    """Run a reference entry point, recording its routing calls."""
    routing = []
    with recording_reference_routing(routing):
        out = fn(*args, **kw)
        jax.block_until_ready(out)
        jax.effects_barrier()
    return out, routing


class Run:
    """One smoke config's inputs, the reference's params, its outputs and
    its routing."""

    def __init__(self, arch):
        self.arch = arch
        self.ref_cfg, self.cfg = ref_smoke(arch), get_smoke_config(arch)
        self.ref_plan = ref_plan_model(self.ref_cfg, MESH1,
                                       REF_SHAPES["train_4k"], fsdp=False)
        self.plan = plan_model(self.cfg, MESH1, SHAPE_BY_NAME["train_4k"],
                               fsdp=False)
        self.ref_params = ref_lm.init_params(self.ref_cfg,
                                             jax.random.PRNGKey(0))
        self.np_params = jax.tree.map(np.asarray, self.ref_params)
        self.params = lm.params_from_numpy(self.np_params, "cpu")
        rng = np.random.default_rng(10 + ARCHS.index(arch))
        self.tokens = rng.integers(0, self.cfg.vocab, (B, S)).astype(np.int32)
        toks = jnp.asarray(self.tokens)
        (self.hidden, self.aux), self.fwd_routing = reference_call(
            ref_lm.forward, self.ref_params, self.ref_cfg, self.ref_plan,
            None, toks)
        self.prefill, self.prefill_routing = reference_call(
            ref_lm.prefill, self.ref_params, self.ref_cfg, self.ref_plan,
            None, toks)
        (self.loss, self.metrics), self.loss_routing = reference_call(
            ref_lm.train_loss, self.ref_params, self.ref_cfg, self.ref_plan,
            None, {"tokens": toks})
        # one compiled step: its routing callbacks, traced while recording,
        # append every call's choices to the same list, in call order
        step_fn = jax.jit(lambda p, tk, c: ref_lm.decode_step(
            p, self.ref_cfg, self.ref_plan, None, tk, c))
        cache = ref_lm.init_cache(self.ref_cfg, B, S_DECODE)
        self.decode_logits, self.decode_routing = [], []
        with recording_reference_routing(self.decode_routing):
            for step in range(S_DECODE):
                logits, cache = step_fn(
                    self.ref_params, jnp.asarray(self.tokens[:, step:step + 1]),
                    cache)
                self.decode_logits.append(np.asarray(logits))
            jax.effects_barrier()
        self.decode_cache = jax.tree.map(np.asarray, cache)


_RUNS = {}


@pytest.fixture
def run(arch):
    if arch not in _RUNS:
        _RUNS[arch] = Run(arch)
    return _RUNS[arch]


def routed_like(run, recorded):
    """The port forced to ``recorded`` for MoE configs, else a no-op."""
    if run.cfg.is_moe:
        return forcing_routing(recorded)
    return contextlib.nullcontext({"calls": 0})


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
    """Every random leaf's spread within 10% of the reference's; every
    constant leaf (norm scales, SSM and RWKV constants) equal to it."""
    port = flat(lm.init_params(run.cfg, seed=1, device="cpu"))
    ref = flat(run.np_params)
    for path, leaf in port.items():
        r = ref[path]
        if float(r.std()) == 0.0:
            assert np.array_equal(leaf.numpy(), r), path
            continue
        assert float(leaf.std()) == pytest.approx(float(r.std()), rel=0.1)
        assert abs(float(leaf.mean())) < 0.1 * float(r.std())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_analytic(run):
    """The analytic count, within 2% of the leaves' (the MoE and RWKV
    formulas; the hybrid's counts one shared block)."""
    actual = sum(x.numel() for x in flat(run.params).values())
    assert abs(actual - run.cfg.param_count()) / actual < 0.02


# ---------------------------------------------------------------------------
# Forward, prefill, train loss and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_equals_reference(run):
    with routed_like(run, run.fwd_routing) as stats:
        port, aux = lm.forward(run.params, run.cfg, run.plan, None,
                               t(run.tokens))
    assert port.dtype == torch.bfloat16
    assert port.shape == (B, S, run.cfg.d_model)
    assert_close(port.float(), np.asarray(run.hidden, np.float32))
    if not run.cfg.is_moe:
        assert aux.moe_load is None and run.aux.moe_load is None
        assert float(aux.moe_aux_loss) == float(aux.moe_dropped) == 0.0
        return
    assert stats["calls"] == run.cfg.n_layers
    assert aux.moe_load.dtype == torch.int32
    assert np.array_equal(aux.moe_load.numpy(), np.asarray(run.aux.moe_load))
    assert float(aux.moe_dropped) == float(run.aux.moe_dropped)
    assert float(aux.moe_aux_loss) == pytest.approx(
        float(run.aux.moe_aux_loss), rel=LOSS_RTOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_load_is_a_runtime_statistic(run):
    """tests/test_models.py's check, on the port's own routing: every
    layer routes every token top_k times."""
    routing = []
    with recording_port_routing(routing):
        _, aux = lm.forward(run.params, run.cfg, run.plan, None,
                            t(run.tokens))
    assert aux.moe_load.shape == (run.cfg.n_layers, run.cfg.n_experts)
    assert (aux.moe_load.sum(dim=1) == B * S * run.cfg.top_k).all()
    assert 0.0 <= float(aux.moe_dropped) < 1.0
    # unforced, the port's picks are the reference's but at near-ties
    for (own, _), (_, src_probs) in zip(routing, run.fwd_routing):
        assert pick_gap(own, src_probs) <= ROUTE_GAP


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_equal_reference(run):
    with routed_like(run, run.prefill_routing):
        port = lm.prefill(run.params, run.cfg, run.plan, None,
                          t(run.tokens))
    assert port.dtype == torch.float32 and port.shape == (B, run.cfg.vocab)
    assert_close(port, run.prefill)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_equals_reference(run):
    with routed_like(run, run.loss_routing):
        port, metrics = lm.train_loss(run.params, run.cfg, run.plan, None,
                                      {"tokens": t(run.tokens)})
    assert float(port) == pytest.approx(float(run.loss), rel=LOSS_RTOL)
    assert float(metrics["ce_loss"]) == pytest.approx(
        float(run.metrics["ce_loss"]), rel=LOSS_RTOL)
    assert float(metrics["moe_dropped"]) == float(run.metrics["moe_dropped"])
    assert ("moe_load" in metrics) == ("moe_load" in run.metrics)
    if "moe_load" in metrics:
        assert np.array_equal(metrics["moe_load"].numpy(),
                              np.asarray(run.metrics["moe_load"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_equal_reference(run):
    """Every step's logits, and every cache leaf written, on the
    reference's params."""
    cache = lm.init_cache(run.cfg, B, S_DECODE, device="cpu")
    assert sorted(cache) == sorted(run.decode_cache)
    with routed_like(run, run.decode_routing):
        for step in range(S_DECODE):
            port, cache = lm.decode_step(
                run.params, run.cfg, run.plan, None,
                t(run.tokens[:, step:step + 1]), cache)
            assert_close(port, run.decode_logits[step])
    for name, ref in run.decode_cache.items():
        assert cache[name].dtype == {
            "pos": torch.int32, "s": torch.float32,
            "ssm_s": torch.float32}.get(name, torch.bfloat16)
        if name == "pos":
            assert np.array_equal(cache[name].numpy(), ref)
        else:
            assert_close(cache[name].float(), ref.astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(run, monkeypatch):
    """tests/test_models.py's check on the port with its own random params:
    teacher-forced decode reproduces the full-sequence logits (rtol 0.2,
    atol 0.25, the reference's tolerance): the recurrent states, conv
    tails and shared-attention K/V carried by the cache against the
    chunked forms. An MoE forward over B*S tokens drops the assignments
    past an expert's capacity, which a decode step over B tokens does not,
    so for MoE configs both run at the dropless capacity (every
    assignment), and decode runs on forward's routing (checked as above)."""
    cfg, plan = run.cfg, plan_model(run.cfg, MESH1,
                                    SHAPE_BY_NAME["decode_32k"], fsdp=False)
    params = lm.init_params(cfg, seed=2, device="cpu")
    tokens = t(run.tokens[:, :S_DECODE])
    if cfg.is_moe:
        monkeypatch.setattr(moe, "moe_capacity",
                            lambda n, n_experts, factor=1.5: n)
    routing = []
    with recording_port_routing(routing):
        hidden, aux = lm.forward(params, cfg, plan, None, tokens)
    full = emb.lm_head_logits(params["head"], hidden, mesh=None,
                              batch_axes=plan.batch_axes,
                              model_axis=plan.model_axis,
                              strategy="replicate")
    per_step = []
    for step in range(S_DECODE):
        for ids, probs in routing:
            k, E = ids.shape[1], probs.shape[1]
            per_step.append(
                (ids.reshape(B, S_DECODE, k)[:, step],
                 probs.reshape(B, S_DECODE, E)[:, step]))
    cache = lm.init_cache(cfg, B, max_seq=S_DECODE, device="cpu")
    outs = []
    with routed_like(run, per_step):
        for step in range(S_DECODE):
            logits, cache = lm.decode_step(params, cfg, plan, None,
                                           tokens[:, step:step + 1], cache)
            outs.append(logits)
    assert float(aux.moe_dropped) == 0.0
    np.testing.assert_allclose(torch.stack(outs, dim=1).numpy(),
                               full.numpy(), rtol=0.2, atol=0.25)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_copy_gives_the_same_logits(run):
    """The serving engine's copy: the same logits, bit for bit, as the fp32
    tree cast at every use. The leaves the reference reads in f32 are moved
    off their init values (0, -2, 1, -4, 0, which bf16 holds exactly) by
    amounts bf16 cannot hold, so a copy that rounded them would show."""
    rng = np.random.default_rng(3)
    params = lm.params_from_numpy(run.np_params, "cpu")
    moved = 0
    for path, leaf in flat(params).items():
        if path[-1] in F32_INIT:
            assert torch.all(leaf == F32_INIT[path[-1]])
            leaf += t((0.1 + 0.01 * rng.random(leaf.shape)).astype(
                np.float32))
            assert not torch.equal(leaf, leaf.bfloat16().float())
            moved += 1
    assert moved == {Family.HYBRID: 3, Family.SSM: 2}.get(run.cfg.family, 0)
    copy = lm.cast_params(params)
    for path, leaf in flat(copy).items():
        assert leaf.dtype == (torch.float32 if path[-1] in lm.F32_LEAVES
                              else torch.bfloat16), path
    tokens = t(run.tokens)
    ref = lm.prefill(params, run.cfg, run.plan, None, tokens)
    port = lm.prefill(copy, run.cfg, run.plan, None, tokens)
    assert torch.equal(port, ref)
    cache_a = lm.init_cache(run.cfg, B, 4, device="cpu")
    cache_b = lm.init_cache(run.cfg, B, 4, device="cpu")
    for step in range(4):
        tok = tokens[:, step:step + 1]
        a, cache_a = lm.decode_step(params, run.cfg, run.plan, None, tok,
                                    cache_a)
        b, cache_b = lm.decode_step(copy, run.cfg, run.plan, None, tok,
                                    cache_b)
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# A one-rank mesh; without a card, init raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "zamba2_7b",
                                  "rwkv6_3b"])
def test_a_mesh_raises(arch):
    """A mesh no longer raises: on a one-rank mesh the families' forward
    and decode equal mesh=None within one bf16 rounding step."""
    from tests.helpers.lm_shard import one_rank_mesh
    cfg = get_smoke_config(arch)
    plan = plan_model(cfg, MESH1, SHAPE_BY_NAME["train_4k"], fsdp=False)
    params = lm.init_params(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (1, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(5))
    outs = []
    with torch.no_grad(), one_rank_mesh() as mesh:
        for m in (None, mesh):
            h, _ = lm.forward(params, cfg, plan, m, tokens)
            lg, _ = lm.decode_step(params, cfg, plan, m, tokens[:, :1],
                                   lm.init_cache(cfg, 1, 8, device="cpu",
                                                 mesh=m, plan=plan))
            outs.append((h.float(), lg))
    for a, b in zip(outs[1], outs[0]):
        torch.testing.assert_close(a, b, rtol=2 ** -7, atol=2 ** -6)


@pytest.mark.parametrize("arch", ARCHS)
def test_without_a_card_init_raises(arch, monkeypatch):
    cfg = get_smoke_config(arch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_cache(cfg, 2, 8)
    cache = lm.init_cache(cfg, 2, 8, device="cpu")
    assert all(leaf.device.type == "cpu" and leaf.shape[
        0 if name == "pos" else 1] == 2 for name, leaf in cache.items())


def test_hybrid_cache_has_one_attention_row_per_application():
    """zamba2's smoke config: 5 Mamba blocks, shared attention after
    blocks 2 and 4 (not after the fifth), so 2 K/V rows."""
    cfg = get_smoke_config("zamba2_7b")
    assert (cfg.n_layers, cfg.attn_every) == (5, 2)
    cache = lm.init_cache(cfg, 3, 8, device="cpu")
    ref = ref_lm.init_cache(ref_smoke("zamba2_7b"), 3, 8)
    for name, leaf in cache.items():
        assert tuple(leaf.shape) == ref[name].shape, name
    assert cache["attn_k"].shape[0] == 2


def test_decode_state_is_written_in_place():
    """decode_step writes the new states into the cache's own tensors, so
    the engine's per-slot views update the large cache."""
    for arch in ("zamba2_7b", "rwkv6_3b"):
        cfg = get_smoke_config(arch)
        plan = plan_model(cfg, MESH1, SHAPE_BY_NAME["decode_32k"],
                          fsdp=False)
        params = lm.init_params(cfg, device="cpu")
        cache = lm.init_cache(cfg, 2, 8, device="cpu")
        view = {n: leaf[1:2] if n == "pos" else leaf[:, 1:2]
                for n, leaf in cache.items()}
        _, out = lm.decode_step(params, cfg, plan, None,
                                torch.tensor([[5]]), view)
        for name, leaf in cache.items():
            if name in ("pos", "attn_k", "attn_v"):
                continue
            assert out[name].data_ptr() == view[name].data_ptr()
            assert bool(leaf[:, 1].abs().sum() > 0), name
            assert bool(leaf[:, 0].abs().sum() == 0), name
