"""The port's MoE, SSM (Mamba2 SSD) and RWKV-6 layers against the JAX
package's, on the reference's own parameters and on the same bf16 inputs,
made from numpy seeds.

Tolerances are tests/test_torch_lm.py's (rtol 2^-5, atol 2^-4, mean
2^-6); with the same inputs a single layer differs by a bf16 step or two,
where the two libraries sum products in other orders.

The router. Its logits are bf16 values, rounded from sums the two
packages take in other orders, so on the same inputs a logit l differs by
at most one bf16 step, at most 2^-7 * |l| <= 2^-7 * M, M the token's
largest |l|. Since p_a / p_b = exp(l_a - l_b), two experts a, b can trade
places only if l_a - l_b <= 2^-6 * M, that is p_a - p_b <= 2^-6 * M * p_a
(``router_threshold``). Wherever the gap between a token's k-th and
(k+1)-th probability exceeds it, the port chooses the reference's experts;
wherever every gap among its first k + 1 does, in the reference's order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import moe as ref_moe
from repro.layers import rwkv as ref_rwkv
from repro.layers import ssm as ref_ssm
from repro_torch.layers import common as cm
from repro_torch.layers import moe
from repro_torch.layers import rwkv
from repro_torch.layers import ssm
from repro_torch.models import lm

RTOL, ATOL, MEAN_ATOL = 2 ** -5, 2 ** -4, 2 ** -6

# the reference's layers, compiled once a shape (eager, every scan and
# primitive compiles on its own)
ref_ssm_apply = jax.jit(ref_ssm.ssm_apply,
                        static_argnames=("n_state", "n_heads", "chunk"))
ref_ssm_decode = jax.jit(ref_ssm.ssm_decode,
                         static_argnames=("n_state", "n_heads"))
ref_time_mix = jax.jit(ref_rwkv.rwkv_time_mix,
                       static_argnames=("head_dim", "chunk"))
ref_rwkv_decode = jax.jit(ref_rwkv.rwkv_decode, static_argnames=("head_dim",))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small tensors: the suite runs in
    parallel worker processes, and idle OpenMP threads spin between ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_close(port, ref, rtol=RTOL, atol=ATOL, mean_atol=MEAN_ATOL):
    port = np.asarray(port.float() if isinstance(port, torch.Tensor)
                      else port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)
    assert np.abs(port - ref).mean() <= mean_atol


def both(params):
    """The reference's params tree and the port's copy of it."""
    return params, lm.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")


def bf16_input(seed, shape, scale=1.0):
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# SiLU
# ---------------------------------------------------------------------------

def test_silu_has_the_reference_bits():
    """cm.silu rounds where jax.nn.silu does in bf16 (a fused SiLU rounds
    once and differs by a bf16 step on ~40% of these inputs)."""
    xj, xt = bf16_input(0, (8192,), 3.0)
    ref = np.asarray(jax.nn.silu(xj), np.float32)
    assert np.array_equal(cm.silu(xt).float().numpy(), ref)
    fused = torch.nn.functional.silu(xt).float().numpy()
    assert (fused != ref).mean() > 0.2


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------

D_MODEL, N_STATE, N_HEADS = 64, 8, 2


@pytest.fixture(scope="module")
def ssm_params():
    return both(ref_ssm.ssm_init(jax.random.PRNGKey(1), D_MODEL, N_STATE,
                                 N_HEADS))


@pytest.mark.parametrize("S,chunk", [(64, 16), (96, 32), (40, 64),
                                     (48, 16)])
def test_ssm_apply_equals_reference(ssm_params, S, chunk):
    """Several chunks (4, 3, 3) and one chunk shorter than ``chunk``: the
    output and the final state (f32 state, post-conv tail)."""
    ref_p, port_p = ssm_params
    xj, xt = bf16_input(S + chunk, (2, S, D_MODEL))
    ref_y, ref_st = ref_ssm_apply(ref_p, xj, n_state=N_STATE,
                                      n_heads=N_HEADS, chunk=chunk)
    y, st = ssm.ssm_apply(port_p, xt, n_state=N_STATE, n_heads=N_HEADS,
                          chunk=chunk)
    assert y.dtype == torch.bfloat16 and st.s.dtype == torch.float32
    assert_close(y, ref_y)
    assert_close(st.s, ref_st.s)
    assert_close(st.conv, ref_st.conv)


@pytest.mark.parametrize("S,chunk", [(257, 128), (41, 16), (67, 32)])
def test_ssm_apply_rejects_the_lengths_the_reference_rejects(ssm_params, S,
                                                             chunk):
    ref_p, port_p = ssm_params
    xj, xt = bf16_input(0, (1, S, D_MODEL))
    with pytest.raises(AssertionError):
        ref_ssm_apply(ref_p, xj, n_state=N_STATE, n_heads=N_HEADS,
                          chunk=chunk)
    with pytest.raises(ValueError, match="does not divide"):
        ssm.ssm_apply(port_p, xt, n_state=N_STATE, n_heads=N_HEADS,
                      chunk=chunk)


def test_ssm_decode_equals_reference(ssm_params):
    """Eight steps from a nonzero state and conv tail, each step's input
    the reference's: output and state."""
    ref_p, port_p = ssm_params
    rng = np.random.default_rng(4)
    s0 = rng.standard_normal((2, N_HEADS, 2 * D_MODEL // N_HEADS,
                              N_STATE)).astype(np.float32)
    c0 = rng.standard_normal((2, 2 * D_MODEL, ssm.CONV_K - 1)).astype(
        np.float32)
    ref_st = ref_ssm.SSMState(jnp.asarray(s0),
                              jnp.asarray(c0).astype(jnp.bfloat16))
    st = ssm.SSMState(torch.from_numpy(s0),
                      torch.from_numpy(c0).to(torch.bfloat16))
    for step in range(8):
        xj, xt = bf16_input(10 + step, (2, 1, D_MODEL))
        ref_y, ref_st = ref_ssm_decode(ref_p, xj, ref_st,
                                           n_state=N_STATE, n_heads=N_HEADS)
        y, st = ssm.ssm_decode(port_p, xt, st, n_state=N_STATE,
                               n_heads=N_HEADS)
        assert_close(y, ref_y)
        assert_close(st.s, ref_st.s)
        assert np.array_equal(st.conv.float().numpy(),
                              np.asarray(ref_st.conv, np.float32))


def test_ssm_chunks_do_not_leak_inf_times_zero():
    """Strong decays make exp(cum_t - cum_s) overflow above the diagonal;
    the port drops it with where(), as the reference does, and stays
    finite."""
    params = ref_ssm.ssm_init(jax.random.PRNGKey(2), D_MODEL, N_STATE,
                              N_HEADS)
    params["A_log"] = jnp.full((N_HEADS,), 4.0)
    ref_p, port_p = both(params)
    xj, xt = bf16_input(5, (1, 128, D_MODEL))
    y, _ = ssm.ssm_apply(port_p, xt, n_state=N_STATE, n_heads=N_HEADS,
                         chunk=128)
    ref_y, _ = ref_ssm_apply(ref_p, xj, n_state=N_STATE,
                                 n_heads=N_HEADS, chunk=128)
    assert bool(torch.isfinite(y.float()).all())
    assert_close(y, ref_y)


# ---------------------------------------------------------------------------
# RWKV
# ---------------------------------------------------------------------------

HEAD = 16


@pytest.fixture(scope="module")
def rwkv_params():
    params = ref_rwkv.rwkv_init(jax.random.PRNGKey(3), D_MODEL, HEAD)
    # off the init constants, so that the bonus and the base decay matter
    rng = np.random.default_rng(6)
    params["bonus_u"] = jnp.asarray(
        0.5 * rng.standard_normal((D_MODEL // HEAD, HEAD)), jnp.float32)
    params["decay_base"] = jnp.asarray(
        -3.0 + rng.standard_normal(D_MODEL), jnp.float32)
    return both(params)


def rwkv_state(seed, B=2):
    rng = np.random.default_rng(seed)
    s = (0.3 * rng.standard_normal((B, D_MODEL // HEAD, HEAD, HEAD))).astype(
        np.float32)
    x = rng.standard_normal((B, D_MODEL)).astype(np.float32)
    return (ref_rwkv.RWKVState(jnp.asarray(s),
                               jnp.asarray(x).astype(jnp.bfloat16)),
            rwkv.RWKVState(torch.from_numpy(s),
                           torch.from_numpy(x).to(torch.bfloat16)))


@pytest.mark.parametrize("S,chunk", [(128, 32), (96, 32), (24, 64),
                                     (64, 64)])
def test_rwkv_time_mix_equals_reference(rwkv_params, S, chunk):
    """Several chunks (4, 3), one short chunk and one whole one, from a
    nonzero state: output, final state and token-shift input."""
    ref_p, port_p = rwkv_params
    ref_st, st = rwkv_state(S)
    xj, xt = bf16_input(S + 1, (2, S, D_MODEL))
    ref_y, ref_st = ref_time_mix(ref_p, xj, ref_st, head_dim=HEAD,
                                           chunk=chunk)
    y, st = rwkv.rwkv_time_mix(port_p, xt, st, head_dim=HEAD, chunk=chunk)
    assert y.dtype == torch.bfloat16 and st.s.dtype == torch.float32
    assert_close(y, ref_y)
    assert_close(st.s, ref_st.s)
    assert torch.equal(st.x_prev, xt[:, -1])


@pytest.mark.parametrize("S,chunk", [(129, 64), (65, 32)])
def test_rwkv_time_mix_rejects_the_lengths_the_reference_rejects(
        rwkv_params, S, chunk):
    ref_p, port_p = rwkv_params
    ref_st, st = rwkv_state(0, B=1)
    xj, xt = bf16_input(0, (1, S, D_MODEL))
    with pytest.raises(AssertionError):
        ref_time_mix(ref_p, xj, ref_st, head_dim=HEAD, chunk=chunk)
    with pytest.raises(ValueError, match="does not divide"):
        rwkv.rwkv_time_mix(port_p, xt, st, head_dim=HEAD, chunk=chunk)


def test_rwkv_decode_and_channel_mix_equal_reference(rwkv_params):
    ref_p, port_p = rwkv_params
    ref_st, st = rwkv_state(7)
    for step in range(8):
        xj, xt = bf16_input(20 + step, (2, 1, D_MODEL))
        ref_y, ref_st = ref_rwkv_decode(ref_p, xj, ref_st,
                                             head_dim=HEAD)
        y, st = rwkv.rwkv_decode(port_p, xt, st, head_dim=HEAD)
        assert_close(y, ref_y)
        assert_close(st.s, ref_st.s)
    cmp = ref_rwkv.channel_mix_init(jax.random.PRNGKey(8), D_MODEL, 128)
    ref_c, port_c = both(cmp)
    xj, xt = bf16_input(30, (2, 16, D_MODEL))
    pj, pt = bf16_input(31, (2, 16, D_MODEL))
    assert_close(rwkv.channel_mix(port_c, xt, pt),
                 ref_rwkv.channel_mix(ref_c, xj, pj))


def test_rwkv_decode_continues_time_mix(rwkv_params):
    """The chunked form's final state, carried into decode steps, gives the
    chunked form's outputs over the longer sequence (rtol 0.2, atol 0.25,
    tests/test_models.py's tolerance)."""
    _, port_p = rwkv_params
    _, st0 = rwkv_state(9)
    _, xt = bf16_input(40, (2, 72, D_MODEL))
    full, _ = rwkv.rwkv_time_mix(port_p, xt, st0, head_dim=HEAD, chunk=64)
    _, st = rwkv.rwkv_time_mix(port_p, xt[:, :64], st0, head_dim=HEAD,
                               chunk=64)
    for i in range(64, 72):
        y, st = rwkv.rwkv_decode(port_p, xt[:, i:i + 1], st, head_dim=HEAD)
        np.testing.assert_allclose(y.float().numpy(),
                                   full[:, i:i + 1].float().numpy(),
                                   rtol=0.2, atol=0.25)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_params(seed, d, ff, E, skew=0.0):
    params = ref_moe.moe_init(jax.random.PRNGKey(seed), d, ff, E)
    if skew:
        # a router column tilted toward expert 0, so that it overflows
        params["router"] = params["router"].at[:, 0].add(skew)
    return both(params)


def moe_call(module, params, x, E, k, cf):
    return module.moe_apply(params, x, mesh=None, batch_axes=(),
                            model_axis="model", n_experts=E, top_k=k,
                            strategy="replicate", capacity_factor=cf)


def reference_moe(params, x, E, k, cf):
    """The reference's replicated path, compiled afresh, and the expert ids
    its router chose (recorded through ``jax.debug.callback`` while it is
    traced)."""
    chosen = []
    route = ref_moe._route

    def recorded(p, x2d, n_experts, top_k):
        out = route(p, x2d, n_experts, top_k)
        jax.debug.callback(lambda ids: chosen.append(np.array(ids)), out[1])
        return out
    ref_moe._route = recorded
    try:
        y, aux = jax.jit(lambda p, xx: moe_call(ref_moe, p, xx, E, k, cf))(
            params, x)
        jax.block_until_ready(y)
        jax.effects_barrier()
    finally:
        ref_moe._route = route
    assert len(chosen) == 1
    return y, aux, chosen[0]


def port_moe_on(ids, params, x, E, k, cf):
    """The port's replicated path on the given expert ids; returns (y, aux,
    the ids its own router chose)."""
    own = []
    top_k = moe.top_k_lowest_first

    def forced(probs, kk):
        own.append(top_k(probs, kk)[1].numpy())
        chosen = torch.from_numpy(ids).long()
        return probs.gather(-1, chosen), chosen
    moe.top_k_lowest_first = forced
    try:
        y, aux = moe_call(moe, params, x, E, k, cf)
    finally:
        moe.top_k_lowest_first = top_k
    return y, aux, own[0]


@pytest.mark.parametrize("E,k,cf,skew", [
    (8, 2, 1.5, 0.0), (16, 4, 1.5, 0.0), (8, 2, 0.5, 0.0), (8, 2, 1.5, 0.3),
    (32, 8, 1.0, 0.2)])
def test_moe_dispatch_and_combine_equal_reference(E, k, cf, skew):
    """The same bf16 inputs through both packages' replicated path, the
    port's dispatch and combine on the reference's expert ids, with and
    without dropped assignments (a small capacity factor, a tilted
    router): the load and the dropped share equal the reference's exactly
    and the output is within tolerance. Which assignments capacity drops
    is the earliest-kept choice of the reference's stable grouping, or the
    outputs would differ by O(1). The port's own ids differ from the
    reference's only within ``router_threshold``."""
    d, ff, B, S = 64, 96, 4, 32
    ref_p, port_p = moe_params(E + k, d, ff, E, skew)
    xj, xt = bf16_input(E * k, (B, S, d))
    ref_y, ref_aux, ids = reference_moe(ref_p, xj, E, k, cf)
    y, aux, own = port_moe_on(ids, port_p, xt, E, k, cf)
    logits = np.asarray((xj.reshape(-1, d) @ ref_p["router"].astype(
        jnp.bfloat16)).astype(jnp.float32))
    probs = np.asarray(jax.nn.softmax(logits, axis=-1))
    p_ref = np.take_along_axis(probs, ids, axis=1)
    p_own = np.take_along_axis(probs, own, axis=1)
    assert (np.abs(p_own - p_ref) <= router_threshold(logits, p_ref)).all()
    assert y.dtype == torch.bfloat16
    assert aux.load.dtype == torch.int32
    assert np.array_equal(aux.load.numpy(), np.asarray(ref_aux.load))
    assert int(aux.load.sum()) == B * S * k
    assert float(aux.dropped) == float(ref_aux.dropped)
    if cf < 1.0 or skew:
        assert float(aux.dropped) > 0.0
    assert float(aux.aux_loss) == pytest.approx(float(ref_aux.aux_loss),
                                                rel=2 ** -8)
    assert_close(y, ref_y)


def test_moe_combine_sums_choices_in_bf16_in_order():
    """Each token's k weighted outputs are added in bf16 one after the
    other, in the order of its choices: the reference's scatter-add. Held
    bit for bit against a sum written out, and against the reference."""
    d, ff, E, k = 32, 48, 8, 4
    ref_p, port_p = moe_params(3, d, ff, E)
    xj, xt = bf16_input(3, (1, 16, d))
    y, _ = moe_call(moe, port_p, xt, E, k, 4.0)
    x2 = xt.reshape(16, d)
    gates, ids, _, _ = moe._route(port_p, x2, E, k)
    total = None
    for j in range(k):
        e = ids[:, j]
        g = torch.bmm(x2[:, None], port_p["w_gate"][e].bfloat16())
        u = torch.bmm(x2[:, None], port_p["w_up"][e].bfloat16())
        yj = torch.bmm(cm.silu(g) * u, port_p["w_down"][e].bfloat16())[:, 0]
        yj = yj * gates[:, j:j + 1].bfloat16()
        total = yj if total is None else total + yj
    assert torch.equal(y.reshape(16, d), total)
    ref_y, _, ids = reference_moe(ref_p, xj, E, k, 4.0)
    assert np.array_equal(ids, moe._route(port_p, x2, E, k)[1].numpy())
    assert_close(y, ref_y)


def router_threshold(logits: np.ndarray, p: np.ndarray) -> np.ndarray:
    """The gap below which a probability ``p`` of a token may trade places
    with the next (the module docstring's bound, 2^-6 * M * p)."""
    return 2 ** -6 * np.abs(logits).max(axis=-1, keepdims=True) * p


@pytest.mark.parametrize("E,k", [(8, 2), (128, 8), (16, 4)])
def test_router_ids_equal_reference_outside_near_ties(E, k):
    d, N = 64, 2048
    ref_p, port_p = moe_params(E, d, 96, E)
    xj, xt = bf16_input(E + 1, (N, d))
    ref_g, ref_ids, ref_aux, ref_load = ref_moe._route(ref_p, xj, E, k)
    g, ids, aux, load = moe._route(port_p, xt, E, k)
    logits = np.asarray((xj @ ref_p["router"].astype(jnp.bfloat16)).astype(
        jnp.float32))
    probs = np.asarray(jax.nn.softmax(logits, axis=-1))
    srt = -np.sort(-probs, axis=-1)[:, :k + 1]
    clear = (srt[:, :k] - srt[:, 1:]) > router_threshold(logits, srt[:, :k])
    ids, ref_ids = ids.numpy(), np.asarray(ref_ids)
    chosen = clear[:, k - 1]
    assert chosen.mean() > 0.25
    assert np.array_equal(np.sort(ids[chosen]), np.sort(ref_ids[chosen]))
    ordered = clear.all(axis=1)
    assert ordered.sum() > 0
    assert np.array_equal(ids[ordered], ref_ids[ordered])
    np.testing.assert_allclose(g.numpy()[ordered],
                               np.asarray(ref_g)[ordered], rtol=2 ** -5,
                               atol=2 ** -8)


@pytest.mark.parametrize("E,k", [(8, 2), (128, 8)])
def test_router_ties_take_the_lower_expert_first(E, k):
    """Router columns 0 and 1 equal, so every token's logits for experts 0
    and 1 are equal bits: wherever both are chosen, expert 0 comes first,
    as jax.lax.top_k orders ties; the ids equal the reference's."""
    d, N = 64, 512
    params = ref_moe.moe_init(jax.random.PRNGKey(5), d, 96, E)
    router = params["router"]
    # the same column, scaled up so experts 0 and 1 lead for most tokens
    params["router"] = router.at[:, 1].set(router[:, 0] * 3).at[:, 0].set(
        router[:, 0] * 3)
    ref_p, port_p = both(params)
    xj, xt = bf16_input(8, (N, d))
    _, ref_ids, _, _ = ref_moe._route(ref_p, xj, E, k)
    _, ids, _, _ = moe._route(port_p, xt, E, k)
    ids = ids.numpy()
    pos0 = np.argmax(ids == 0, axis=1)
    pos1 = np.argmax(ids == 1, axis=1)
    both_in = (ids == 0).any(axis=1) & (ids == 1).any(axis=1)
    assert both_in.sum() > N // 4
    assert (pos1[both_in] == pos0[both_in] + 1).all()
    assert np.array_equal(ids, np.asarray(ref_ids))


def test_top_k_lowest_first_on_exact_ties():
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]])
    vals, ids = moe.top_k_lowest_first(probs, 3)
    assert ids.tolist() == [[1, 2, 0], [0, 1, 2]]
    ref_vals, ref_ids = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert ids.tolist() == np.asarray(ref_ids).tolist()
    assert torch.equal(vals, torch.from_numpy(np.array(ref_vals)))


def test_inverse_slots_and_gather_equal_reference():
    rng = np.random.default_rng(9)
    idx = np.full((4, 6), -1, np.int32)
    src = rng.permutation(30)[:17]
    idx.reshape(-1)[rng.permutation(24)[:17]] = src
    ref_inv = np.asarray(ref_moe._inverse_slots(jnp.asarray(idx), 30))
    inv = moe._inverse_slots(torch.from_numpy(idx), 30)
    assert np.array_equal(inv.numpy(), ref_inv)
    x = rng.standard_normal((30, 5)).astype(np.float32)
    ref_rows, ref_mask = ref_moe._gather0(jnp.asarray(x), jnp.asarray(idx))
    rows, mask = moe._gather0(torch.from_numpy(x), torch.from_numpy(idx))
    assert np.array_equal(rows.numpy(), np.asarray(ref_rows))
    assert np.array_equal(mask.numpy(), np.asarray(ref_mask))


def test_moe_capacity_is_the_reference_formula():
    for n, E, cf in ((64, 128, 1.5), (32, 16, 1.5), (32768, 128, 1.5),
                     (256, 8, 0.5), (7, 3, 1.0)):
        assert moe.moe_capacity(n, E, cf) == max(8, int(n / E * cf))


def test_moe_with_a_mesh_raises():
    """A mesh no longer raises: on a one-rank mesh expert_parallel (one
    shard of all four experts, its capacities the reference's per-shard
    ones) gives the replicated path's output when nothing drops."""
    from tests.helpers.lm_shard import one_rank_mesh
    from repro_torch.models import sharding as sh
    _, port_p = moe_params(0, 16, 32, 4)
    x = torch.randn((1, 4, 16), generator=torch.Generator().manual_seed(2)
                    ).to(torch.bfloat16)
    kw = dict(batch_axes=("data",), model_axis="model", n_experts=4,
              top_k=2)
    want, want_aux = moe.moe_apply(port_p, x, mesh=None,
                                   strategy="replicate", **kw)
    with one_rank_mesh() as mesh:
        ctx = sh.ShardCtx(mesh, ("data",), "model", None, True)
        got, aux = moe.moe_apply(port_p, x, mesh=mesh,
                                 strategy="expert_parallel", shard_ctx=ctx,
                                 **kw)
    assert float(aux.dropped) == 0.0 == float(want_aux.dropped)
    assert torch.equal(aux.load.to(torch.int32), want_aux.load)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=0)
