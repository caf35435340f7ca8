"""The reference's side of ``lm_shard.CASES``: the JAX package's sharded
entry points on forced host devices, run as a script in its own process
(``XLA_FLAGS=--xla_force_host_platform_device_count=8`` must be set before
JAX starts, which the test process cannot do for itself).

    python -m tests.helpers.lm_shard_ref IN.pkl OUT.pkl

IN holds {case: {"plan": fields, "params": numpy tree}}. OUT gets, per
case, the outputs ``lm_shard.port_case`` gives (whole, as numpy) and the
routing of every MoE routing call: per device coordinates (data, model),
the expert ids of its calls in order.
"""

from __future__ import annotations

import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding

from repro.configs import get_smoke_config
from repro.core.relshard import ShardingPlan
from repro.launch.mesh import _axis_type_kwargs
from repro.launch.specs import _cache_pspec
from repro.layers import moe as ref_moe
from repro.models import lm

from .lm_shard import CASES, DECODE_STEPS, case_inputs

ROUTING: dict = {}


def _coord(axis):
    try:
        return jax.lax.axis_index(axis)
    except NameError:       # outside shard_map: the global token set
        return jnp.zeros((), jnp.int32)


def _install_recorder():
    orig = ref_moe._route

    def route(params, x2d, n_experts, top_k):
        res = orig(params, x2d, n_experts, top_k)
        jax.debug.callback(
            lambda d, m, ids: ROUTING.setdefault(
                (int(d), int(m)), []).append(np.asarray(ids)),
            _coord("data"), _coord("model"), res[1])
        return res
    ref_moe._route = route


def run_case(name, plan_fields, params_np):
    arch, (d, m), _, _, B, S, entries = CASES[name]
    cfg = get_smoke_config(arch)
    plan = ShardingPlan(**plan_fields)
    mesh = jax.make_mesh((d, m), ("data", "model"),
                         devices=jax.devices()[:d * m],
                         **_axis_type_kwargs(2))
    specs = lm.param_specs(cfg, params_np, plan)
    params = jax.tree.map(
        lambda a, s: jax.device_put(jnp.asarray(a), NamedSharding(mesh, s)),
        params_np, specs, is_leaf=lambda x: isinstance(x, np.ndarray))
    tokens, cond, steps = case_inputs(name)
    cond = None if cond is None else jnp.asarray(cond, jnp.bfloat16)
    out = {}
    ROUTING.clear()
    routing = {}

    def take(key):
        jax.effects_barrier()
        routing[key] = {k: list(v) for k, v in ROUTING.items()}
        ROUTING.clear()

    if "fwd" in entries:
        hidden, aux = jax.jit(lambda p, t, c: lm.forward(
            p, cfg, plan, mesh, t, c))(params, tokens, cond)
        out["hidden"] = np.asarray(hidden, np.float32)
        if cfg.is_moe:
            out["hidden_moe_load"] = np.asarray(aux.moe_load, np.float32)
            out["hidden_moe_dropped"] = np.asarray(aux.moe_dropped, np.float32)
            out["hidden_moe_aux"] = np.asarray(aux.moe_aux_loss, np.float32)
        take("fwd")
    if "prefill" in entries:
        out["prefill"] = np.asarray(jax.jit(lambda p, t, c: lm.prefill(
            p, cfg, plan, mesh, t, c))(params, tokens, cond), np.float32)
        take("prefill")
    def decode(m, p):
        max_seq = max(S, DECODE_STEPS)
        cache = lm.init_cache(cfg, B, max_seq)
        if m is not None:
            cache = jax.tree.map(lambda a: jax.device_put(a, NamedSharding(
                m, _cache_pspec(a.shape, cfg, plan, m, B))), cache)
        step = jax.jit(lambda p, t, c: lm.decode_step(
            p, cfg, plan, m, t, c))
        logits = []
        for t in range(steps.shape[1]):
            lg, cache = step(p, jnp.asarray(steps[:, t:t + 1]), cache)
            logits.append(np.asarray(lg, np.float32))
        return np.stack(logits, axis=1)

    if "decode" in entries:
        out["decode"] = decode(mesh, params)
        take("decode")
    if "ref_unsharded" in entries:
        whole = jax.tree.map(jnp.asarray, params_np)
        out["hidden_unsharded"] = np.asarray(jax.jit(
            lambda p, t, c: lm.forward(p, cfg, plan, None, t, c)[0])(
                whole, tokens, cond), np.float32)
        out["decode_unsharded"] = decode(None, whole)
    if "loss" in entries or "grads" in entries:
        batch = {"tokens": jnp.asarray(tokens)}
        if cond is not None:
            batch["cond_emb"] = cond

        def loss_fn(p):
            return lm.train_loss(p, cfg, plan, mesh, batch)[0]
        if "grads" in entries:
            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
            flat = jax.tree_util.tree_flatten_with_path(grads)[0]
            out["grads"] = {"/".join(k.key for k in kp):
                            np.asarray(g, np.float32) for kp, g in flat}
        else:
            loss = jax.jit(loss_fn)(params)
        out["loss"] = np.asarray(loss, np.float32)
        take("loss")
    out["routing"] = routing
    return out


def main(src, dst):
    with open(src, "rb") as f:
        cases = pickle.load(f)
    _install_recorder()
    res = {name: run_case(name, c["plan"], c["params"])
           for name, c in cases.items()}
    with open(dst, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
