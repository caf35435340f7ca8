"""Cases of the LM's sharded paths, and the port's side of them in gloo
ranks (``torch.multiprocessing``; this module imports no JAX, so a rank
starts fast).

A case names a smoke config, a (data, model) mesh, the plan's shape kind
and any strategy it forces, the batch and the entry points to run. The
plan comes from the port's ``plan_model`` with the reference's constants
and is handed to the reference as its fields, so both packages run the
same plan. Params are the port's ``init_params`` on the CPU, as numpy.

``run_port`` runs every case of one world in one rank and returns, on
rank 0, each case's outputs whole (the blocks all-gathered) as numpy.

MoE comparisons share one routing: the reference's, recorded per device
(``lm_shard_ref``) and forced on the port's ``moe.top_k_lowest_first``
call by call (``forcing``): on a rank, the calls of the device at its
coordinates (expert parallel) or its rows of the global call (GSPMD's
replicated path); on the single-device path, the calls assembled whole
(``global_routing``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import pickle
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.core.relshard import plan_model
from repro_torch.layers import moe
from repro_torch.models import lm
from repro_torch.models import sharding as sh
from repro_torch.models.config import ShapeConfig

REF_W = 819.0 / 50.0
REF_HBM = 16 * 2 ** 30
#: decode steps each decode case runs (teacher-forced from a zero cache)
DECODE_STEPS = 3
#: the capacity factor of "fwd_dropless", at which no assignment drops
DROPLESS_CF = 16.0

#: name -> (arch, (data, model), plan kind, forced plan fields, batch, seq,
#:          entries). Entries: "fwd" (hidden states and MoE aux),
#:          "fwd_dropless" (the same at ``DROPLESS_CF``, port only),
#:          "prefill" (last logits), "decode", "loss", "grads",
#:          "ref_unsharded" (the reference's mesh=None forward and decode
#:          too, reference only).
CASES = {
    # plan_model's own train plan: fsdp over data, Megatron TP, head mode
    "dense_2x2": ("tinyllama_1_1b", (2, 2), "train", {}, 4, 32,
                  ("fwd", "prefill", "loss", "grads")),
    # the serve plan, and decode with the batch over data
    "dense_2x2_serve": ("tinyllama_1_1b", (2, 2), "decode", {}, 4, 16,
                        ("decode",)),
    # vocab-parallel embed and head, fsdp off, 1x4: head mode with KV
    # heads (2) that do not divide the model axis
    "vocab_1x4": ("granite_8b", (1, 4), "train",
                  {"embed_strategy": "vocab_parallel",
                   "head_strategy": "vocab_parallel", "fsdp_axes": ()},
                  2, 32, ("fwd", "prefill", "decode", "loss", "grads")),
    # replicated TP: storage over fsdp x model, gathered at compute
    "tp_replicated_2x2": ("glm4_9b", (2, 2), "train",
                          {"tp": "replicated"}, 4, 32,
                          ("fwd", "loss", "grads")),
    # VLM with cond tokens and MQA (1 KV head), replicated embed and head
    "vlm_2x2": ("paligemma_3b", (2, 2), "train",
                {"embed_strategy": "replicate",
                 "head_strategy": "replicate"}, 2, 32,
                ("fwd", "prefill", "loss")),
    # MoE expert-parallel: the sequence split over model (train/prefill),
    # tokens replicated over it (decode)
    "moe_ep_1x4": ("qwen3_moe_235b_a22b", (1, 4), "train",
                   {"moe_strategy": "expert_parallel"}, 2, 32,
                   ("fwd", "fwd_dropless", "prefill", "decode", "loss",
                    "grads")),
    # MoE replicated: one global capacity over the batch's rows
    "moe_rep_2x2": ("dbrx_132b", (2, 2), "train",
                    {"moe_strategy": "replicate"}, 4, 32,
                    ("fwd", "decode", "loss")),
    # the hybrid (Mamba blocks whole over model, shared attention TP)
    # (the reference's own sharded forward leaves its unsharded one by
    # more than the bf16 bounds here: "ref_unsharded" also runs that)
    "hybrid_2x2": ("zamba2_7b", (2, 2), "train", {}, 2, 32,
                   ("fwd", "decode", "loss", "ref_unsharded")),
    # RWKV-6 (blocks whole over model)
    "rwkv_2x2": ("rwkv6_3b", (2, 2), "train", {}, 2, 32,
                 ("fwd", "decode", "loss")),
    # a batch that does not divide over data at a 1024-position cache:
    # the KV sequence split over data, KV heads over model
    "long_decode_2x2": ("tinyllama_1_1b", (2, 2), "decode", {}, 1, 1024,
                        ("decode",)),
    # model axis 8 > 4 heads: "seq" mode (each query chunk's rows split)
    "seq_1x8": ("tinyllama_1_1b", (1, 8), "train", {}, 2, 16,
                ("fwd", "loss", "grads")),
    # rows that do not divide over 8 either: "batch" mode
    "batch_1x8": ("tinyllama_1_1b", (1, 8), "train", {}, 2, 12,
                  ("fwd", "loss")),
}


def world_of(name: str) -> int:
    d, m = CASES[name][1]
    return d * m


def case_plan(name: str):
    """The port's plan of a case (the reference's constants)."""
    arch, (d, m), kind, force, B, S, _ = CASES[name]
    cfg = get_smoke_config(arch)
    shape = ShapeConfig(name, S, B, kind)
    plan = plan_model(cfg, (("data", d), ("model", m)), shape, w=REF_W,
                      hbm_bytes=REF_HBM, fsdp=kind == "train")
    return cfg, dataclasses.replace(plan, **force)


def plan_fields(plan) -> dict:
    """What the reference's ``ShardingPlan`` needs of the port's."""
    return {k: getattr(plan, k) for k in (
        "batch_axes", "model_axis", "fsdp_axes", "embed_strategy",
        "head_strategy", "moe_strategy", "w", "tp")}


def case_params(name: str):
    """The params of a case, as a tree of numpy arrays."""
    cfg, _ = case_plan(name)
    return lm.params_to_numpy(lm.init_params(cfg, 0, device="cpu"))


def case_inputs(name: str):
    """Token ids (B, S), cond embeddings (or None), decode tokens."""
    arch, _, _, _, B, S, _ = CASES[name]
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(zlib_seed(name))
    n_text = S - cfg.n_cond_tokens
    tokens = rng.integers(0, cfg.vocab, (B, n_text)).astype(np.int32)
    cond = (rng.standard_normal((B, cfg.n_cond_tokens, cfg.d_model))
            .astype(np.float32) * 0.5 if cfg.n_cond_tokens else None)
    steps = rng.integers(0, cfg.vocab, (B, DECODE_STEPS)).astype(np.int32)
    return tokens, cond, steps


def zlib_seed(name: str) -> int:
    import zlib
    return zlib.crc32(name.encode())


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the port, in one rank of a gloo world
# ---------------------------------------------------------------------------

def _unshard_rows(t, ctx, spec_tail=()):
    return sh.unshard(t, sh.P(ctx.batch or None, *spec_tail), ctx.mesh)


def _logit_spec(plan, ctx):
    return ((plan.model_axis,) if plan.head_strategy == "vocab_parallel"
            else (None,))


@contextlib.contextmanager
def capacity_factor(cf: float):
    """The MoE layers' capacities at factor ``cf`` in place of the
    reference's 1.5 (``moe.moe_capacity`` patched for the block)."""
    orig = moe.moe_capacity
    moe.moe_capacity = lambda n, n_experts, factor=1.5: orig(n, n_experts,
                                                               cf)
    try:
        yield
    finally:
        moe.moe_capacity = orig


@contextlib.contextmanager
def forcing(calls):
    """The port's routing calls take ``calls``' expert ids, in order."""
    orig = moe.top_k_lowest_first
    queue = list(calls)

    def top_k(probs, k):
        ids = torch.from_numpy(np.asarray(queue.pop(0))).to(
            device=probs.device, dtype=torch.int64)
        return probs.gather(-1, ids), ids
    moe.top_k_lowest_first = top_k
    try:
        yield
    finally:
        moe.top_k_lowest_first = orig
    assert not queue, f"{len(queue)} recorded routings were not used"


def _seq_split(name, entry) -> bool:
    _, (d, m), _, force, B, S, _ = CASES[name]
    return (force.get("moe_strategy") == "expert_parallel"
            and entry != "decode" and S % m == 0)


def rank_routing(name, entry, routing, mesh):
    """This rank's calls of the reference's routing of ``entry``."""
    rec = routing[entry]
    if set(rec) != {(0, 0)} or mesh.size == 1:
        return rec[(mesh.coords["data"], mesh.coords["model"])]
    _, _, _, _, B, _, _ = CASES[name]
    cfg, plan = case_plan(name)
    ctx = lm.shard_ctx(plan, mesh, B)
    n = mesh.n(ctx.batch)
    i = mesh.index(ctx.batch) if ctx.batch else 0
    return [c.reshape(n, -1, c.shape[-1])[i] if ctx.batch else c
            for c in rec[(0, 0)]]


def global_routing(name, entry, routing):
    """The reference's routing of ``entry``, each call over every token
    (for the single-device path)."""
    rec = routing[entry]
    if set(rec) == {(0, 0)}:
        return rec[(0, 0)]
    _, (d, m), _, _, B, _, _ = CASES[name]
    k = next(iter(rec.values()))[0].shape[-1]
    out = []
    for c in range(len(rec[(0, 0)])):
        if _seq_split(name, entry):
            rows = [np.concatenate([rec[(i, j)][c].reshape(B // d, -1, k)
                                    for j in range(m)], axis=1)
                    for i in range(d)]
        else:
            rows = [rec[(i, 0)][c].reshape(B // d, -1, k) for i in range(d)]
        out.append(np.concatenate(rows, axis=0).reshape(-1, k))
    return out


def _routed(name, entry, routing, mesh):
    if routing is None or not routing.get(entry):
        return contextlib.nullcontext()
    calls = (global_routing(name, entry, routing) if mesh is None
             else rank_routing(name, entry, routing, mesh))
    if entry == "loss":
        # the port's loss runs at remat "none" (``port_case``): the
        # forward's calls only, not a rematerialized block's second ones
        calls = calls[:case_plan(name)[0].n_layers]
    return forcing(calls)


def port_case(name: str, mesh, device="cpu", routing=None):
    """One case on ``mesh`` (None: the single-device path). Returns
    {output: numpy}, each whole. ``routing``: the reference's, forced."""
    cfg, plan = case_plan(name)
    entries = CASES[name][6]
    tree = case_params(name)
    specs = lm.param_specs(cfg, tree, plan)
    params = lm.params_from_numpy(tree, device, mesh, specs)
    tokens, cond, steps = case_inputs(name)
    tok = torch.from_numpy(tokens).to(device)
    cnd = None if cond is None else _bf16(cond).to(device)
    B = tokens.shape[0]
    ctx = lm.shard_ctx(plan, mesh, B)
    out = {}

    def whole(t, tail=()):
        return t if mesh is None else _unshard_rows(t, ctx, tail)

    def fwd(key):
        hidden, aux = lm.forward(params, cfg, plan, mesh, tok, cnd)
        out[key] = whole(hidden).float().numpy()
        if cfg.is_moe:
            out[key + "_moe_load"] = aux.moe_load.float().numpy()
            out[key + "_moe_dropped"] = aux.moe_dropped.float().numpy()
            out[key + "_moe_aux"] = aux.moe_aux_loss.float().numpy()

    with torch.no_grad():
        if "fwd" in entries:
            with _routed(name, "fwd", routing, mesh):
                fwd("hidden")
        if "fwd_dropless" in entries:
            with capacity_factor(DROPLESS_CF), \
                    _routed(name, "fwd", routing, mesh):
                fwd("dropless")
        if "prefill" in entries:
            with _routed(name, "prefill", routing, mesh):
                logits = lm.prefill(params, cfg, plan, mesh, tok, cnd)
            out["prefill"] = whole(logits, _logit_spec(plan, ctx)
                                   if mesh is not None else ()).numpy()
        if "decode" in entries:
            with _routed(name, "decode", routing, mesh):
                out["decode"] = _decode(params, cfg, plan, mesh, name,
                                        steps, device)
    if "loss" in entries or "grads" in entries:
        batch = {"tokens": tok}
        if cnd is not None:
            batch["cond_emb"] = cnd
        need = "grads" in entries
        work = (lm._map_tree(lambda t: t.detach().requires_grad_(), params)
                if need else params)
        if routing is not None:
            # a rematerialized MoE block would route again in the backward
            cfg = dataclasses.replace(cfg, remat_policy="none")
        with _routed(name, "loss", routing, mesh), \
                torch.set_grad_enabled(need):
            loss, metrics = lm.train_loss(work, cfg, plan, mesh, batch)
            out["loss"] = loss.detach().numpy()
            grads = (torch.autograd.grad(loss, _leaves(work),
                                         allow_unused=True)
                     if "grads" in entries else None)
        if grads is not None:
            flat = {}
            for (path, p), g, in zip(_paths(work), grads):
                g = torch.zeros_like(p) if g is None else g
                if mesh is not None:
                    g = sh.unshard(g.float(), _leaf(specs, path), mesh)
                flat["/".join(path)] = g.float().numpy()
            out["grads"] = flat
    return out


def _decode(params, cfg, plan, mesh, name, steps, device):
    B, S = CASES[name][4], CASES[name][5]
    max_seq = max(S, DECODE_STEPS)
    cache = lm.init_cache(cfg, B, max_seq, device, mesh=mesh, plan=plan)
    ctx = lm.shard_ctx(plan, mesh, B, max_seq=max_seq, cfg=cfg)
    outs = []
    for t in range(steps.shape[1]):
        tok = torch.from_numpy(steps[:, t:t + 1].copy()).to(device)
        logits, cache = lm.decode_step(params, cfg, plan, mesh, tok, cache,
                                       max_seq=max_seq)
        if mesh is not None:
            logits = sh.unshard(logits, sh.P(
                ctx.batch or None, *_logit_spec(plan, ctx)), mesh)
        outs.append(logits.numpy())
    return np.stack(outs, axis=1)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _leaves(tree):
    return [t for _, t in _paths(tree)]


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def run_port(world: int, names, routing=None):
    """Every case in ``names`` on this rank's mesh; rank 0 returns them.
    ``routing``: {case: the reference's recorded routing} to force."""
    out = {}
    for name in names:
        d, m = CASES[name][1]
        mesh = sh.Mesh((("data", d), ("model", m)), device="cpu")
        mesh.stats.reset()
        out[name] = port_case(name, mesh,
                              routing=(routing or {}).get(name))
        out[name]["stats"] = dict(mesh.stats.calls)
    return out


def rank_main(rank, world, store, out_dir, names, routing=None,
              training=False):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        res = run_port(world, names, routing)
        if training:
            res["training"] = run_training(str(Path(out_dir) / "ckpt"))
            mesh = sh.Mesh((("data", 2), ("model", 2)), device="cpu")
            res["engine"] = engine_case(mesh)
        if rank == 0:
            with open(Path(out_dir) / "port.pkl", "wb") as f:
                pickle.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def one_rank_mesh(axes=(("data", 1), ("model", 1))):
    """A mesh over a one-rank gloo group started in this process (and
    ended after), for tests that hold a mesh of one to mesh=None."""
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield sh.Mesh(axes, device="cpu")
    finally:
        if started:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the engine on a mesh
# ---------------------------------------------------------------------------

#: the engine's smoke config, slots, cache length, requests and new tokens
ENGINE = ("tinyllama_1_1b", 4, 16, 6, 6)


def engine_plan():
    arch, slots, max_seq, _, _ = ENGINE
    cfg = get_smoke_config(arch)
    return cfg, plan_model(cfg, (("data", 2), ("model", 2)), ShapeConfig(
        "serve", max_seq, slots, "decode"), w=REF_W, hbm_bytes=REF_HBM)


def engine_prompt(i: int) -> list:
    return [1 + i, 2 + 3 * i, 3]


def engine_case(mesh):
    """Every request's tokens from the engine on ``mesh`` (None: one
    device) under ``plan_model``'s own plan for 2x2, fsdp over data: a
    slot's admission runs on the ranks that hold its rows while the others
    join its weight gathers. More requests than slots: admissions happen
    while other slots decode."""
    from repro_torch.serving.engine import Request, ServeEngine
    _, slots, max_seq, n_req, new = ENGINE
    cfg, plan = engine_plan()
    params = lm.init_params(cfg, 2, device="cpu")
    if mesh is not None:
        params = lm.shard_params(params, cfg, plan, mesh)
    eng = ServeEngine(cfg, plan, mesh, params, max_batch=slots,
                      max_seq=max_seq, device="cpu")
    reqs = [Request(i, engine_prompt(i), new) for i in range(n_req)]
    for r in reqs:
        eng.submit(r)
    while eng.queue or eng.occupancy():
        eng.step()
    return [r.out for r in reqs]


# ---------------------------------------------------------------------------
# training on a mesh
# ---------------------------------------------------------------------------

#: name -> (arch, (data, model), optimizer, grad dtype); batch 4 x 32
TRAIN_CASES = {
    "adamw_2x2": ("tinyllama_1_1b", (2, 2), "adamw", "float32"),
    "adafactor_bf16_2x2": ("tinyllama_1_1b", (2, 2), "adafactor",
                           "bfloat16"),
    "adafactor_1x4": ("starcoder2_3b", (1, 4), "adafactor", "float32"),
}
TRAIN_BATCH, TRAIN_SEQ = 4, 32


def train_setup(name: str):
    from repro_torch.training.optimizer import OptConfig
    arch, (d, m), opt_name, gd = TRAIN_CASES[name]
    cfg = get_smoke_config(arch)
    shape = ShapeConfig(name, TRAIN_SEQ, TRAIN_BATCH, "train")
    plan = plan_model(cfg, (("data", d), ("model", m)), shape, w=REF_W,
                      hbm_bytes=REF_HBM, fsdp=True)
    # warm-up of 1: the first step moves the params by the whole lr
    opt_cfg = OptConfig(name=opt_name, grad_dtype=gd, lr=1e-3,
                        warmup_steps=1)
    params = lm.params_to_numpy(lm.init_params(cfg, 1, device="cpu"))
    rng = np.random.default_rng(zlib_seed(name))
    tokens = rng.integers(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(
        np.int32)
    grads = lm._map_tree(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) * 0.01, params)
    return cfg, plan, opt_cfg, params, tokens, grads


def train_case(name: str, mesh):
    """One train step and three ``apply_updates`` on fixed gradients, on
    ``mesh`` (None: whole). Returns the loss, the params after the step and
    after the updates, and the metrics, whole."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step
    cfg, plan, opt_cfg, tree, tokens, grads = train_setup(name)
    specs = lm.param_specs(cfg, tree, plan)
    params = lm.params_from_numpy(tree, "cpu", mesh, specs)
    state = opt.init_opt_state(opt_cfg, params)
    step = make_train_step(cfg, plan, mesh, opt_cfg)
    params, state, metrics = step(params, state,
                                  {"tokens": torch.from_numpy(tokens)})

    def whole(t, spec):
        return (t if mesh is None else sh.unshard(t, spec, mesh)).numpy()
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "step": sh.map_specs(whole, params, specs)}
    params = lm.params_from_numpy(tree, "cpu", mesh, specs)
    g = lm.params_from_numpy(grads, "cpu", mesh, specs)
    state = opt.init_opt_state(opt_cfg, params)
    norms = []
    for _ in range(3):
        params, state, m = opt.apply_updates(opt_cfg, params, state, g,
                                             mesh=mesh, specs=specs)
        norms.append(float(m["grad_norm"]))
    out["updates"] = sh.map_specs(whole, params, specs)
    out["update_norms"] = norms
    return out, params, state


def checkpoint_case(ckpt_dir: str, params, state, name: str, mesh4):
    """Save the 2x2 run's params and state, restore them on a 1x4 mesh of
    the same ranks, and return the restored blocks gathered whole."""
    from repro_torch.training import checkpoint as ck
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import sharding_trees
    cfg, plan, opt_cfg, tree, _, _ = train_setup(name)
    specs = lm.param_specs(cfg, tree, plan)
    ck.save(ckpt_dir, 1, {"params": params, "opt": state}, mesh=mesh4,
            specs={"params": specs,
                   "opt": opt.opt_state_specs(opt_cfg, specs)})
    mesh = sh.Mesh((("data", 1), ("model", 4)), device="cpu")
    plan14 = plan_model(cfg, (("data", 1), ("model", 4)), ShapeConfig(
        name, TRAIN_SEQ, TRAIN_BATCH, "train"), w=REF_W, hbm_bytes=REF_HBM)
    p_sh, o_sh, specs14 = sharding_trees(cfg, plan14, mesh, opt_cfg, tree)
    like_p = lm.params_from_numpy(tree, "cpu", mesh, specs14)
    like = {"params": like_p, "opt": opt.init_opt_state(opt_cfg, like_p)}
    back, _ = ck.restore(ckpt_dir, 1, like, shardings={"params": p_sh,
                                                       "opt": o_sh})
    o_specs = opt.opt_state_specs(opt_cfg, specs14)
    return {"params": sh.unshard_tree(back["params"], specs14, mesh),
            "opt": sh.unshard_tree(back["opt"], o_specs, mesh)}


def run_training(ckpt_dir: str):
    """Every training case whose mesh has this world's ranks."""
    out = {}
    world = dist.get_world_size()
    for name, (_, (d, m), _, _) in TRAIN_CASES.items():
        if d * m != world:
            continue
        mesh = sh.Mesh((("data", d), ("model", m)), device="cpu")
        out[name], params, state = train_case(name, mesh)
        if name == "adamw_2x2":
            out["checkpoint"] = checkpoint_case(ckpt_dir, params, state,
                                                name, mesh)
    return out
