"""Serving launcher: batched requests through the continuous-batching
engine with RelShard stage-boundary re-planning.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --smoke --requests 6 --max-new 12 [--data-par 2 --model-par 2]

The reference's flags. ``--data-par`` x ``--model-par`` ranks: above one,
the launcher starts them itself (``launch.ranks``) and every rank serves
its blocks of the weights and the cache (SPMD). Runs on the CUDA card
unless ``--device`` names another; there is no fallback to the CPU.
"""

from __future__ import annotations

import argparse

from ..configs import ARCH_ALIASES, get_config, get_smoke_config
from ..core.relshard import plan_model
from ..joins.table import resolve_device
from ..models import lm
from ..models.config import ShapeConfig
from ..serving.engine import Request, ServeEngine
from .mesh import make_host_mesh, mesh_axes
from .ranks import run_ranks


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def serve(device, args) -> None:
    """One rank's run (the only one when the world is 1)."""
    arch = ARCH_ALIASES.get(args.arch, args.arch)
    cfg = get_smoke_config(arch) if args.smoke else get_config(arch)
    world = args.data_par * args.model_par
    mesh = (make_host_mesh(args.data_par, args.model_par, device)
            if world > 1 else None)
    axes = (mesh_axes(mesh) if mesh is not None else
            (("data", 1), ("model", 1)))
    say = mesh is None or mesh.rank == 0
    shape = ShapeConfig("serve", args.max_seq, args.max_batch, "decode")
    plan = plan_model(cfg, axes, shape, fsdp=False)
    if say:
        print(plan.explain(), flush=True)

    params = lm.init_params(cfg, 0, device)
    if mesh is not None:
        params = lm.shard_params(params, cfg, plan, mesh)
    eng = ServeEngine(cfg, plan, mesh, params, max_batch=args.max_batch,
                      max_seq=args.max_seq, mesh_axes=axes, shape=shape,
                      device=device)
    for rid in range(args.requests):
        eng.submit(Request(rid, [1 + rid % 7, 2, 3], args.max_new))
    steps = 0
    while (eng.queue or eng.occupancy()) and steps < 10_000:
        eng.step()
        if steps % 8 == 0:
            eng.maybe_replan()
        steps += 1
    if say:
        print(f"[serve] completed {args.requests} requests in {steps} "
              f"decode steps; replan events: {eng.replan_events or 'none'}",
              flush=True)


def main(argv=None):
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    world = args.data_par * args.model_par
    if world == 1:
        serve(device, args)
    else:
        run_ranks(world, device, serve, args)


if __name__ == "__main__":
    main()
