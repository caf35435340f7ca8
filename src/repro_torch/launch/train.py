"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 200 --batch 8 --seq 256 --smoke --ckpt CKPT_DIR [--resume] \
        [--data-par 2 --model-par 2]

The reference's flags. ``--data-par`` x ``--model-par`` ranks: above one,
the launcher starts them itself (``launch.ranks``), every rank trains its
blocks (FSDP over data when ``--data-par`` > 1, the plan's tensor
parallelism over model) and checkpoints hold whole arrays. Fault
tolerance: periodic atomic checkpoints + resume. Runs on the CUDA card
unless ``--device`` names another; there is no fallback to the CPU.
"""

from __future__ import annotations

import argparse

from ..configs import ARCH_ALIASES, get_config, get_smoke_config
from ..core.relshard import plan_model
from ..joins.table import resolve_device
from ..models.config import ShapeConfig
from ..training.optimizer import OptConfig
from ..training.train_loop import train
from .mesh import make_host_mesh, mesh_axes
from .ranks import run_ranks


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def run(device, args) -> None:
    """One rank's run (the only one when the world is 1)."""
    arch = ARCH_ALIASES.get(args.arch, args.arch)
    cfg = get_smoke_config(arch) if args.smoke else get_config(arch)
    world = args.data_par * args.model_par
    mesh = (make_host_mesh(args.data_par, args.model_par, device)
            if world > 1 else None)
    axes = (mesh_axes(mesh) if mesh is not None else
            (("data", 1), ("model", 1)))
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    plan = plan_model(cfg, axes, shape, fsdp=args.data_par > 1)
    if mesh is None or mesh.rank == 0:
        print(plan.explain(), flush=True)
    opt = OptConfig(name=cfg.optimizer, lr=args.lr,
                    grad_dtype=args.grad_dtype)
    train(cfg, plan, mesh, steps=args.steps, global_batch=args.batch,
          seq_len=args.seq, opt_cfg=opt, ckpt_dir=args.ckpt or None,
          ckpt_every=args.ckpt_every, resume=args.resume, device=device)


def main(argv=None):
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    world = args.data_par * args.model_par
    if world == 1:
        run(device, args)
    else:
        run_ranks(world, device, run, args)


if __name__ == "__main__":
    main()
