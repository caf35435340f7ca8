"""End-to-end training driver on the port: train a ~100M-param dense LM for
a few hundred steps with checkpoint/restart, printing the loss curve.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
        [--ckpt DIR] [--device cpu]

The twin of ``examples/train_lm.py``. The mesh axes are written out as one
device's, ``(("data", 1), ("model", 1))``: the port has no mesh module yet
(``ROADMAP.md`` queue 1, item 5). It runs on the CUDA card unless
``--device`` names another. Like the reference, it resumes from the latest
checkpoint under ``--ckpt``.
"""

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.core.relshard import plan_model
from repro_torch.models.config import ShapeConfig
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import train

MESH_AXES = (("data", 1), ("model", 1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "reljoin_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    # ~100M params: tinyllama scaled to 12 layers x 896 wide.
    cfg = dataclasses.replace(
        get_config("tinyllama_1_1b"), n_layers=12, d_model=896, n_heads=14,
        n_kv_heads=7, d_ff=2688, vocab=8192, name="tinyllama-100m")
    n_params = cfg.param_count()
    print(f"model: {cfg.name} ~{n_params/1e6:.0f}M params")

    shape = ShapeConfig("train", 256, 8, "train")
    plan = plan_model(cfg, MESH_AXES, shape, fsdp=False)
    out = train(cfg, plan, None, steps=args.steps, global_batch=8,
                seq_len=256, opt_cfg=OptConfig(lr=1e-3, warmup_steps=30),
                ckpt_dir=args.ckpt, ckpt_every=100, log_every=20,
                device=args.device)
    first, last = out["history"][0][1], out["history"][-1][1]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'LEARNING' if last < first - 0.5 else 'check hyperparams'})")
    return out


if __name__ == "__main__":
    main()
