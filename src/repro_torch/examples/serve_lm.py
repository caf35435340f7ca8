"""Batched serving example on the port: continuous batching over a small
model, with RelShard occupancy re-planning.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

The twin of ``examples/serve_lm.py``. The mesh axes are written out as one
device's, ``(("data", 1), ("model", 1))``, as the reference's one-device
host mesh describes them (a ``launch.mesh`` mesh needs a process group;
``launch.serve`` and ``launch.train`` start one). It runs on the CUDA card unless
``--device`` names another.
"""

import argparse

from repro_torch.configs import get_smoke_config
from repro_torch.core.relshard import plan_model
from repro_torch.models import lm
from repro_torch.models.config import ShapeConfig
from repro_torch.serving.engine import Request, ServeEngine

MESH_AXES = (("data", 1), ("model", 1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config("tinyllama_1_1b")
    shape = ShapeConfig("serve", 96, 4, "decode")
    plan = plan_model(cfg, MESH_AXES, shape, fsdp=False)
    params = lm.init_params(cfg, seed=0, device=args.device)
    eng = ServeEngine(cfg, plan, None, params, max_batch=4, max_seq=96,
                      mesh_axes=MESH_AXES, shape=shape, device=args.device)

    for rid in range(7):
        eng.submit(Request(rid, prompt=[1 + rid, 5, 9], max_new_tokens=16))
    steps = 0
    while eng.queue or eng.occupancy():
        eng.step()
        steps += 1
        if steps % 10 == 0:
            eng.maybe_replan()
    print(f"served 7 requests in {steps} batched decode steps "
          f"(continuous batching, max_batch=4)")


if __name__ == "__main__":
    main()
