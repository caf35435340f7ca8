"""The port's side of ``tests/test_torch_dryrun.py``, with no JAX: the
same entry points counted by ``repro_torch.launch.dryrun.count_program``
on a 2x2 mesh of meta tensors under a fake world of 4; the production
meshes built under fake worlds of 256 and 512; records written by
``run_and_save`` and by ``main`` (a skipped cell on both meshes, through
its child processes).

    python -m tests.helpers.dryrun_port IN.pkl OUT.pkl RECORDS_DIR
"""

from __future__ import annotations

import pickle
import sys

from repro_torch.configs import get_smoke_config
from repro_torch.core.relshard import ShardingPlan
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import sharding as sh
from repro_torch.models.config import ShapeConfig


def main(src: str, dst: str, records: str) -> None:
    with open(src, "rb") as f:
        cases = pickle.load(f)
    out = {}
    with dryrun.fake_world(4):
        mesh = sh.Mesh((("data", 2), ("model", 2)), device="meta")
        for kind, (arch, shape, fields) in cases.items():
            s, mem, _ = dryrun.count_program(
                get_smoke_config(arch), ShapeConfig(*shape),
                ShardingPlan(**fields), mesh)
            out[kind] = {"flops": s.flops, "bytes": s.bytes_accessed,
                         "collectives": s.collective_wire_bytes,
                         "calls": s.collective_calls, "memory": mem}
    for world, multi in ((256, False), (512, True)):
        with dryrun.fake_world(world):
            m = make_production_mesh(multi_pod=multi, device="meta")
            out[f"mesh_{world}"] = (m.axis_names,
                                    tuple(m.shape[a] for a in m.axis_names))
    out["decode_32k"] = dryrun.run_and_save("tinyllama_1_1b", "decode_32k",
                                            False, records)
    out["main"] = dryrun.main(["--arch", "tinyllama-1.1b", "--shape",
                               "long_500k", "--mesh", "both", "--out",
                               records])
    with open(dst, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:4])
