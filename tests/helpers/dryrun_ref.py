"""The reference's side of ``tests/test_torch_dryrun.py``: the JAX
package's entry points lowered and compiled as its ``launch/dryrun.py``
does, on a 2x2 mesh of forced host devices, run as a script in its own
process (``XLA_FLAGS=--xla_force_host_platform_device_count=4`` must be
set before JAX starts, which the test process cannot do for itself).

    python -m tests.helpers.dryrun_ref IN.pkl OUT.pkl

IN holds {kind: (arch, shape fields, plan fields)}. OUT gets, per kind,
``hlo_cost.analyze`` of the compiled module's text.
"""

from __future__ import annotations

import pickle
import sys

import jax

from repro.configs import get_smoke_config
from repro.core.relshard import ShardingPlan
from repro.launch.hlo_cost import analyze
from repro.launch.mesh import _axis_type_kwargs
from repro.launch.specs import input_specs, model_shardings
from repro.models import lm
from repro.models.config import ShapeConfig
from repro.training.optimizer import OptConfig
from repro.training.train_loop import make_train_step


def lower(cfg, shape, plan, mesh):
    """``lower_cell``'s lowering of one entry point, on ``mesh``."""
    specs = input_specs(cfg, shape, plan, mesh)
    if shape.kind == "train":
        opt_cfg = OptConfig(name=cfg.optimizer)
        p_sds, o_sds, _ = model_shardings(cfg, plan, mesh, opt_cfg)
        step = make_train_step(cfg, plan, mesh, opt_cfg)
        batch = dict(specs)
        fn = jax.jit(step,
                     in_shardings=(jax.tree.map(lambda s: s.sharding, p_sds),
                                   jax.tree.map(lambda s: s.sharding, o_sds),
                                   jax.tree.map(lambda s: s.sharding, batch)),
                     donate_argnums=(0, 1))
        return fn.lower(p_sds, o_sds, batch)
    p_sds, _, _ = model_shardings(cfg, plan, mesh)
    if shape.kind == "prefill":
        return jax.jit(lambda p, t: lm.prefill(p, cfg, plan, mesh, t)).lower(
            p_sds, specs["tokens"])
    return jax.jit(lambda p, t, c: lm.decode_step(
        p, cfg, plan, mesh, t, c)).lower(p_sds, specs["tokens"],
                                         specs["cache"])


def main(src: str, dst: str) -> None:
    with open(src, "rb") as f:
        cases = pickle.load(f)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         devices=jax.devices()[:4], **_axis_type_kwargs(2))
    out = {}
    for kind, (arch, shape, fields) in cases.items():
        compiled = lower(get_smoke_config(arch), ShapeConfig(*shape),
                         ShardingPlan(**fields), mesh).compile()
        s = analyze(compiled.as_text(), default_group=4)
        out[kind] = {"flops": s.flops,
                     "bytes": s.bytes_accessed,
                     "collectives": s.collective_wire_bytes}
    with open(dst, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
