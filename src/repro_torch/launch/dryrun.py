"""Multi-pod dry run: the reference's ``launch/dryrun.py`` for the port.

For every (architecture x input shape x mesh) cell: build the production
mesh (16x16 = 256 ranks or 2x16x16 = 512) on a fake process group, derive
the RelShard plan, take rank 0's blocks of meta tensors (the right shapes
and dtypes, no memory) and run the cell's entry point (the train step,
``lm.prefill`` or ``lm.decode_step``) on them under ``hlo_cost.count``.
Nothing is allocated on any device. Rank 0 stands for every rank: the
program is SPMD and the specs give every rank blocks of one shape. Each
record holds the per-device FLOPs, HBM bytes, collective wire bytes and
calls, the memory estimate, the roofline's terms on H100 constants and
``model_flops``' ratio to the counted FLOPs; records go to
``experiments/dryrun_torch/``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Each (cell, mesh) runs in a child process of its own (the fake group's
world differs between the meshes, and a cell's state goes with its
process), as many at a time as the machine has cores but one.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist

from ..configs import ARCH_ALIASES, ARCH_IDS, get_config
from ..core.relshard import plan_model
from ..models import lm
from ..models import sharding as sh
from ..models.config import SHAPES, SHAPE_BY_NAME, shape_applicable
from ..training.optimizer import OptConfig
from ..training.train_loop import make_train_step
from . import hlo_cost
from .mesh import make_production_mesh, mesh_axes
from .roofline import model_flops, roofline_from_counts
from .specs import input_specs, model_shardings

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")


@contextlib.contextmanager
def fake_world(world_size: int):
    """A process group of ``world_size`` ranks in which this process is
    rank 0 and every collective completes at once without moving data
    (``torch.testing``'s fake backend): enough for meta tensors."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _blocks(pairs, mesh):
    """This rank's block of every (meta tensor, P) pair of a tree."""
    if isinstance(pairs, dict):
        return {k: _blocks(v, mesh) for k, v in pairs.items()}
    t, spec = pairs
    return sh.shard(t, spec, mesh)


def count_program(cfg, shape, plan, mesh):
    """Count one cell's entry point on ``mesh`` (a ``Mesh`` on meta over
    the current group): (``CostSummary``, ``MemoryCounts``, seconds)."""
    specs = input_specs(cfg, shape, plan, mesh)
    t0 = time.time()
    if shape.kind == "train":
        opt_cfg = OptConfig(name=cfg.optimizer)
        p_sds, o_sds, _ = model_shardings(cfg, plan, mesh, opt_cfg)
        batch = {k: t for k, (t, _) in specs.items()}
        step = make_train_step(cfg, plan, mesh, opt_cfg)
        _, summary, mem = hlo_cost.count(step, _blocks(p_sds, mesh),
                                         _blocks(o_sds, mesh), batch,
                                         mesh=mesh)
    elif shape.kind == "prefill":
        p_sds, _, _ = model_shardings(cfg, plan, mesh)

        def entry(params, tokens, cond_emb=None):
            with torch.no_grad():
                return lm.prefill(params, cfg, plan, mesh, tokens, cond_emb)
        args = [_blocks(p_sds, mesh), specs["tokens"][0]]
        if "cond_emb" in specs:
            args.append(specs["cond_emb"][0])
        _, summary, mem = hlo_cost.count(entry, *args, mesh=mesh)
    else:  # decode
        p_sds, _, _ = model_shardings(cfg, plan, mesh)

        def entry(params, tokens, cache):
            with torch.no_grad():
                return lm.decode_step(params, cfg, plan, mesh, tokens, cache,
                                      max_seq=shape.seq_len)
        _, summary, mem = hlo_cost.count(
            entry, _blocks(p_sds, mesh), specs["tokens"][0],
            _blocks(specs["cache"], mesh), mesh=mesh)
    return summary, mem, time.time() - t0


def count_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: dict | None = None):
    """Count one cell on its production mesh; returns (record, summary),
    summary None for a skipped cell."""
    mesh_tag = "multi" if multi_pod else "single"
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPE_BY_NAME[shape_name]
    skip = shape_applicable(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                "status": "skip", "reason": skip}, None
    if shape_name == "long_500k" and cfg.attn_window == 0 \
            and cfg.family.value == "hybrid":
        cfg = dataclasses.replace(cfg, attn_window=4096)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        plan = plan_model(cfg, mesh_axes(mesh), shape)
        summary, mem, seconds = count_program(cfg, shape, plan, mesh)
        n_dev = mesh.size
    rf = roofline_from_counts(summary, n_dev)
    mf = model_flops(cfg, shape)
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "status": "ok",
        "chips": n_dev,
        "plan": {"embed": plan.embed_strategy, "head": plan.head_strategy,
                 "moe": plan.moe_strategy, "w": plan.w},
        "memory": {
            "argument_bytes_per_device": mem.argument_bytes,
            "output_bytes_per_device": mem.output_bytes,
            "temp_bytes_per_device": mem.temp_bytes,
            "alias_bytes_per_device": mem.alias_bytes,
            "peak_estimate_per_device": mem.peak_estimate,
        },
        "cost": {"flops_per_device": rf.flops / n_dev,
                 "bytes_per_device": rf.hbm_bytes / n_dev},
        "collectives_per_device": rf.per_collective,
        "collective_calls_per_device": summary.collective_calls,
        "roofline": {"compute_s": rf.compute_s, "memory_s": rf.memory_s,
                     "collective_s": rf.collective_s, "bound": rf.bound,
                     "step_time_s": rf.step_time_s()},
        "model_flops": mf,
        "model_flops_ratio": rf.model_flops_ratio(mf),
        "count_s": round(seconds, 1),
    }
    return record, summary


def _fname(out_dir: str, arch: str, shape_name: str, mesh_tag: str) -> str:
    return os.path.join(out_dir, f"{arch}_{shape_name}_{mesh_tag}.json")


def run_and_save(arch, shape_name, multi_pod, out_dir=RESULTS_DIR,
                 overrides=None):
    """Count one cell in this process and write its record (an error is
    recorded, not raised)."""
    os.makedirs(out_dir, exist_ok=True)
    mesh_tag = "multi" if multi_pod else "single"
    try:
        record, _ = count_cell(arch, shape_name, multi_pod, overrides)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        record = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                  "status": "error", "error": f"{type(e).__name__}: {e}",
                  "trace": traceback.format_exc()[-2000:]}
    with open(_fname(out_dir, arch, shape_name, mesh_tag), "w") as f:
        json.dump(record, f, indent=1)
    status = record["status"]
    extra = (f" bound={record['roofline']['bound']}"
             f" step={record['roofline']['step_time_s']:.4f}s"
             f" count={record['count_s']}s"
             if status == "ok" else
             record.get("reason", record.get("error", ""))[:120])
    print(f"[dryrun] {arch:22s} {shape_name:12s} {mesh_tag:6s} "
          f"{status.upper():5s} {extra}", flush=True)
    return record


#: (cell, mesh) children at a time: one a core but one
SIDE_BY_SIDE = max(1, (os.cpu_count() or 2) - 1)


def _child(arch: str, shape_name: str, mesh_tag: str, out_dir: str) -> dict:
    """One (cell, mesh) in a child process of its own; its record. The
    cell's old record goes first, and a child that does not exit 0 leaves
    an error record whatever its file holds."""
    env = dict(os.environ)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       ".."))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    code = ("from repro_torch.launch.dryrun import run_and_save; "
            f"run_and_save({arch!r}, {shape_name!r}, {mesh_tag == 'multi'}, "
            f"{out_dir!r})")
    fname = _fname(out_dir, arch, shape_name, mesh_tag)
    with contextlib.suppress(FileNotFoundError):
        os.remove(fname)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True)
    if proc.returncode == 0:
        with contextlib.suppress(OSError, ValueError), open(fname) as f:
            record = json.load(f)
            print(proc.stdout, end="", flush=True)
            return record
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
              "status": "error",
              "error": f"child exited {proc.returncode}: "
                       f"{proc.stderr[-1500:]}"}
    with open(fname, "w") as f:
        json.dump(record, f, indent=1)
    print(f"[dryrun] {arch:22s} {shape_name:12s} {mesh_tag:6s} ERROR "
          f"child exited {proc.returncode}", flush=True)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="architecture id (hyphenated ok)")
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for s in SHAPES:
                cells.append((arch, s.name))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells.append((ARCH_ALIASES.get(args.arch, args.arch), args.shape))

    os.makedirs(args.out, exist_ok=True)
    todo = []
    for arch, shape_name in cells:
        for tag in meshes:
            fname = _fname(args.out, arch, shape_name, tag)
            if args.skip_existing and os.path.exists(fname):
                with open(fname) as f:
                    if json.load(f).get("status") in ("ok", "skip"):
                        continue
            todo.append((arch, shape_name, tag, args.out))
    # the longest first: prefill's chunk loops, the deepest models
    todo.sort(key=lambda c: (c[1] != "prefill_32k",
                             -get_config(c[0]).n_layers))
    with ThreadPoolExecutor(max_workers=SIDE_BY_SIDE) as pool:
        records = list(pool.map(lambda a: _child(*a), todo))
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skip" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skip, {n_err} error")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
