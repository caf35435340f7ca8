"""The readings that the limits of ``limits/<workload>.json`` are set
from, many seeds in one process (the kernels are built once).

    python3 perfbench/calibrate.py --workload sf1.adhoc --seconds 6 \\
        --seeds 11 12 13 --control-seeds 21 22 23
    python3 perfbench/calibrate.py --config tpcds_sf10 --traffic adhoc \\
        --seconds 6 --seeds 11

A configuration and a mix that are no cell yet are named by
``--config`` and ``--traffic``.

For each ``--seeds`` seed: the cell's set-up, a window of ``--seconds`` at
the cell's own load, and the comparison of a run, printed as one JSON
line (the program's readings). For each ``--control-seeds`` seed: the
same comparison with the reference computed in bfloat16 in the program's
place, over the instances the cell's traffic sends first (the control's
readings). Not run by the benchmark's own runs.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def control_records(cell, count: int):
    """Records of the first instances each client sends, as many as
    ``count`` distinct ones and every template, marked answered."""
    from perfbench.cell import Record

    streams = cell.mix.streams(cell.seed)
    records, keys = [], set()
    templates = {t.name for t in cell.mix.templates}
    while len(keys) < count or templates:
        for c, stream in enumerate(streams):
            inst = next(stream)
            keys.add(inst.key)
            templates.discard(inst.template.name)
            records.append(Record(c, inst, 0.0, 0.0, latency_s=0.0, ok=True))
        if len(records) > 50 * count:
            break
    return records


def main(argv=None) -> int:
    import torch

    from perfbench import cell as cellmod
    from perfbench.run import _environment

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--factor", type=float, default=1.0)
    args = ap.parse_args(argv)
    _environment()

    def open_cell(seed):
        kw = dict(device=args.device, factor=args.factor)
        if args.workload:
            return cellmod.Cell.for_workload(args.workload, seed, root=ROOT,
                                             **kw)
        return cellmod.Cell.named(args.config, args.traffic, seed, **kw)

    for seed in args.seeds:
        t0 = time.perf_counter()
        c = open_cell(seed)
        c.warm_up()
        records, window_s = c.window(args.seconds)
        c.free_program()
        res = c.check(records)
        failed = sum(not r.ok for r in records)
        print(json.dumps({"side": "program", "seed": seed,
                          "queries": len(records), "failed": failed,
                          "window_s": window_s, **res,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del c
        gc.collect()
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        c = open_cell(seed)
        c.free_program()
        res = c.check(control_records(c, c.mix.check),
                      control=torch.bfloat16)
        print(json.dumps({"side": "control_bf16", "seed": seed, **res,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del c
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
