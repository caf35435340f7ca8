#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py             # the full run: scale 30, p = 8
    python3 chip_smoke.py --scale 1   # a quicker rehearsal of the same phases

Phases, in order; any failure raises and the script exits non-zero:

1. environment: the card's name and power limit, torch, CUDA and nvcc;
2. build: ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` for sm_90a;
3. kernels against their plain versions on the card, on edge cases;
4. the main path: q1-q12 under the four default strategies on
   ``generate(scale, p=8, seed=0)`` on the card: one warm-up pass, then the
   reported pass, with every launch count set to 0 just before and read
   just after; every strategy must give the same rows, and every kernel
   must have launched. A third pass runs under ``torch.profiler`` for the
   device's busy share and its kernels by time. The largest input each
   kernel saw is kept, and each kernel, its plain version and one PyTorch
   call for the same function are timed on it with CUDA events;
5. cross-checks: the q1-q12 decisions at ``generate(0.1, 4, 42)`` equal the
   golden fixture, and at scale 3 the gather path (``use_kernel=False``)
   gives the rows of the kernel path.

It prints one JSON line of kernel measurements, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. It needs no
network; it imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: Published H100 SXM peaks (NVIDIA data sheet): device memory rate, and the
#: float32 rate outside the tensor cores, the only non-tensor peak given;
#: the kernels' integer compares are counted against it.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

GOLDEN = ROOT / "tests" / "fixtures" / "golden_plans.json"


class CheckFailed(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back runs, after one
    warm-up, between two CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time (ms) for moving ``nbytes`` and doing ``ops``, and which of
    the two sets it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions on edge cases
# ---------------------------------------------------------------------------

def check_kernels_edge_cases(dev) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bitonic_sort import MAX_TILE, bitonic_sort_tile
    from repro_torch.kernels.partition_hist import partition_hist
    from repro_torch.kernels.tiled_probe import tiled_probe

    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa

    n_cases = 0
    for n in (0, 1, 31, 1000, 100_003, 3_000_000):
        for nd in (4, 8, 128, 20000):
            d = t(rng.integers(-1, nd + 2, n).astype(np.int32))
            got = partition_hist(d, nd=nd)
            want = ref.partition_hist_ref(d, nd)
            require(torch.equal(got, want), f"partition_hist n={n} nd={nd}")
            n_cases += 1
    d = t(np.full(5000, -1, np.int32))
    require(int(partition_hist(d, nd=8).sum()) == 0, "partition_hist all -1")
    print(f"  partition_hist: {n_cases + 1} cases equal to the plain version")

    def probe_case(a, b, label):
        got = tiled_probe(t(a), t(b))
        want = ref.tiled_probe_ref(t(a), t(b))
        require(torch.equal(got, want), f"tiled_probe {label}")

    probe_case(np.array([[5, 9, 5]], np.int32),
               np.array([[1, 5, 3, 5]], np.int32), "first match")
    got = tiled_probe(t(np.array([5, 9, 5], np.int32)),
                      t(np.array([1, 5, 3, 5], np.int32)))
    require(got.tolist() == [1, -1, 1], "tiled_probe first-match values")
    got = tiled_probe(t(np.array([-1, -1, 3], np.int32)),
                      t(np.array([-2, 3, -2], np.int32)))
    require(got.tolist() == [-1, -1, 1], "tiled_probe sentinels")
    n_cases = 3
    for bsz, na, nb in ((1, 1, 1), (3, 7, 5), (5, 300, 700), (2, 1000, 5000),
                        (4, 513, 10000), (64, 960, 129), (3, 0, 10),
                        (3, 10, 0), (0, 10, 10)):
        hi = max(nb // 2, 2)
        a = rng.integers(-1, hi, (bsz, na)).astype(np.int32)
        b = rng.integers(-2, hi, (bsz, nb)).astype(np.int32)
        probe_case(a, b, f"B={bsz} na={na} nb={nb}")
        n_cases += 1
    print(f"  tiled_probe: {n_cases} cases equal to the plain version")

    n_cases = 0
    n = 1
    while n <= MAX_TILE:
        for bsz in (1, 3):
            k = t(rng.integers(-50, 50, (bsz, n)).astype(np.int32))
            v = t(np.tile(np.arange(n, dtype=np.int32), (bsz, 1)))
            gk, gv = bitonic_sort_tile(k, v)
            wk, _ = ref.bitonic_sort_ref(k, v)
            require(torch.equal(gk, wk), f"bitonic_sort_tile keys n={n}")
            require(torch.equal(torch.gather(k, 1, gv.long()), gk),
                    f"bitonic_sort_tile permutation n={n}")
            n_cases += 1
        n *= 2
    print(f"  bitonic_sort_tile: {n_cases} cases agree with the plain "
          "version (sorted keys equal, values address them)")


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

class LargestInputs:
    """Keeps, for each kernel wrapper, the arguments of its largest call.
    The wrapper itself still runs (and counts its launch) unchanged."""

    def __init__(self):
        self.calls: dict = {}

    def wrap(self, name, fn, size):
        def spy(*args, **kwargs):
            work = size(*args, **kwargs)
            if work > self.calls.get(name, (-1,))[0]:
                self.calls[name] = (work, args, kwargs)
            return fn(*args, **kwargs)
        return spy

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.joins import exchange
        from repro_torch.kernels import ops
        saved = (exchange.partition_hist, ops.tiled_probe,
                 ops.bitonic_sort_tile)
        exchange.partition_hist = self.wrap(
            "partition_hist", saved[0], lambda d, **kw: d.numel())
        ops.tiled_probe = self.wrap(
            "tiled_probe", saved[1], lambda a, b: a.numel() * b.shape[-1])
        ops.bitonic_sort_tile = self.wrap(
            "bitonic_sort_tile", saved[2], lambda k, v: k.numel())
        try:
            yield self
        finally:
            (exchange.partition_hist, ops.tiled_probe,
             ops.bitonic_sort_tile) = saved


def float_gap(rows_a, rows_b) -> float:
    """Largest relative difference between two sorted row lists."""
    worst = 0.0
    for ra, rb in zip(rows_a, rows_b):
        for x, y in zip(ra, rb):
            scale = max(abs(x), abs(y))
            if scale > 0:
                worst = max(worst, abs(x - y) / scale)
    return worst


def run_main_path(dev, scale: float, p: int):
    import numpy as np
    import torch

    from repro_torch.joins.ref import rows_as_set, rows_close
    from repro_torch.kernels import ops
    from repro_torch.sql import (Executor, all_queries, default_strategies,
                                 generate)

    t0 = time.perf_counter()
    catalog = generate(scale=scale, p=p, seed=0, device=dev)
    torch.cuda.synchronize()
    rows = {n: t.count() for n, t in catalog.tables.items()}
    print(f"  generate(scale={scale}, p={p}, seed=0): "
          f"{time.perf_counter() - t0:.1f} s; store_sales "
          f"{rows['store_sales']} rows, catalog_sales "
          f"{rows['catalog_sales']}, inventory {rows['inventory']}")
    base_bytes = sum(c.numel() * c.element_size() + t.valid.numel()
                     for t in catalog.tables.values()
                     for c in t.columns.values())
    print(f"  base columns on the device: {base_bytes / 1e6:.1f} MB")

    queries, strategies = all_queries(), default_strategies()

    def run_all():
        for qname, plan in queries.items():
            for s in strategies:
                yield qname, s, Executor(catalog, s).execute(plan)

    t_warm = time.perf_counter()
    for _ in run_all():  # first calls of every torch op, not reported
        pass
    print(f"  warm-up pass: {time.perf_counter() - t_warm:.1f} s")

    spy = LargestInputs()
    results: dict = {}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_phase = time.perf_counter()
    with spy.installed():
        before = ops.launch_counts()
        for qname, s, res in run_all():
            after = ops.launch_counts()
            delta = ",".join(str(after[k] - before[k]) for k in after)
            before = after
            cols = res.table.to_numpy()
            results[(qname, s.name)] = cols
            print(f"  {qname:20s} {s.name:13s} "
                  f"{','.join(m.value for m in res.methods()):40s} "
                  f"net={res.network_bytes:.0f} rows={res.rows} "
                  f"wall={res.wall_time_s:.4f}s launches={delta}")
            for name, c in cols.items():
                if c.dtype.kind == "f":
                    require(bool(np.isfinite(c).all()),
                            f"{qname} {s.name}: non-finite {name}")
    launches = ops.launch_counts()
    print(f"  main path: {time.perf_counter() - t_phase:.1f} s for "
          f"{len(queries) * len(strategies)} runs; launches {launches}")
    print(f"  torch.cuda.max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} never launched on the main path")

    for qname in queries:
        first = rows_as_set(results[(qname, strategies[0].name)])
        gap = 0.0
        for s in strategies[1:]:
            other = rows_as_set(results[(qname, s.name)])
            require(rows_close(first, other),
                    f"{qname}: {s.name} rows differ from "
                    f"{strategies[0].name}")
            gap = max(gap, float_gap(first, other))
        print(f"  {qname:20s} {len(first)} rows agree across strategies; "
              f"worst relative gap {gap:.3e}")

    profile_pass(run_all)
    return launches, spy.calls


def profile_pass(run_all) -> None:
    """One more pass over the main path under ``torch.profiler``: the
    device's busy and idle share of the pass's wall time, and the kernels
    that take the device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in run_all():
            pass
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not spans:
        print("  profile: the profiler recorded no device time "
              "(device busy share not measured)")
        return
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):  # union of the device intervals
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    total = sum(us for _, us in by_name.values())
    print(f"  profile pass: wall {wall_us / 1e3:.1f} ms (profiler on), "
          f"device busy {busy / 1e3:.1f} ms, idle share "
          f"{1 - busy / wall_us:.3f}; {sum(n for n, _ in by_name.values())} "
          "device activities")
    print("  device time by kernel:")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (n, us) in top:
        print(f"    {us / 1e3:9.2f} ms {us / total:6.1%} x{n:<5d} {name[:90]}")
    print("  device time by the PyTorch op that launched it:")
    launchers = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CPU
                 and e.self_device_time_total > 0]
    for e in sorted(launchers, key=lambda e: -e.self_device_time_total)[:10]:
        us = e.self_device_time_total
        print(f"    {us / 1e3:9.2f} ms {us / total:6.1%} x{e.count:<5d} {e.key}")


# ---------------------------------------------------------------------------
# Kernel timings at the main path's largest shapes
# ---------------------------------------------------------------------------

def measure_kernels(calls: dict, launches: dict) -> list:
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bitonic_sort import bitonic_sort_tile
    from repro_torch.kernels.partition_hist import partition_hist
    from repro_torch.kernels.tiled_probe import tiled_probe

    rows = []

    _, (dest,), kw = calls["partition_hist"]
    nd = kw["nd"]
    n = dest.numel()
    got, want = partition_hist(dest, nd=nd), ref.partition_hist_ref(dest, nd)
    err = float((got - want).abs().max())
    shifted = dest + 1  # bincount's yardstick: bin 0 takes the -1 rows
    b_ms, b_by = bound(4 * n + 4 * nd, n)
    rows.append(dict(
        name="partition_hist", route="cuda",
        source="src/repro_torch/csrc/partition_hist.cu",
        replaces="src/repro/kernels/partition_hist.py:46",
        launches=launches["partition_hist"], max_abs_err=err,
        ms=cuda_ms(lambda: partition_hist(dest, nd=nd), 50),
        plain_ms=cuda_ms(lambda: ref.partition_hist_ref(dest, nd), 20),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.bincount(shifted,
                                                  minlength=nd + 1), 50),
        shape=f"n={n} nd={nd}"))

    _, (a, b), _ = calls["tiled_probe"]
    bsz, na = a.shape
    nb = b.shape[1]
    got, want = tiled_probe(a, b), ref.tiled_probe_ref(a, b)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    # Compares this data needs: up to the first hit, all nb on a miss.
    compares = float(torch.where(want >= 0, want + 1, nb).sum())
    b_ms, b_by = bound(4 * (2 * bsz * na + bsz * nb), compares)
    rows.append(dict(
        name="tiled_probe", route="cuda",
        source="src/repro_torch/csrc/tiled_probe.cu",
        replaces="src/repro/kernels/tiled_probe.py:72",
        launches=launches["tiled_probe"], max_abs_err=err,
        ms=cuda_ms(lambda: tiled_probe(a, b), 20),
        plain_ms=cuda_ms(lambda: ref.tiled_probe_ref(a, b), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"B={bsz} na={na} nb={nb}"))

    _, (k, v), _ = calls["bitonic_sort_tile"]
    bsz, n = k.shape
    gk, gv = bitonic_sort_tile(k, v)
    wk, _ = ref.bitonic_sort_ref(k, v)
    # The sort is not stable: compare the keys, and the keys the values
    # address (v holds row ids on the main path).
    err = max(float((gk - wk).abs().max()),
              float((torch.gather(k, 1, gv.long()) - gk).abs().max()))
    logn = int(math.log2(n))
    b_ms, b_by = bound(16 * bsz * n, bsz * n // 2 * logn * (logn + 1) // 2)
    rows.append(dict(
        name="bitonic_sort_tile", route="cuda",
        source="src/repro_torch/csrc/bitonic_sort.cu",
        replaces="src/repro/kernels/bitonic_sort.py:66",
        launches=launches["bitonic_sort_tile"], max_abs_err=err,
        ms=cuda_ms(lambda: bitonic_sort_tile(k, v), 50),
        plain_ms=cuda_ms(lambda: ref.bitonic_sort_ref(k, v), 50),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.sort(k, dim=-1), 50),
        shape=f"B={bsz} n={n}"))

    for r in rows:
        require(r["max_abs_err"] == 0, f"{r['name']} disagrees with its "
                f"plain version at {r['shape']}")
        lib = ("none (no single PyTorch call computes it)"
               if r["library_ms"] is None else f"{r['library_ms']:.4f} ms")
        print(f"  {r['name']:18s} {r['shape']:22s} kernel {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library {lib}")
    return rows


# ---------------------------------------------------------------------------
# Phase 5: cross-checks
# ---------------------------------------------------------------------------

def check_golden(dev) -> None:
    from repro_torch.sql import (Executor, all_queries, default_strategies,
                                 generate)

    gold = json.loads(GOLDEN.read_text())["queries"]
    catalog = generate(0.1, 4, 42, device=dev)
    n = 0
    for qname, plan in all_queries().items():
        for s in default_strategies():
            res = Executor(catalog, s).execute(plan)
            got = [{"method": d.selection.method.value,
                    "swapped": bool(d.selection.swapped_sides)}
                   for d in res.decisions]
            require(got == gold[qname]["strategies"][s.name],
                    f"{qname} {s.name}: decisions {got} differ from the "
                    "golden fixture")
            n += 1
    print(f"  golden decisions at generate(0.1, 4, 42): {n} of {n} equal")


def check_gather_path(dev) -> None:
    from repro_torch.joins.ref import rows_as_set, rows_close
    from repro_torch.sql import (Executor, all_queries, default_strategies,
                                 generate)

    catalog = generate(3, 8, 0, device=dev)
    n = 0
    for qname, plan in all_queries().items():
        for s in default_strategies():
            k = Executor(catalog, s, use_kernel=True).execute(plan)
            g = Executor(catalog, s, use_kernel=False).execute(plan)
            require(k.methods() == g.methods(), f"{qname} {s.name} methods")
            require(k.network_bytes == g.network_bytes,
                    f"{qname} {s.name} network bytes")
            require(rows_close(rows_as_set(k.table.to_numpy()),
                               rows_as_set(g.table.to_numpy())),
                    f"{qname} {s.name}: gather path rows differ")
            n += 1
    print(f"  scale 3: use_kernel=False rows equal use_kernel=True in "
          f"{n} of {n} runs")


# ---------------------------------------------------------------------------


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scale", type=float, default=30.0,
                        help="main-path catalog scale (default 30)")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    smi = nvidia_smi()
    print("== 1. environment")
    print(smi)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    nvcc = build.find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    print(" ".join(line.strip() for line in version.splitlines()
                   if "release" in line or line.startswith("Build")))

    print("== 2. build")
    t0 = time.perf_counter()
    build.library()
    print(f"  built {', '.join(s.name for s in build.sources())} in "
          f"{time.perf_counter() - t0:.1f} s (cached={build.build_log['cached']})")
    for src, report in build.build_log.get("ptxas", {}).items():
        for line in report.splitlines():
            if "Used" in line:
                print(f"  {src}: {line.strip()}")

    print("== 3. kernels against their plain versions")
    check_kernels_edge_cases(dev)

    print("== 4. main path")
    launches, calls = run_main_path(dev, args.scale, p=8)
    print("  kernel timings at the main path's largest inputs "
          f"({smi}):")
    rows = measure_kernels(calls, launches)

    print("== 5. cross-checks")
    check_golden(dev)
    check_gather_path(dev)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
