#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py             # the full run: scale 30, p = 8
    python3 chip_smoke.py --scale 1   # a quicker rehearsal of the same phases

Phases, in order; any failure raises and the script exits non-zero:

1. environment: the card's name and power limit, torch, CUDA and nvcc;
2. build: ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` for sm_90a;
3. kernels against their plain versions on the card, on edge cases (the
   filter kernels bit for bit);
4. the main path: q1-q12 under the four default strategies on
   ``generate(scale, p=8, seed=0)`` on the card: one warm-up pass, then the
   reported pass, with every launch count set to 0 just before and read
   just after; every strategy must give the same rows, and every kernel
   of the path must have launched. A third pass runs under
   ``torch.profiler`` for the device's busy share and its kernels by time.
   The largest input each kernel saw is kept, and each kernel, its plain
   version and one PyTorch call for the same function are timed on it
   with CUDA events (the kernel also by its device time alone, from the
   profiler);
5. runtime filters on the same catalog: q19-q23 under
   ``FilteredStrategy(s)`` for each default strategy, after a warm-up pass
   and beside the unfiltered runs: the same rows, the planned filter kinds,
   fewer probe-side shuffle bytes over the suite, and the filter kernels
   launched (counts set to 0 just before the filtered pass and read just
   after); then the suite again against one shared ``FilterCache``, warm;
   one pass under ``torch.profiler``; then the filter kernels timed at
   their largest inputs, as in phase 4;
6. cross-checks: the q1-q12 and (unfiltered) q19-q23 decisions at
   ``generate(0.1, 4, 42)`` equal the golden fixture, the filtered runs'
   filters and methods there equal those of the same runs on the CPU, and
   at scale 3 the gather path (``use_kernel=False``) gives the rows of the
   kernel path.

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


def device_ms(fn, reps: int) -> float:
    """Mean milliseconds of device activity (kernels, memsets, copies) that
    one call of ``fn`` puts on the card, from ``torch.profiler``: the
    kernel's own time, without the host's launch cost between calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / reps / 1e3


def time_kernel(fn, reps: int) -> dict:
    """``ms``: CUDA events around ``reps`` back-to-back wrapper calls, host
    launch cost included where it outlasts the device work; ``device_ms``:
    the device time alone."""
    return dict(ms=cuda_ms(fn, reps), device_ms=device_ms(fn, reps))


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


def check_filter_kernels_edge_cases(dev) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bloom import bloom_build, bloom_probe
    from repro_torch.kernels.zone_map import key_range

    rng = np.random.default_rng(1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    extremes = np.array([0, -1, -(2 ** 31), 2 ** 31 - 1], np.int32)

    def cases():
        for n in (0, 1, 31, 1000, 100_003):
            keys = rng.integers(-(2 ** 31), 2 ** 31 - 1, n,
                                dtype=np.int64).astype(np.int32)
            keys[:min(n, 4)] = extremes[:min(n, 4)]
            for mask in ("all", "none", "random"):
                valid = (np.full(n, mask == "all") if mask != "random"
                         else rng.random(n) < 0.5)
                yield f"n={n} {mask}", t(keys), t(valid)
        keys = rng.integers(-5000, 5000, (8, 12_500)).astype(np.int32)
        keys[0, :4] = extremes
        yield "(8, 12500) random", t(keys), t(rng.random((8, 12_500)) < 0.5)

    n_bloom = n_range = 0
    for label, keys, valid in cases():
        flat_k, flat_v = keys.reshape(-1), valid.reshape(-1)
        for m_bits in (32, 256, 65536, 1 << 20):
            for k in (1, 7, 8):
                words = bloom_build(keys, valid, m_bits=m_bits, k=k)
                want = ref.bloom_build_ref(flat_k, flat_v, m_bits, k)
                require(torch.equal(words, want),
                        f"bloom_build {label} m_bits={m_bits} k={k}")
                keep = bloom_probe(keys, words, k=k)
                require(keep.shape == keys.shape and torch.equal(
                    keep.reshape(-1), ref.bloom_probe_ref(flat_k, words, k)),
                    f"bloom_probe {label} m_bits={m_bits} k={k}")
                require(bool(keep[valid].all()),
                        f"bloom_probe false negative {label}")
                n_bloom += 1
        got = key_range(keys, valid)
        require(torch.equal(got, ref.key_range_ref(flat_k, flat_v)),
                f"key_range {label}: {got.tolist()}")
        n_range += 1
    print(f"  bloom_build, bloom_probe: {n_bloom} cases each bit-identical "
          "to the plain versions, no false negatives")
    print(f"  key_range: {n_range} cases equal to the plain version")


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
        from repro_torch.sql import runtime_filters as rf
        sizes = {"partition_hist": lambda d, **kw: d.numel(),
                 "tiled_probe": lambda a, b: a.numel() * b.shape[-1],
                 "bitonic_sort_tile": lambda k, v: k.numel(),
                 "bloom_build": lambda keys, *a, **kw: keys.numel(),
                 "bloom_probe": lambda keys, *a, **kw: keys.numel(),
                 "key_range": lambda keys, *a, **kw: keys.numel()}
        callers = {"partition_hist": exchange, "tiled_probe": ops,
                   "bitonic_sort_tile": ops, "bloom_build": rf,
                   "bloom_probe": rf, "key_range": rf}
        saved = {name: getattr(mod, name) for name, mod in callers.items()}
        for name, mod in callers.items():
            setattr(mod, name, self.wrap(name, saved[name], sizes[name]))
        try:
            yield self
        finally:
            for name, mod in callers.items():
                setattr(mod, name, saved[name])


def float_gap(rows_a, rows_b) -> float:
    """Largest relative difference between two sorted row lists."""
    worst = 0.0
    for ra, rb in zip(rows_a, rows_b):
        for x, y in zip(ra, rb):
            scale = max(abs(x), abs(y))
            if scale > 0:
                worst = max(worst, abs(x - y) / scale)
    return worst


#: The kernels the main path (q1-q12) runs, and those the runtime-filter
#: path adds.
MAIN_KERNELS = ("partition_hist", "tiled_probe", "bitonic_sort_tile")
FILTER_KERNELS = ("bloom_build", "bloom_probe", "key_range")


def make_catalog(dev, scale: float, p: int):
    import torch

    from repro_torch.sql import generate

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
    return catalog


def run_main_path(catalog):
    import numpy as np
    import torch

    from repro_torch.joins.ref import rows_as_set, rows_close
    from repro_torch.kernels import ops
    from repro_torch.sql import Executor, all_queries, default_strategies

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
    for name in MAIN_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} never launched on the main path")

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
        **time_kernel(lambda: partition_hist(dest, nd=nd), 50),
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
        **time_kernel(lambda: tiled_probe(a, b), 20),
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
        **time_kernel(lambda: bitonic_sort_tile(k, v), 50),
        plain_ms=cuda_ms(lambda: ref.bitonic_sort_ref(k, v), 50),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.sort(k, dim=-1), 50),
        shape=f"B={bsz} n={n}"))

    report_kernels(rows)
    return rows


# ---------------------------------------------------------------------------
# Phase 5: runtime filters
# ---------------------------------------------------------------------------

#: The filter kind each of q19-q23 plans on ``generate(0.1, 4, 42)``, as
#: the reference plans it there.
FILTER_KIND = {"q19_filtered_customer": "bloom",
               "q20_filter_below_earlier_exchange": "bloom",
               "q21_catalog_filtered_dates": "bloom",
               "q22_zone_map_window": "zone_map",
               "q23_semi_join_stores": "semi_join"}
#: ... and on the main path's catalog (seed 0, any scale: the dimensions do
#: not scale). There 9 of the 60 stores pass q23's ``s_state = 0``, so the
#: exact key list (288 bits) costs more than the 256-bit minimum bloom
#: filter, and q23 plans bloom, as the reference does on that catalog.
FILTER_KIND_SEED0 = {**FILTER_KIND, "q23_semi_join_stores": "bloom"}


def describe_filters(res) -> str:
    return "; ".join(f"{f.plan.kind} m_bits={f.plan.m_bits} k={f.plan.k} "
                     f"{f.plan.probe_key} {f.rows_before}->{f.rows_after}"
                     for f in res.filters)


def run_filter_path(catalog):
    import numpy as np

    from repro_torch.joins.ref import rows_as_set, rows_close
    from repro_torch.kernels import ops
    from repro_torch.sql import (Executor, FilterCache, FilteredStrategy,
                                 default_strategies, filtered_queries)

    queries, strategies = filtered_queries(), default_strategies()
    require(sorted(queries) == sorted(FILTER_KIND_SEED0), "q19-q23 suite")

    def run_suite(make):
        for qname, plan in queries.items():
            for s in strategies:
                yield qname, s, Executor(catalog, make(s)).execute(plan)

    t_warm = time.perf_counter()
    for make in (FilteredStrategy, lambda s: s):  # first calls, not reported
        for _ in run_suite(make):
            pass
    print(f"  warm-up pass (filtered and unfiltered): "
          f"{time.perf_counter() - t_warm:.1f} s")

    base = {}
    for qname, s, res in run_suite(lambda s: s):
        base[(qname, s.name)] = (rows_as_set(res.table.to_numpy()),
                                 res.probe_shuffle_bytes, res.wall_time_s,
                                 res.network_bytes)

    spy = LargestInputs()
    filtered = {}
    ops.reset_launch_counts()
    t_phase = time.perf_counter()
    with spy.installed():
        before = ops.launch_counts()
        for qname, s, res in run_suite(FilteredStrategy):
            after = ops.launch_counts()
            delta = ",".join(str(after[k] - before[k]) for k in after)
            before = after
            cols = res.table.to_numpy()
            print(f"  {qname:34s} {s.name:13s} "
                  f"{','.join(m.value for m in res.methods()):29s} "
                  f"net={res.network_bytes:.0f} "
                  f"probe_shuffle={res.probe_shuffle_bytes:.0f} "
                  f"rows={res.rows} wall={res.wall_time_s:.4f}s "
                  f"launches={delta} filters: {describe_filters(res)}")
            require(len(res.filters) >= 1, f"{qname} {s.name}: no filter")
            kinds = {f.plan.kind for f in res.filters}
            require(kinds == {FILTER_KIND_SEED0[qname]},
                    f"{qname} {s.name}: planned {sorted(kinds)}")
            require(rows_close(rows_as_set(cols), base[(qname, s.name)][0]),
                    f"{qname} {s.name}: filtered rows differ from the "
                    "unfiltered run")
            for name, c in cols.items():
                if c.dtype.kind == "f":
                    require(bool(np.isfinite(c).all()),
                            f"{qname} {s.name}: non-finite {name}")
            filtered[(qname, s.name)] = (res.probe_shuffle_bytes,
                                         res.wall_time_s, res.network_bytes)
    launches = ops.launch_counts()
    print(f"  filter path: {time.perf_counter() - t_phase:.1f} s for "
          f"{len(filtered)} runs; launches {launches}")
    for name in ("partition_hist", "tiled_probe") + FILTER_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} never launched on the filter path")

    print("  per query, unfiltered -> filtered: probe-shuffle bytes, "
          "wall ms (suite sums per strategy below)")
    for qname in queries:
        cells = []
        for s in strategies:
            b, f = base[(qname, s.name)], filtered[(qname, s.name)]
            cells.append(f"{s.name} {b[1]:.0f}->{f[0]:.0f} "
                         f"{b[2] * 1e3:.2f}->{f[1] * 1e3:.2f}")
        print(f"    {qname:34s} " + " | ".join(cells))
    suite = {"unfiltered": sum(v[1] for v in base.values()),
             "filtered": sum(v[0] for v in filtered.values())}
    for s in strategies:
        print(f"    suite {s.name:13s} probe-shuffle "
              f"{sum(base[(q, s.name)][1] for q in queries):.0f} -> "
              f"{sum(filtered[(q, s.name)][0] for q in queries):.0f}, "
              f"network {sum(base[(q, s.name)][3] for q in queries):.0f} -> "
              f"{sum(filtered[(q, s.name)][2] for q in queries):.0f}, wall "
              f"{sum(base[(q, s.name)][2] for q in queries) * 1e3:.2f} -> "
              f"{sum(filtered[(q, s.name)][1] for q in queries) * 1e3:.2f} "
              "ms")
    print(f"  suite probe-shuffle bytes: unfiltered {suite['unfiltered']:.0f}"
          f", filtered {suite['filtered']:.0f} "
          f"({suite['unfiltered'] / max(suite['filtered'], 1):.2f}x fewer)")
    require(suite["filtered"] < suite["unfiltered"],
            "filters did not cut the suite's probe-shuffle bytes")

    cache = FilterCache()
    cached = lambda s: FilteredStrategy(s, cache=cache)  # noqa: E731
    for _ in run_suite(cached):  # fills the cache
        pass
    hits, n = cache.hits, 0
    for qname, s, res in run_suite(cached):
        require(res.cached_filters >= 1 and res.filter_reduce_bytes == 0,
                f"{qname} {s.name}: warm run built a filter")
        require(rows_close(rows_as_set(res.table.to_numpy()),
                           base[(qname, s.name)][0]),
                f"{qname} {s.name}: warm-cache rows differ")
        n += 1
    print(f"  warm FilterCache: {n} of {n} runs took every filter from the "
          f"cache ({cache.hits - hits} hits, {len(cache)} entries), reduce "
          "bytes 0, rows unchanged")

    profile_pass(lambda: run_suite(FilteredStrategy))
    return launches, spy.calls


def measure_filter_kernels(calls: dict, launches: dict) -> list:
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bloom import bloom_build, bloom_probe
    from repro_torch.kernels.zone_map import key_range

    rows = []

    # Operation counts: the two 32-bit hashes of a key take 13 integer
    # operations (two mix chains and the odd-forcing OR), each bit position
    # and its word update or test 7 more.
    _, (keys, valid), kw = calls["bloom_build"]
    m_bits, k = kw["m_bits"], kw["k"]
    flat_k, flat_v = keys.reshape(-1), valid.reshape(-1)
    n, n_valid = flat_k.numel(), int(flat_v.sum())
    got = bloom_build(keys, valid, m_bits=m_bits, k=k)
    want = ref.bloom_build_ref(flat_k, flat_v, m_bits, k)
    b_ms, b_by = bound(5 * n + m_bits // 8, n + n_valid * (13 + 7 * k))
    rows.append(dict(
        name="bloom_build", route="cuda",
        source="src/repro_torch/csrc/bloom.cu",
        replaces="src/repro/kernels/bloom.py:140",
        launches=launches["bloom_build"],
        max_abs_err=float((got.long() - want.long()).abs().max()),
        **time_kernel(lambda: bloom_build(keys, valid, m_bits=m_bits,
                                          k=k), 200),
        plain_ms=cuda_ms(lambda: ref.bloom_build_ref(flat_k, flat_v, m_bits,
                                                     k), 20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"n={n} valid={n_valid} m_bits={m_bits} k={k}"))

    _, (keys, words), kw = calls["bloom_probe"]
    k = kw["k"]
    m_bits = words.numel() * 32
    flat_k = keys.reshape(-1)
    n = flat_k.numel()
    got = bloom_probe(keys, words, k=k)
    want = ref.bloom_probe_ref(flat_k, words, k)
    # Bits this data tests: each key stops at its first clear bit.
    alive = torch.ones_like(flat_k, dtype=torch.bool)
    tested = 0
    w64 = words.long() & 0xFFFFFFFF
    for i in range(k):
        tested += int(alive.sum())
        pos = ref.bloom_positions(flat_k, i, m_bits)
        alive &= ((w64[pos >> 5] >> (pos & 31)) & 1).bool()
    b_ms, b_by = bound(5 * n + m_bits // 8, 13 * n + 7 * tested)
    rows.append(dict(
        name="bloom_probe", route="cuda",
        source="src/repro_torch/csrc/bloom.cu",
        replaces="src/repro/kernels/bloom.py:167",
        launches=launches["bloom_probe"],
        max_abs_err=float((got.reshape(-1).int() - want.int()).abs().max()),
        **time_kernel(lambda: bloom_probe(keys, words, k=k), 200),
        plain_ms=cuda_ms(lambda: ref.bloom_probe_ref(flat_k, words, k), 20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{tuple(keys.shape)} m_bits={m_bits} k={k} kept="
              f"{float(want.float().mean()):.3f}"))

    _, (keys, valid), _ = calls["key_range"]
    flat_k, flat_v = keys.reshape(-1), valid.reshape(-1)
    n = flat_k.numel()
    got = key_range(keys, valid)
    want = ref.key_range_ref(flat_k, flat_v)
    b_ms, b_by = bound(5 * n + 8, 2 * n)
    rows.append(dict(
        name="key_range", route="cuda",
        source="src/repro_torch/csrc/zone_map.cu",
        replaces="src/repro/kernels/zone_map.py:75",
        launches=launches["key_range"],
        max_abs_err=float((got.long() - want.long()).abs().max()),
        **time_kernel(lambda: key_range(keys, valid), 200),
        plain_ms=cuda_ms(lambda: ref.key_range_ref(flat_k, flat_v), 50),
        bound_ms=b_ms, bound_by=b_by,
        # The masked keys' compaction syncs the host on every call.
        library_ms=cuda_ms(lambda: torch.aminmax(flat_k[flat_v]), 50),
        shape=f"{tuple(keys.shape)} valid={int(flat_v.sum())}"))
    report_kernels(rows)
    return rows


def report_kernels(rows: list) -> None:
    for r in rows:
        require(r["max_abs_err"] == 0, f"{r['name']} disagrees with its "
                f"plain version at {r['shape']}")
        lib = ("none (no single PyTorch call computes it)"
               if r["library_ms"] is None else f"{r['library_ms']:.4f} ms")
        print(f"  {r['name']:18s} {r['shape']:22s} kernel {r['ms']:.4f} ms "
              f"(device {r['device_ms']:.4f} ms), bound {r['bound_ms']:.5f} "
              f"ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library "
              f"{lib}")


# ---------------------------------------------------------------------------
# Phase 6: cross-checks
# ---------------------------------------------------------------------------

def check_golden(catalog) -> None:
    from repro_torch.sql import (Executor, all_queries, default_strategies,
                                 filtered_queries)

    gold = json.loads(GOLDEN.read_text())["queries"]
    n = 0
    for qname, plan in {**all_queries(), **filtered_queries()}.items():
        for s in default_strategies():
            res = Executor(catalog, s).execute(plan)
            got = [{"method": d.selection.method.value,
                    "swapped": bool(d.selection.swapped_sides)}
                   for d in res.decisions]
            require(got == gold[qname]["strategies"][s.name],
                    f"{qname} {s.name}: decisions {got} differ from the "
                    "golden fixture")
            n += 1
    print(f"  golden decisions at generate(0.1, 4, 42), q1-q12 and "
          f"unfiltered q19-q23: {n} of {n} equal")


def check_filters_against_cpu(catalog) -> None:
    """The filtered runs' decisions on the card equal the same runs on the
    CPU, where the tests hold them against the JAX package."""
    from repro_torch.sql import (Executor, FilteredStrategy,
                                 default_strategies, filtered_queries,
                                 generate)

    on_cpu = generate(0.1, 4, 42, device="cpu")
    n = 0
    for qname, plan in filtered_queries().items():
        for s in default_strategies():
            got = Executor(catalog, FilteredStrategy(s)).execute(plan)
            want = Executor(on_cpu, FilteredStrategy(s)).execute(plan)
            decisions = [
                [(f.plan, f.rows_before, f.rows_after, f.cached,
                  f.network_bytes) for f in r.filters] + r.methods()
                for r in (got, want)]
            require(decisions[0] == decisions[1],
                    f"{qname} {s.name}: card {decisions[0]} != cpu "
                    f"{decisions[1]}")
            require({f.plan.kind for f in got.filters} == {FILTER_KIND[qname]},
                    f"{qname} {s.name}: card planned "
                    f"{[f.plan.kind for f in got.filters]}")
            require(got.network_bytes == want.network_bytes,
                    f"{qname} {s.name}: network bytes")
            n += 1
    print(f"  filtered decisions at generate(0.1, 4, 42): card equals CPU "
          f"in {n} of {n} runs")


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
    check_filter_kernels_edge_cases(dev)

    print("== 4. main path")
    catalog = make_catalog(dev, args.scale, p=8)
    launches, calls = run_main_path(catalog)
    print("  kernel timings at the main path's largest inputs "
          f"({smi}):")
    rows = measure_kernels(calls, launches)

    print("== 5. runtime filters")
    launches, calls = run_filter_path(catalog)
    print("  filter kernel timings at the filter path's largest inputs "
          f"({smi}):")
    rows += measure_filter_kernels(calls, launches)
    del catalog

    print("== 6. cross-checks")
    from repro_torch.sql import generate
    small = generate(0.1, 4, 42, device=dev)
    check_golden(small)
    check_filters_against_cpu(small)
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
