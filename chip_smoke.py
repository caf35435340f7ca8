#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py             # the full run: scale 30, p = 8
    python3 chip_smoke.py --scale 1   # a quicker rehearsal of the same phases

Phases, in order; any failure raises and the script exits non-zero:

1. environment: the card's name and power limit, torch, CUDA and nvcc;
2. build: ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` for sm_90a;
3. kernels against their plain versions on the card, on edge cases (the
   filter kernels bit for bit; the two probes also on the inputs that are
   hard for their first-match tables: keys sharing one hash32 residue,
   all-equal builds, the int32 ends and sentinels, and builds too large
   for shared memory, so that both table branches launch; the histogram
   in every branch, masked and unmasked, on views off a 16-byte boundary,
   all-invalid and one-bin inputs, runs long enough to flush its packed
   counters, and from two streams at once; the bloom probe with filters in
   shared and in device memory, k = 1..8, all kept, all rejected and on
   views; the bitonic sort bit for bit, keys and values, against the
   reference's network, at every n from 1 to 4096, B = 1, 7 and 133, on
   ties, all-equal keys and the int32 ends, and on views; the bloom build
   in every branch, on both sides of its one-cluster limit, m_bits 32 to
   2^22, k = 1, 7, 8, all invalid, on views, from two streams at once and
   interleaved with the histogram on one stream; key_range bit for bit in
   both branches, n from 0 to 2^24 across its one-block limit, all, none
   and half valid, one valid key at either int32 end, on views, from two
   streams at once and interleaved with the histogram and the bloom build
   on one stream; the row mover bit for bit, ``valid`` too, at the
   exchange's and compaction's SF1 shapes, on a replica with zero fill, on
   a tile's ragged edge in every element width, with more columns than
   one launch carries, on an index of -1 only and on a 1-D index);
4. the main path: q1-q12 under the four default strategies on
   ``generate(scale, p=8, seed=0)`` on the card: one warm-up pass, then the
   reported pass, with every launch count set to 0 just before and read
   just after; every strategy must give the same rows, and every kernel
   of the path must have launched. A third pass runs under
   ``torch.profiler`` for the device's busy share and its kernels by time.
   The largest input each kernel saw is kept, and each kernel, its plain
   version and one PyTorch call for the same function are timed on it
   with CUDA events (the kernel also by its device time alone, from events
   around each call queued behind a sleep kernel; the histogram also
   unmasked, at four times the input, with L2 emptied, beside the old
   ``torch.where`` pair and a reduction of the same bytes; the bitonic
   sort also with L2 emptied, at four times the input, in tiles of 4,096
   and at B = 1, n = 2, each beside its bound, plain version and
   ``torch.sort``, and its device activities a call);
5. runtime filters on the same catalog: q19-q23 under
   ``FilteredStrategy(s)`` for each default strategy, after a warm-up pass
   and beside the unfiltered runs: the same rows, the planned filter kinds,
   fewer probe-side shuffle bytes over the suite, and the filter kernels
   launched (counts set to 0 just before the filtered pass and read just
   after); then the suite again against one shared ``FilterCache``, warm;
   one pass under ``torch.profiler``; then the filter kernels timed at
   their largest inputs, as in phase 4 (the bloom probe also at four times
   the input and with L2 emptied; the bloom build as the bitonic sort in
   phase 4, on 4,096 and on 32 keys; key_range at its input, four times
   it and 32 keys, beside ``torch.aminmax(keys[valid])``, with its device
   activities a call and its host cost part by part);
5b. reordering and the hypercube on the same catalog: q13-q15 and q35-q37
   under ``ReorderingStrategy(s)`` for each default strategy, and q35-q37
   also with ``hypercube=False``, after a warm-up pass: every run gives the
   rows of the unreordered run, q35-q37 select the hypercube multi-way join
   under ``Reorder(RelJoin)``, and the fused three-way probe
   (``tiled_probe3``) launched (counts set to 0 just before the pass and
   read just after); the cube's network bytes beside the binary arm's; one
   pass under ``torch.profiler``; then ``tiled_probe3`` timed at its
   largest input, as in phase 4;
5c. the text-only and skew-target suites on the same catalog: q16-q18 and
   q24-q34, parsed from SQL text, under the four default strategies, after
   a warm-up pass, with launch counts set to 0 just before the reported
   pass and read just after: every strategy gives the same rows, K1, K2
   and K3 launched; wall ms per run and network, local and straggler bytes
   per strategy; one pass under ``torch.profiler``;
5d. skew, re-optimization and verification, every run with every
   plan-analysis gate armed (``verify=True``): q16-q18 on
   ``generate(scale, 8, 0, skew=1.2)`` under RelJoin, SkewAware and
   Reorder(SkewAware), after a warm-up pass, with the launch counts and the
   histogram's branch counts set to 0 just before the reported pass and
   read just after: the methods, salt factors, both sides' measured skew,
   bytes, overflow retries, rows and wall ms of each run; the same rows in
   the three arms, the salted method selected, SkewAware's straggler bytes
   below RelJoin's wherever it salted, and the histogram's shared branch
   launched (``hot_fine_buckets``' 128 fine buckets); q16-q18 under
   SkewAware on phase 4's uniform catalog take RelJoin's methods; one pass
   under ``torch.profiler``. Then checkpoint re-optimization: the
   reference's 3-leaf chain and q13-q15 under
   ``Reorder(RelJoin, reopt=True)`` (static statistics) beside reopt off,
   on phase 4's catalog (no trigger, the same decisions and bytes) and on
   ``generate(scale, 8, 0, skew_overrides={"ss_item_sk": 1.3})`` (the
   chain triggers): every checkpoint disciplined, rows as with reopt off.
   Then the histogram timed at ``hot_fine_buckets``' largest input, as in
   phase 4, as the JSON line's second partition_hist entry;
5e. the query service and the nested-loop joins on phase 4's catalog: the
   service suite (q19-q23, q33, q34) as one unbudgeted batch of
   ``QueryService(catalog, verify=True)``, after a warm-up batch, with the
   launch counts set to 0 just before the reported batch and read just
   after: K1, K2, K4, K5 and K6 launched (K3's count printed); every
   query's rows equal its ``execute_solo`` run; the q19/q33 and q22/q34
   pairs shared, q33 and q34 running no join and moving no byte; fewer
   joins and network bytes than the solo runs; the batch's wall beside the
   sum of the solo walls. Then the suite resubmitted (every submission a
   plan-cache hit, the filter cache's hits rising), a run under a cost
   budget of half the suite's summed quotes with ``policy="cost"`` (more
   than one batch, the same rows), one batch under ``torch.profiler``; then
   store_sales against store and date_dim (their odd keys masked) under
   ``BROADCAST_NL`` and ``CARTESIAN`` (rows equal ``BROADCAST_HASH``'s for
   inner, left_semi and left_anti; wall time and chunk count of each);
5f. the distributed twins of ``repro_torch.joins.distributed`` on phase 4's
   catalog, every rank's partition on the one card: the global view of
   each twin first (its rows, sorted on the card, its payloads, and its
   walls), then 8 rank processes under gloo (NCCL refuses two ranks on one
   card) and one under NCCL on the concatenated tables, each running
   store_sales x customer under the shuffle hash and shuffle sort twins,
   store_sales x date_dim and x store under the broadcast hash twin, q35's
   three cube inputs under the hypercube twin (``Reorder(RelJoin)``'s spec,
   at the global view's first factor without overflow), and the bloom,
   zone-map and key-set builds on q19's filtered customer keys and on
   ``ss_customer_sk``; a warm-up pass, then with each rank's launch counts
   set to 0, three timed runs of each twin: rows (gathered to rank 0 and
   sorted on the card) equal the global view's, payloads bit-identical on
   every rank, no row past a pair's capacity, K2, K4 and K6 launched on
   every rank (K3's count printed); the slowest rank's wall, the bytes
   each rank sent by collective, and the global view's wall;
6. cross-checks: the decisions at ``generate(0.1, 4, 42)`` of q1-q37 under
   the four default strategies and of q13-q15 and q35-q37 under
   ``Reorder(RelJoin)`` (154), and ``optimize``'s reordering and plan
   signature for every query (37), equal the golden fixture; the filtered
   runs' filters and methods there equal those of the same runs on the
   CPU; at scale 3 the gather path (``use_kernel=False``) gives the
   rows of the kernel path on q1-q12, q16-q18 and q24-q34; and
   ``repro_torch.sql.plan_analysis.main`` (37 plans x 9 strategies with
   every gate armed, at ``generate(0.05, 4, 42)``) reports no violation;
   and ``repro_torch.sql.service.main`` (the service suite batched against
   its solo runs at ``generate(0.05, 4, 11)``) returns 0;
7. LM serving (``repro_torch.models.lm`` and ``repro_torch.serving``), with
   every launch count set to 0 just before and required to stay 0 (the
   path runs none of K1-K7): the six smoke configs of the uniform-block
   families (forward finite on the card; hidden states, prefill logits and
   every decode step's logits equal to the port's CPU run on the same
   params; teacher-forced decode reproduces forward); then tinyllama-1.1b
   and granite-8b at full width from random weights: a ``ServeEngine`` of 8
   slots drains 16 requests of 8 + 32 tokens (tinyllama, 256 positions) or
   8 of 16 + 16 (granite, 128 positions), with completion, occupancy, FIFO
   admission and the vocab checked; four requests chosen in advance held
   against forward over their own tokens; teacher-forced decode against
   forward at B = 2, S = 64; and the readings: the decode step at batch 8
   (fp32 weights cast at every use, and the engine's resident bf16 copy),
   tokens/s while draining, one prefill at B = 8, S = 512, and the peak
   memory, each beside its bound;
8. the MoE, hybrid and RWKV-6 families, launch counts set to 0 just before
   and required to stay 0: the smoke configs of dbrx_132b,
   qwen3_moe_235b_a22b, zamba2_7b and rwkv6_3b on the card against the
   port's CPU run on the same params and the CPU's routing (hidden states,
   prefill and every decode step's logits, moe_load and moe_dropped equal,
   the card's own router picks within 2^-5 of the CPU's), teacher-forced
   decode against forward; qwen3's router width with two equal columns
   (ties in ascending expert order on both devices); then zamba2-7b (81
   layers) and rwkv6-3b (32) at full width and depth, qwen3-moe-235b-a22b
   (3 of 94 layers) and dbrx-132b (2 of 40) at full width, each through
   phase 7's engine checks (8 requests of 16 + 16 tokens, 128 positions;
   MoE oracles on the routing of the run they check, at the dropless
   capacity; for zamba2 and rwkv6, whose bf16 decode leaves forward at
   depth as the reference's does, the differences printed and the checks
   run again on an f32 twin of the same code and weights), no decode call
   dropping an MoE assignment, and the readings: the decode step from the
   engine's copy, tokens/s, one prefill at B = 8, S = 512 (with the MoE
   loads and dropped share) and the peak memory, each beside its bound;
9. training, launch counts set to 0 just before and required to stay 0:
   the smoke configs of tinyllama_1_1b, musicgen_large,
   qwen3_moe_235b_a22b, zamba2_7b and rwkv6_3b at their remat policy on the
   card against the port's CPU run on the same params, batch and routing
   (the loss, every gradient leaf, one train step's params and optimizer
   state); tinyllama-1.1b at full width and depth, 20 AdamW steps at B 4 x
   S 2048, and qwen3-moe-235b-a22b at full width and 2 of 94 layers
   ("reduced:" line), 5 Adafactor steps at B 4 x S 512: a finite loss
   every step, the last below the first, the MoE loads and dropped share,
   and the readings (the step by events, one step's device busy time,
   idle share and activities, tokens/s, peak memory beside its reckoning)
   beside the bound; then ``python -m repro_torch.examples.train_lm
   --steps 300`` (its ``main``) must print LEARNING, and a resumed run from
   its checkpoint at 100 must equal its checkpoint at 200 (rtol and atol
   2e-4), with the save and restore times;
10. the sharded LM paths, four rank processes under gloo sharing the one
   card (NCCL refuses two ranks on a card), the parent's whole tensors
   reaching them through CUDA IPC, launch counts set to 0 just before and
   required to stay 0: 10a, tinyllama-1.1b at full width and depth under
   ``plan_model``'s serve plan on 2x2: an engine of 8 slots drains 8
   requests of 8 + 16 tokens (every rank's tokens equal, and equal the
   ``mesh=None`` engine's on the card or part at a near-tie of its
   logits), a prefill at 8 x 512 against ``mesh=None``'s; 10b, its train
   plan, 3 AdamW steps at B 4 x S 2048 on 2x2 and on 1x4, step 1 against
   one ``mesh=None`` step from the same params and batch (phase 9a's
   bounds), the 2x2 checkpoint restored bit-equal on 1x4 and on no mesh;
   10c, qwen3-moe-235b-a22b at full width and 2 of 94 layers, expert
   parallel on 1x4 (32 experts a rank) on the replicated path's routing:
   at a capacity factor where neither path drops, the hidden states of a
   prefill at 8 x 512 and 4 decode steps' logits against the replicated
   path's, and both paths' drops at the config's factor. Across the model
   axis's bf16 partial sums, full-depth outputs are held to the spread:
   a mean difference within 2^-6, at most 2^-10 of the entries beyond
   the bf16 elementwise bound, top tokens equal or near-ties. Each rank
   prints its step by CUDA events, its collective calls and bytes by
   kind and its peak memory; which collectives gloo ran on CUDA tensors;
11. the cost tools, launch counts set to 0 just before and required to
   stay 0: 11a, ``python -m repro_torch.launch.dryrun`` in subprocesses on
   this machine's torch (tinyllama-1.1b ``decode_32k`` on 16x16 and
   2x16x16, rwkv6-3b ``long_500k``, tinyllama ``long_500k``, which must
   skip with the reference's reason), each record's roofline printed;
   11b, phase 10a's prefill counted by ``hlo_cost.count`` on meta tensors
   under a fake world of 4: its collective calls and bytes by kind must
   equal rank 0's readings, the estimated peak printed beside the
   measured one; 11c, tinyllama-1.1b's prefill at 8 x 512 and decode step
   at batch 8 on one device, counted on meta and on the card's tensors:
   FLOPs equal, the outputs and temporaries estimated within 2x of
   ``max_memory_allocated``'s rise over the prefill, the roofline's step
   beside the CUDA-event time.

With ``--save-inputs PATH`` it saves the inputs at which it timed the
bitonic sort, the bloom build and key_range, for
``tools/time_sort_bloom.py``, which times another tree's kernels at them.

Each phase prints its wall time. It prints one JSON line of kernel
measurements, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. It needs no network; it imports nothing
of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import pickle
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: Published H100 SXM peaks: the device memory rate (NVIDIA data sheet),
#: and the 32-bit integer instruction rate, which every kernel's operation
#: count is: the data sheet's 67 TFLOP/s float32 peak times 64/128 (the
#: CUDA C++ Programming Guide's results per clock per SM for 32-bit integer
#: add, multiply-add, logic and shift against float32 FMA at compute
#: capability 9.0), over the 2 operations an FMA counts for.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_OPS_PER_S = 67e12 * 64 / 128 / 2

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


def device_ms(fn, reps: int, flush=None) -> float:
    """Mean milliseconds that one call of ``fn`` keeps the card busy: CUDA
    events recorded just before and just after each call, with all the
    calls queued behind a sleep kernel, so that the host's launch cost
    between calls passes during the sleep and not between the events.
    ``flush``, if given, runs before each call, outside its events. (The
    profiler's kernel records proved unreliable over short back-to-back
    sessions: some calls came back with no device time.)"""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000  # about 10 ms at the card's clock
    for _ in range(6):
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        head = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        head.record()
        for start, end in events:
            if flush is not None:
                flush()
            start.record()
            fn()
            end.record()
        queued_in_time = not head.query()  # the sleep outlasted the host
        torch.cuda.synchronize()
        if queued_in_time:
            return sum(s.elapsed_time(e) for s, e in events) / reps
        cycles *= 4
    raise CheckFailed("device_ms: the host could not queue the calls "
                      "within the sleep")


def l2_flush():
    """A call that evicts the card's 50 MB L2 cache by reading 256 MB (a
    read, so that no dirty line is left for the next kernel to write
    back)."""
    import torch
    scratch = torch.ones(1 << 26, dtype=torch.int32, device="cuda")
    return lambda: scratch.amax()


def time_kernel(fn, reps: int, cold: bool = False) -> dict:
    """``ms``: CUDA events around ``reps`` back-to-back wrapper calls, host
    launch cost included where it outlasts the device work; ``device_ms``:
    the device time alone (``device_ms`` above), back to back, where a call
    may find part of its inputs in L2 from the one before; with ``cold``,
    also ``device_cold_ms``: the device time with L2 emptied before each
    call, which every byte of the bound then crosses."""
    out = dict(ms=cuda_ms(fn, reps), device_ms=device_ms(fn, reps))
    if cold:
        out["device_cold_ms"] = device_ms(fn, reps, flush=l2_flush())
    return out


def copy_yardstick(n: int) -> str:
    """Device time of copying ``n`` int32 (read once, written once), back
    to back and with L2 emptied: the rate this card reaches on a probe's
    traffic, its probe keys in and its outputs out."""
    import torch
    src = torch.empty(n, dtype=torch.int32, device="cuda")
    dst = torch.empty_like(src)
    fn = lambda: dst.copy_(src)  # noqa: E731
    return (f"a copy of the probe keys ({4 * n / 1e6:.1f} MB in, as many "
            f"out) takes {device_ms(fn, 20):.4f} ms of device time, "
            f"{device_ms(fn, 20, flush=l2_flush()):.4f} ms with L2 emptied")


def device_readings(fn, reps: int, bound_ms: float) -> str:
    """Device time of ``fn`` back to back and with L2 emptied, each with
    the share of ``bound_ms`` it reaches."""
    warm = device_ms(fn, reps)
    cold = device_ms(fn, reps, flush=l2_flush())
    return (f"device {warm:.4f} ms ({bound_ms / warm:.0%} of the bound), "
            f"L2 emptied {cold:.4f} ms ({bound_ms / cold:.0%})")


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time (ms) for moving ``nbytes`` and doing ``ops``, and which of
    the two sets it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def probe_least_work(probes, builds) -> tuple[float, float]:
    """Least work of a first-match probe by the rule of the bound: every
    probe and build key read once and every output (one per probe key)
    written once, 4 bytes each; one hash and one compare per probe key and
    per build key. Returns (bytes, operations)."""
    n_probe = sum(t.numel() for t in probes)
    n_build = sum(t.numel() for t in builds)
    return 4.0 * (2 * n_probe + n_build), 2.0 * (n_probe + n_build)


def dense_compares(first, n) -> float:
    """Compares of a dense scan on these results: up to the first hit, all
    ``n`` build keys on a miss."""
    import torch
    return float(torch.where(first >= 0, first + 1, n).sum())


#: The probe edge cases that stress the first-match tables.
PROBE_EDGE_KINDS = ("one residue", "all equal", "extremes")


def residue_keys(rng, n: int, seed: int, modulus: int):
    """``n`` distinct int32 keys that all share ``hash32(key, seed) %
    modulus == 0``, as the keys of one radix bucket (BUCKET_SEED) or one
    cube partition (SHUFFLE_SEED) do: half from a dense range near 0, as
    surrogate keys are, half from the whole int32 range."""
    import numpy as np
    import torch

    from repro_torch.joins.slots import hash32

    def pick(lo, hi, want, taken=()):
        out = np.empty(0, np.int64)
        while out.size < want:
            cand = rng.integers(lo, hi, 2 * modulus * want + 64)
            h = hash32(torch.from_numpy(cand), seed).numpy()
            out = np.setdiff1d(np.union1d(out, cand[h % modulus == 0]),
                               taken)
        return rng.permutation(out)[:want]

    dense = pick(0, 8 * modulus * max(n, 1), n - n // 2)
    wide = pick(-(2 ** 31), 2 ** 31, n // 2, dense)
    return rng.permutation(np.concatenate([dense, wide])).astype(np.int32)


def probe_edge_keys(rng, bsz: int, na: int, nb: int, seed: int,
                    modulus: int, kind: str):
    """Probe keys (bsz, na) and build keys (bsz, nb) of one edge case.

    "one residue": every key of a row shares one hash32 residue; the build
    repeats a tenth of its keys (first match matters) and holds build
    padding (-2); three quarters of the probe slots are probe padding (-1),
    the rest hit or miss the build about evenly. "all equal": one build key
    throughout, probed with it (two in five live slots) and with others.
    "extremes": the residue keys with INT32_MIN, INT32_MAX, -1 and -2 among
    them on both sides, repeated in the build."""
    import numpy as np

    a = np.full((bsz, na), -1, np.int32)
    b = np.full((bsz, nb), -2, np.int32)
    ends = np.array([-(2 ** 31), 2 ** 31 - 1, -1, -2], np.int32)
    for r in range(bsz):
        pool = residue_keys(rng, 2 * nb + 8, seed, modulus)
        if kind == "all equal":
            b[r] = pool[0]
        else:
            brow = pool[:nb].copy()
            dup = rng.random(nb) < 0.1
            brow[dup] = brow[rng.integers(0, nb, int(dup.sum()))]
            brow[rng.random(nb) < 0.25] = -2
            if kind == "extremes":
                at = rng.integers(0, nb, 4 * len(ends))
                brow[at] = np.tile(ends, 4)
            b[r] = brow
        live = rng.random(na) < 0.25
        a[r, live] = pool[rng.integers(0, 2 * nb + 8, int(live.sum()))]
        if kind == "all equal":
            a[r, live & (rng.random(na) < 0.4)] = pool[0]
        if kind == "extremes":
            a[r, rng.integers(0, na, 2 * len(ends))] = np.tile(ends, 2)
    return a, b


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions on edge cases
# ---------------------------------------------------------------------------

def check_kernels_edge_cases(dev) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.tiled_probe import tiled_probe

    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa

    check_hist_edge_cases(dev, rng)

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
    # The first-match tables' hard inputs: one radix bucket's keys (one
    # BUCKET_SEED residue), all-equal builds, the int32 ends and sentinels,
    # at the hash join's tile shape and past the shared-memory tables.
    from repro_torch.joins.slots import BUCKET_SEED
    branches = dict(tiled_probe.table_launches)
    for bsz, na, nb in ((256, 2048, 129), (3, 70_000, 4700),
                        (2, 20_000, 100_000)):
        for kind in PROBE_EDGE_KINDS:
            a, b = probe_edge_keys(rng, bsz, na, nb, BUCKET_SEED, 64, kind)
            probe_case(a, b, f"{kind} B={bsz} na={na} nb={nb}")
            n_cases += 1
    took = {k: v - branches[k] for k, v in tiled_probe.table_launches.items()}
    require(took["shared"] > 0 and took["device"] > 0,
            f"tiled_probe table branches launched {took}")
    print(f"  tiled_probe: {n_cases} cases equal to the plain version; "
          f"table branches of the edge cases {took}")

    check_sort_edge_cases(dev, rng)
    check_probe3_edge_cases(dev)


#: Key patterns of the bitonic sort's edge cases.
SORT_EDGE_KINDS = ("few distinct", "all equal", "int32 ends", "wide")


def sort_edge_keys(rng, bsz: int, n: int, kind: str):
    """(bsz, n) int32 keys of one bitonic-sort edge case: five distinct
    values (ties everywhere), one value, the int32 ends among few others,
    or the whole int32 range."""
    import numpy as np

    if kind == "few distinct":
        return rng.integers(-2, 3, (bsz, n)).astype(np.int32)
    if kind == "all equal":
        return np.full((bsz, n), 7, np.int32)
    if kind == "int32 ends":
        ends = np.array([-(2 ** 31), 2 ** 31 - 1, -1, 0], np.int32)
        return ends[rng.integers(0, 4, (bsz, n))]
    return rng.integers(-(2 ** 31), 2 ** 31, (bsz, n),
                        dtype=np.int64).astype(np.int32)


def check_sort_edge_cases(dev, rng) -> None:
    """bitonic_sort_tile bit for bit, keys and values, against the
    reference's network (``ref.bitonic_network_ref``): every n from 2^0 to
    2^12 at B = 1, 7 and 133 on every ``SORT_EDGE_KINDS`` pattern, with
    distinct values (so any difference in tie order shows), and on views
    that start 1-3 elements past an aligned base."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bitonic_sort import MAX_TILE, bitonic_sort_tile

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    n_cases = 0

    def case(k, v, label):
        nonlocal n_cases
        gk, gv = bitonic_sort_tile(k, v)
        wk, wv = ref.bitonic_network_ref(k, v)
        require(torch.equal(gk, wk) and torch.equal(gv, wv),
                f"bitonic_sort_tile {label}")
        n_cases += 1

    n = 1
    while n <= MAX_TILE:
        for bsz in (1, 7, 133):
            vals = t(rng.permutation(bsz * n).reshape(bsz, n).astype(
                np.int32))
            for kind in SORT_EDGE_KINDS:
                case(t(sort_edge_keys(rng, bsz, n, kind)), vals,
                     f"{kind} B={bsz} n={n}")
        n *= 2
    for n in (8, 2048, MAX_TILE):
        keys = t(sort_edge_keys(rng, 1, 7 * n + 3, "few distinct")[0])
        vals = t(rng.permutation(7 * n + 3).astype(np.int32))
        for k0, v0 in ((1, 0), (0, 2), (3, 1), (2, 3)):
            case(keys[k0:k0 + 7 * n].view(7, n),
                 vals[v0:v0 + 7 * n].view(7, n),
                 f"views +{k0} +{v0} B=7 n={n}")
    print(f"  bitonic_sort_tile: {n_cases} cases equal to the reference's "
          "network, keys and values")


def on_two_streams(call, inputs, rounds: int = 20) -> list:
    """``call(x)`` for each of the two ``inputs`` on a CUDA stream of its
    own, ``rounds`` times, the two streams' calls in flight at once: the
    results by input."""
    import torch

    streams = [torch.cuda.Stream() for _ in inputs]
    torch.cuda.synchronize()
    got: list = [[] for _ in inputs]
    for _ in range(rounds):
        for i, (stream, x) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(stream):
                got[i].append(call(x))
    torch.cuda.synchronize()
    return got


#: Bin counts that reach every branch of partition_hist and its edges:
#: registers (nd <= 8), shared memory (nd <= 12288) and device memory.
HIST_EDGE_ND = (1, 8, 9, 16, 17, 12288, 12289, 20000)


def check_hist_edge_cases(dev, rng) -> None:
    """partition_hist against its plain version: every branch, with and
    without the mask, on views 0-3 elements off an aligned base and odd
    lengths, all-invalid and one-bin inputs, long per-thread runs that make
    the packed counters flush, and calls in flight on two streams."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.build import library
    from repro_torch.kernels.partition_hist import (HIST_BRANCHES,
                                                    partition_hist)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    branches = dict(partition_hist.branch_launches)
    n_cases = 0

    def case(d, nd, valid, label):
        nonlocal n_cases
        got = partition_hist(d, nd=nd, valid=valid)
        require(torch.equal(got, ref.partition_hist_ref(d, nd, valid)),
                f"partition_hist {label}")
        n_cases += 1

    for n in (0, 1, 31, 1000, 100_003, 3_000_000):
        for nd in (4, 8, 128, 20000):
            d = t(rng.integers(-1, nd + 2, n).astype(np.int32))
            case(d, nd, None, f"n={n} nd={nd}")
    for nd in HIST_EDGE_ND:
        d = t(rng.integers(-1, nd + 2, 1_000_011).astype(np.int32))
        v = t(rng.random(1_000_011) < 0.7)
        for d0, v0, n in ((0, 0, 1_000_000), (1, 1, 999_999), (3, 0, 7),
                          (2, 3, 500_002), (1, 2, 2)):
            for valid in (None, v[v0:v0 + n]):
                case(d[d0:d0 + n], nd, valid,
                     f"nd={nd} views +{d0} +{v0} n={n} "
                     f"masked={valid is not None}")
        one = torch.full((1_000_001,), nd - 1, dtype=torch.int32, device=dev)
        case(one, nd, None, f"nd={nd} one bin")
        case(one, nd, torch.zeros_like(one, dtype=torch.bool),
             f"nd={nd} all invalid")
        case(torch.full_like(one, -1), nd, None, f"nd={nd} all -1")
    # 2^31 / 64 rows in one bin and at random: every thread of the one-wave
    # grid counts long enough runs that its 8-bit lanes flush.
    n = 2 ** 31 // 64
    for bin_ in (0, 7):
        case(torch.full((n,), bin_, dtype=torch.int32, device=dev), 8, None,
             f"n={n} all in bin {bin_}")
    d = torch.randint(-1, 9, (n,), dtype=torch.int32, device=dev)
    case(d, 8, torch.rand(n, device=dev) < 0.9, f"n={n} random masked")
    del d
    # Two streams at once, each call adding into its stream's accumulator.
    if dev.type == "cuda":
        for nd in (8, 17, 20000):
            inputs = [t(rng.integers(-1, nd + 1, 4_000_000).astype(np.int32))
                      for _ in range(2)]
            want = [ref.partition_hist_ref(d, nd) for d in inputs]
            got = on_two_streams(lambda d: partition_hist(d, nd=nd), inputs)
            require(all(torch.equal(g, want[i])
                        for i in range(2) for g in got[i]),
                    f"partition_hist nd={nd} on two streams at once")
            n_cases += 40
        # The kernel launches the branch it is passed, and refuses the
        # register branch for more bins than its packed words hold.
        d = torch.zeros(1000, dtype=torch.int32, device=dev)
        ws = torch.zeros(10, dtype=torch.int32, device=dev)
        err = library().repro_partition_hist(
            d.data_ptr(), None, d.numel(), 9,
            HIST_BRANCHES.index("registers"), ws.data_ptr(),
            torch.empty(9, dtype=torch.int32, device=dev).data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        require(err != 0, "partition_hist register branch took nd=9")
    took = {k: v - branches[k]
            for k, v in partition_hist.branch_launches.items()}
    require(all(v > 0 for v in took.values()),
            f"partition_hist branches launched {took}")
    print(f"  partition_hist: {n_cases} cases equal to the plain version; "
          f"branches of the edge cases {took}")


def check_probe3_edge_cases(dev) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.tiled_probe import tiled_probe3

    rng = np.random.default_rng(2)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    extremes = [-1, -2, -(2 ** 31), 2 ** 31 - 1]
    n_cases = 0
    for bsz in (1, 8):
        for na in (1, 255, 256, 257, 70_000):
            for nb, nc in ((0, 1), (1, 0), (1, 7), (300, 4700),
                           (4700, 1300)):
                # Keys drawn from half the longer build's length: duplicate
                # build keys (first match matters), hits and misses.
                hi = max(nb, nc) // 2 + 2
                keys = [rng.integers(-2, hi, (bsz, n)).astype(np.int32)
                        for n in (na, na, nb, nc)]
                for k in keys:
                    k.reshape(-1)[:4] = extremes[:k.size]
                a1, a2, b, c = (t(k) for k in keys)
                got = tiled_probe3(a1, a2, b, c)
                want = ref.tiled_probe3_ref(a1, a2, b, c)
                require(torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1]),
                        f"tiled_probe3 B={bsz} na={na} nb={nb} nc={nc}")
                n_cases += 1
    from repro_torch.joins.slots import SHUFFLE_SEED
    branches = dict(tiled_probe3.table_launches)
    for bsz, na, nb, nc in ((8, 70_000, 8768, 2368),
                            (8, 20_000, 60_000, 30_000)):
        for kind in PROBE_EDGE_KINDS:
            a1, b = probe_edge_keys(rng, bsz, na, nb, SHUFFLE_SEED, 8, kind)
            a2, c = probe_edge_keys(rng, bsz, na, nc, SHUFFLE_SEED, 8, kind)
            a1, a2, b, c = (t(k) for k in (a1, a2, b, c))
            got = tiled_probe3(a1, a2, b, c)
            want = ref.tiled_probe3_ref(a1, a2, b, c)
            require(torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1]),
                    f"tiled_probe3 {kind} B={bsz} na={na} nb={nb} nc={nc}")
            n_cases += 1
    took = {k: v - branches[k]
            for k, v in tiled_probe3.table_launches.items()}
    require(took["shared"] > 0 and took["device"] > 0,
            f"tiled_probe3 table branches launched {took}")
    got = tiled_probe3(t(np.array([5, -1, 9, -2], np.int32)),
                       t(np.array([-1, 4, 4, 7], np.int32)),
                       t(np.array([1, 5, -1, 5, -2], np.int32)),
                       t(np.array([4, -1, 4], np.int32)))
    require([o.tolist() for o in got] == [[1, 2, -1, 4], [1, 0, 0, -1]],
            "tiled_probe3 sentinels and first-match values")
    print(f"  tiled_probe3: {n_cases + 1} cases equal to the plain version; "
          f"table branches of the edge cases {took}")


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
    check_bloom_probe_edge_cases(dev, rng)
    check_bloom_build_edge_cases(dev, rng)
    check_key_range_edge_cases(dev)


def check_bloom_probe_edge_cases(dev, rng) -> None:
    """bloom_probe against its plain version in both filter branches
    (shared memory up to 2^20 bits, device memory above), k = 1..8, on keys
    that all pass (the build's own), all fail (the empty filter) and views
    0-3 keys off an aligned base."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bloom import bloom_build, bloom_probe

    branches = dict(bloom_probe.filter_launches)
    keys = torch.from_numpy(rng.integers(
        -(2 ** 31), 2 ** 31 - 1, 300_007, dtype=np.int64).astype(
            np.int32)).to(dev)
    n_cases = 0
    for m_bits in (1 << 16, 1 << 20, 1 << 21, 1 << 22):
        empty = torch.zeros(m_bits // 32, dtype=torch.int32, device=dev)
        for k in range(1, 9):
            words = bloom_build(keys[:20_000], m_bits=m_bits, k=k)
            for off in range(4):
                kv = keys[off:]
                label = f"m_bits={m_bits} k={k} view +{off}"
                require(torch.equal(bloom_probe(kv, words, k=k),
                                    ref.bloom_probe_ref(kv, words, k)),
                        f"bloom_probe {label}")
                require(bool(bloom_probe(kv[:20_000 - off], words,
                                         k=k).all()),
                        f"bloom_probe {label}: a build key rejected")
                require(not bool(bloom_probe(kv, empty, k=k).any()),
                        f"bloom_probe {label}: the empty filter kept a key")
                n_cases += 3
    took = {k: v - branches[k]
            for k, v in bloom_probe.filter_launches.items()}
    require(all(v > 0 for v in took.values()),
            f"bloom_probe filter branches launched {took}")
    print(f"  bloom_probe: {n_cases} more cases equal to the plain version "
          f"(all kept, all rejected, views); filter branches "
          f"of the edge cases {took}")


def check_bloom_build_edge_cases(dev, rng) -> None:
    """bloom_build bit for bit against its plain version in every branch
    (one cluster up to ``ONE_CLUSTER_KEYS`` keys, blocks beyond, the filter in
    device memory above 2^20 bits): n on both sides of the one-cluster limit
    and up to 4,194,304, every m_bits from 32 to 2^22, k = 1, 7 and 8; all
    keys invalid; keys and mask on views off a 16-byte boundary; calls in
    flight on two streams at once; and calls interleaved with the
    histogram's on one stream, which share its workspace."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bloom import (BUILD_BRANCHES, ONE_CLUSTER_KEYS,
                                           bloom_build, build_branch)
    from repro_torch.kernels.partition_hist import partition_hist

    branches = dict(bloom_build.branch_launches)
    n_cases = 0

    def case(keys, valid, m_bits, k, label):
        nonlocal n_cases
        words = bloom_build(keys, valid, m_bits=m_bits, k=k)
        want = ref.bloom_build_ref(keys, valid, m_bits, k)
        require(torch.equal(words, want),
                f"bloom_build {label} m_bits={m_bits} k={k}")
        n_cases += 1
        return words

    def keys_and_mask(n, seed):
        g = np.random.default_rng(seed)
        keys = g.integers(-(2 ** 31), 2 ** 31, n, dtype=np.int64).astype(
            np.int32)
        keys[:min(n, 4)] = np.array([0, -1, -(2 ** 31), 2 ** 31 - 1],
                                    np.int32)[:min(n, 4)]
        return (torch.from_numpy(keys).to(dev),
                torch.from_numpy(g.random(n) < 0.5).to(dev))

    edge_n = (0, 1, 31, ONE_CLUSTER_KEYS - 1, ONE_CLUSTER_KEYS,
              ONE_CLUSTER_KEYS + 1, 100_003, 4_194_304)
    every_m_bits = [1 << e for e in range(5, 23)]
    for n in edge_n:
        keys, valid = keys_and_mask(n, n)
        for m_bits in every_m_bits:
            for k in (1, 7, 8):
                case(keys, valid, m_bits, k, f"n={n}")
    for n in (ONE_CLUSTER_KEYS, ONE_CLUSTER_KEYS + 1, 100_003):
        keys, _ = keys_and_mask(n, n + 1)
        none = torch.zeros(n, dtype=torch.bool, device=dev)
        for m_bits in (1 << 16, 1 << 21):
            words = case(keys, none, m_bits, 8, f"n={n} all invalid")
            require(not bool(words.any()),
                    f"bloom_build n={n} all invalid: bits set")
    for n in (ONE_CLUSTER_KEYS, 100_003):
        keys, valid = keys_and_mask(n + 3, n + 2)
        for k0, v0 in ((1, 0), (0, 3), (2, 1), (3, 3)):
            for m_bits in (1 << 16, 1 << 21):
                case(keys[k0:k0 + n], valid[v0:v0 + n], m_bits, 8,
                     f"n={n} views +{k0} +{v0}")
    if dev.type == "cuda":
        # Two streams at once, each call ORing into its stream's
        # accumulator, in the two branches that use one.
        for n, m_bits in ((100_003, 1 << 16), (100_003, 1 << 21)):
            inputs = [keys_and_mask(n, 7 + i) for i in range(2)]
            want = [ref.bloom_build_ref(kv, vv, m_bits, 8)
                    for kv, vv in inputs]
            got = on_two_streams(
                lambda kv: bloom_build(*kv, m_bits=m_bits, k=8), inputs)
            require(all(torch.equal(g, want[i])
                        for i in range(2) for g in got[i]),
                    f"bloom_build {build_branch(n, m_bits)} on two streams "
                    "at once")
            n_cases += 40
    # Interleaved with the histogram on one stream: both kernels take the
    # stream's workspace and leave it zero for the other.
    keys, valid = keys_and_mask(100_003, 11)
    dest = torch.from_numpy(rng.integers(-1, 20_001, 1_000_003).astype(
        np.int32)).to(dev)
    hist_want = ref.partition_hist_ref(dest, 20_000)
    for m_bits in (1 << 16, 1 << 21):
        want = ref.bloom_build_ref(keys, valid, m_bits, 8)
        for _ in range(10):
            require(torch.equal(partition_hist(dest, nd=20_000), hist_want),
                    f"partition_hist beside bloom_build m_bits={m_bits}")
            require(torch.equal(bloom_build(keys, valid, m_bits=m_bits, k=8),
                                want),
                    f"bloom_build beside partition_hist m_bits={m_bits}")
            n_cases += 1
    took = {b: bloom_build.branch_launches[b] - branches[b]
            for b in BUILD_BRANCHES}
    require(all(v > 0 for v in took.values()),
            f"bloom_build branches launched {took}")
    print(f"  bloom_build: {n_cases} more cases equal to the plain version "
          f"(one-cluster limit {ONE_CLUSTER_KEYS} keys); branches of the edge "
          f"cases {took}")


def check_key_range_edge_cases(dev) -> None:
    """key_range bit for bit against its plain version in both branches
    (one block up to ``ONE_BLOCK_KEYS`` keys, a grid beyond): n on both
    sides of the limit and up to 2^24, every key valid, none and half;
    only INT32_MIN valid and only INT32_MAX valid, each in a random
    position; keys and mask on views off a 16-byte boundary; calls in
    flight on two streams at once; and calls interleaved with the
    histogram's and the bloom build's on one stream, which share the
    stream's workspace."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bloom import bloom_build
    from repro_torch.kernels.partition_hist import partition_hist
    from repro_torch.kernels.zone_map import (ONE_BLOCK_KEYS, RANGE_BRANCHES,
                                              key_range, range_branch)

    branches = dict(key_range.branch_launches)
    n_cases = 0
    lo32, hi32 = -(2 ** 31), 2 ** 31 - 1

    def case(keys, valid, label):
        nonlocal n_cases
        got = key_range(keys, valid)
        want = ref.key_range_ref(keys.reshape(-1), valid.reshape(-1))
        require(torch.equal(got, want),
                f"key_range {label}: {got.tolist()} != {want.tolist()}")
        n_cases += 1

    def keys_of(n, seed, low=lo32 + 1, high=hi32):
        g = np.random.default_rng(seed)
        return torch.from_numpy(g.integers(low, high, n, dtype=np.int64)
                                .astype(np.int32)).to(dev)

    for n in (0, 1, 31, 32, 33, ONE_BLOCK_KEYS - 1, ONE_BLOCK_KEYS,
              ONE_BLOCK_KEYS + 1, 100_003, 1 << 24):
        keys = keys_of(n, n)
        g = np.random.default_rng(n + 1)
        for mask in ("all", "none", "half"):
            valid = torch.from_numpy(
                np.full(n, mask == "all") if mask != "half"
                else g.random(n) < 0.5).to(dev)
            case(keys, valid, f"n={n} {mask} valid")
        if n:
            # One valid key, at an int32 end, the rest invalid: the
            # encodings' ends (INT32_MAX - lo and hi ^ 2^31 at 2^32 - 1 and
            # at 0).
            for end in (lo32, hi32):
                at = int(g.integers(0, n))
                k = keys.clone()
                k[at] = end
                only = torch.zeros(n, dtype=torch.bool, device=dev)
                only[at] = True
                case(k, only, f"n={n} only {end} valid")
                both = torch.ones(n, dtype=torch.bool, device=dev)
                case(k, both, f"n={n} {end} among all valid")
    for n in (33, ONE_BLOCK_KEYS, ONE_BLOCK_KEYS + 1, 100_003):
        keys = keys_of(n + 3, n + 2)
        valid = torch.from_numpy(np.random.default_rng(n).random(n + 3)
                                 < 0.5).to(dev)
        for k0, v0 in ((1, 0), (0, 3), (2, 1), (3, 3)):
            case(keys[k0:k0 + n], valid[v0:v0 + n],
                 f"n={n} views +{k0} +{v0}")
    if dev.type == "cuda":
        # Two streams at once, each grid folding into its stream's
        # accumulator.
        n = 4 * ONE_BLOCK_KEYS + 5
        inputs = [(keys_of(n, 30 + i, -1000 * (i + 1), 1000 * (i + 1)),
                   torch.ones(n, dtype=torch.bool, device=dev))
                  for i in range(2)]
        want = [ref.key_range_ref(*kv) for kv in inputs]
        got = on_two_streams(lambda kv: key_range(*kv), inputs)
        require(all(torch.equal(g, want[i])
                    for i in range(2) for g in got[i]),
                f"key_range {range_branch(n)} on two streams at once")
        n_cases += 40
    # Interleaved with the histogram and the bloom build on one stream: the
    # three kernels take the stream's workspace and leave it zero.
    n = 4 * ONE_BLOCK_KEYS + 5
    keys = keys_of(n, 40)
    valid = torch.from_numpy(np.random.default_rng(41).random(n)
                             < 0.5).to(dev)
    dest = torch.from_numpy(np.random.default_rng(42).integers(
        -1, 20_001, 1_000_003).astype(np.int32)).to(dev)
    hist_want = ref.partition_hist_ref(dest, 20_000)
    words_want = ref.bloom_build_ref(keys, valid, 1 << 21, 8)
    range_want = ref.key_range_ref(keys, valid)
    for _ in range(10):
        require(torch.equal(key_range(keys, valid), range_want),
                "key_range beside partition_hist and bloom_build")
        require(torch.equal(partition_hist(dest, nd=20_000), hist_want),
                "partition_hist beside key_range")
        require(torch.equal(key_range(keys, valid), range_want),
                "key_range after partition_hist")
        require(torch.equal(bloom_build(keys, valid, m_bits=1 << 21, k=8),
                            words_want), "bloom_build beside key_range")
        n_cases += 2
    took = {b: key_range.branch_launches[b] - branches[b]
            for b in RANGE_BRANCHES}
    require(all(v > 0 for v in took.values()),
            f"key_range branches launched {took}")
    print(f"  key_range: {n_cases} more cases bit-identical to the plain "
          f"version (one-block limit {ONE_BLOCK_KEYS} keys); branches of "
          f"the edge cases {took}")


#: The mover's cases (``move_rows_cases``), by name.
MOVE_CASES = ("exchange_sf1", "compact_sf1", "merge_replica_outer",
              "ragged_edge", "many_columns", "all_invalid", "one_dim")
#: TPC-DS SF1's store_sales over p = 8 partitions, as ``sf1.adhoc`` holds
#: it: 2,880,404 rows, 23 columns.
SF1_STORE_SALES = dict(p=8, cap=360_051, ncols=23)


def move_rows_case(name: str, dev):
    """``(columns, idx, zero_fill)`` of one of ``MOVE_CASES`` on ``dev``:
    the exchange's and compaction's shapes at SF1 (the index as
    ``slot_scatter`` and ``compact_partitions`` leave it: a strided view,
    int32 and int64), the payload merge of a replica with zero fill, a
    tile's ragged edge in every element width, more columns than one
    launch carries, an index of -1 only and a 1-D index."""
    import numpy as np
    import torch

    from repro_torch.joins.slots import pair_capacity, slot_scatter

    g = np.random.default_rng(MOVE_CASES.index(name))

    def cols(shape, n, kinds=("i", "f")):
        out = {}
        for k in range(n):
            kind = kinds[k % len(kinds)]
            a = {"i": lambda: g.integers(-2 ** 31, 2 ** 31 - 1, shape,
                                         dtype=np.int64).astype(np.int32),
                 "f": lambda: g.standard_normal(shape).astype(np.float32),
                 "b": lambda: g.random(shape) < 0.5,
                 "l": lambda: g.integers(-2 ** 62, 2 ** 62, shape)}[kind]()
            out[f"c{k}"] = torch.from_numpy(a).to(dev)
        return out

    def index(shape, n_rows, dead=0.3):
        i = g.integers(0, n_rows, shape)
        i[g.random(shape) < dead] = -1
        return torch.from_numpy(i.astype(np.int32)).to(dev)

    p, cap, ncols = (SF1_STORE_SALES[k] for k in ("p", "cap", "ncols"))
    if name in ("exchange_sf1", "compact_sf1"):
        valid = torch.from_numpy(g.random((p, cap)) < (
            0.999 if name == "exchange_sf1" else 0.5)).to(dev)
        if name == "exchange_sf1":
            dest = torch.from_numpy(g.integers(0, p, (p, cap)).astype(
                np.int32)).to(dev)
            idx = slot_scatter(dest, valid, p, pair_capacity(cap, p)).idx
        else:
            keep = 1 << (int(valid.sum(dim=1).max()) - 1).bit_length()
            idx = torch.argsort((~valid).to(torch.uint8), dim=1,
                                stable=True)[:, :keep]
        return cols((p, cap), ncols), idx, False
    if name == "merge_replica_outer":
        return cols((18_000,), 6, "ifb"), index((p, cap), 18_000), True
    if name == "ragged_edge":
        return (cols((3, 1_000), 4, "bilf"), index((3, 5, 1_371), 1_000),
                False)
    if name == "many_columns":
        return cols((p, 10_007), 70), index((p, 10_007), 10_007), True
    if name == "all_invalid":
        return (cols((p, 4_099), 3, "ifl"),
                torch.full((p, 2, 4_099), -1, dtype=torch.int64,
                           device=dev), False)
    if name == "one_dim":
        return cols((257,), 3, "ibl"), index((5_000,), 257), True
    raise KeyError(name)


def check_move_rows(name: str, dev) -> int:
    """The mover on ``dev`` against its plain version on the same tensors,
    bit for bit at every slot (valid or not) and in ``valid``; returns the
    launches the call made."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.move_rows import MAX_COLS, move_rows

    columns, idx, zero_fill = move_rows_case(name, dev)
    before = move_rows.launches
    got, got_valid = move_rows(columns, idx, zero_fill=zero_fill)
    launches = move_rows.launches - before
    want, want_valid = ref.move_rows_ref(columns, idx, zero_fill)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    require(torch.equal(got_valid, want_valid), f"move_rows {name}: valid")
    for n, w in want.items():
        require(got[n].shape == w.shape and got[n].dtype == w.dtype,
                f"move_rows {name} {n}: {tuple(got[n].shape)} "
                f"{got[n].dtype} != {tuple(w.shape)} {w.dtype}")
        require(torch.equal(got[n].view(torch.uint8), w.view(torch.uint8)),
                f"move_rows {name} {n}: values differ")
    widths: dict = {}
    for c in columns.values():
        widths[c.element_size()] = widths.get(c.element_size(), 0) + 1
    if dev.type == "cuda":
        want_launches = sum(-(-k // MAX_COLS) for k in widths.values())
        require(launches == want_launches,
                f"move_rows {name}: {launches} launches, {want_launches} "
                "expected")
    return launches


def check_move_rows_edge_cases(dev) -> None:
    """Every case of ``MOVE_CASES`` bit-identical to the plain version."""
    launches = {name: check_move_rows(name, dev) for name in MOVE_CASES}
    print(f"  move_rows: {len(MOVE_CASES)} cases bit-identical to the plain "
          f"version; launches {launches}")


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
                 "key_range": lambda keys, *a, **kw: keys.numel(),
                 "tiled_probe3": lambda a1, a2, b, c: a1.numel() * (
                     b.shape[-1] + c.shape[-1])}
        callers = {"partition_hist": exchange, "tiled_probe": ops,
                   "bitonic_sort_tile": ops, "bloom_build": rf,
                   "bloom_probe": rf, "key_range": rf, "tiled_probe3": ops}
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
MAIN_KERNELS = ("partition_hist", "tiled_probe", "bitonic_sort_tile",
                "move_rows")
FILTER_KERNELS = ("bloom_build", "bloom_probe", "key_range")


def make_catalog(dev, scale: float, p: int, **skew):
    import torch

    from repro_torch.sql import generate

    t0 = time.perf_counter()
    catalog = generate(scale=scale, p=p, seed=0, device=dev, **skew)
    torch.cuda.synchronize()
    rows = {n: t.count() for n, t in catalog.tables.items()}
    extra = "".join(f", {k}={v}" for k, v in skew.items())
    print(f"  generate(scale={scale}, p={p}, seed=0{extra}): "
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
    suite_bytes: dict = {}
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
            suite_bytes[s.name] = suite_bytes.get(s.name, 0) + \
                res.network_bytes
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
    print("  suite network bytes: " + ", ".join(
        f"{name} {b:.0f}" for name, b in suite_bytes.items()))
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


#: Device kernels of the redesigned kernels, by the names the profiler
#: gives them.
WATCHED = {"partition_hist": ("hist_registers", "hist_bins"),
           "bloom_probe": ("bloom_probe_kernel",),
           "bloom_build": ("bloom_build_",),
           "bitonic_sort_tile": ("bitonic_sort_kernel",),
           "key_range": ("key_range", "empty_range")}


def union_us(spans) -> float:
    """Length of the union of (start, stop) intervals."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def profile_pass(run_all) -> None:
    """One more pass over the main path under ``torch.profiler``: the
    device's busy and idle share of the pass's wall time, the kernels that
    take the device time, and the device time and activities of the
    ``WATCHED`` kernels."""
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
    busy = union_us(spans)
    total = sum(us for _, us in by_name.values())
    print(f"  profile pass: wall {wall_us / 1e3:.1f} ms (profiler on), "
          f"device busy {busy / 1e3:.1f} ms, idle share "
          f"{1 - busy / wall_us:.3f}; {sum(n for n, _ in by_name.values())} "
          "device activities")
    for label, parts in WATCHED.items():
        hits = [(n, us) for name, (n, us) in by_name.items()
                if any(part in name for part in parts)]
        print(f"  {label} kernels: {sum(n for n, _ in hits)} activities, "
              f"{sum(us for _, us in hits) / 1e3:.3f} ms of device time")
    memsets = sum(n for name, (n, _) in by_name.items() if "Memset" in name)
    print(f"  memsets: {memsets} activities")
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
    from repro_torch.kernels import ref
    from repro_torch.kernels.tiled_probe import tiled_probe

    rows = []

    _, (dest,), kw = calls["partition_hist"]
    rows.append(measure_hist(dest, kw["nd"], kw.get("valid"),
                             launches["partition_hist"]))

    _, (a, b), _ = calls["tiled_probe"]
    bsz, na = a.shape
    nb = b.shape[1]
    got, want = tiled_probe(a, b), ref.tiled_probe_ref(a, b)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    b_ms, b_by = bound(*probe_least_work([a], [b]))
    print(f"  tiled_probe input: {float((a != -1).float().mean()):.3f} of "
          f"the probe slots hold a row; hit rate "
          f"{float((want >= 0).float().mean()):.3f}; a dense scan would make "
          f"{dense_compares(want, nb):.4g} compares; "
          f"{copy_yardstick(a.numel())}")
    rows.append(dict(
        name="tiled_probe", route="cuda",
        source="src/repro_torch/csrc/tiled_probe.cu",
        replaces="src/repro/kernels/tiled_probe.py:72",
        launches=launches["tiled_probe"], max_abs_err=err,
        **time_kernel(lambda: tiled_probe(a, b), 20, cold=True),
        plain_ms=cuda_ms(lambda: ref.tiled_probe_ref(a, b), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"B={bsz} na={na} nb={nb}"))

    _, (k, v), _ = calls["bitonic_sort_tile"]
    rows.append(measure_sort(k, v, launches["bitonic_sort_tile"]))

    report_kernels(rows)
    return rows


def sort_least_work(bsz: int, n: int) -> tuple[float, float]:
    """Least work of the bitonic sort of (bsz, n) pairs: keys and values
    read once and written once (16 bytes an element); log2 n (log2 n + 1)
    / 2 stages of n/2 compare-exchanges a row, each a compare and four
    selects (the lower and upper key and value), 5 operations. Returns
    (bytes, operations)."""
    logn = int(math.log2(n)) if n > 1 else 0
    return 16.0 * bsz * n, 5.0 * bsz * (n // 2) * logn * (logn + 1) // 2


def bloom_build_least_work(n: int, n_valid: int, m_bits: int, k: int
                           ) -> tuple[float, float]:
    """Least work of the bloom build: each key and mask byte read once and
    each word written once; one operation a key for its mask, two 32-bit
    hashes a valid key (13 integer operations: two mix chains and the
    odd-forcing OR) and 7 for each of its k bit positions and its word
    update. Returns (bytes, operations)."""
    return 5.0 * n + m_bits // 8, float(n + n_valid * (13 + 7 * k))


def sort_cases(k, v) -> dict:
    """The inputs at which the bitonic sort is timed: the path's largest
    (``main``), four times its rows, its keys in tiles of 4,096, and the
    fixed cost of a call (B = 1, n = 2)."""
    def tiles(x):
        flat = x.reshape(-1)
        if flat.numel() < 4096:
            flat = flat.repeat(4096 // flat.numel() + 1)
        return flat[:flat.numel() // 4096 * 4096].reshape(-1, 4096)
    return {"main": (k, v), "4x": (k.repeat(4, 1), v.repeat(4, 1)),
            "n=4096": (tiles(k), tiles(v)),
            "fixed cost": (k[:1, :2].contiguous(), v[:1, :2].contiguous())}


def bloom_cases(keys, valid) -> dict:
    """The inputs at which the bloom build is timed: the path's largest
    (``main``), its keys four times over, its first 4,096 keys, and the
    fixed cost of a call (32 keys)."""
    flat_k, flat_v = keys.reshape(-1), valid.reshape(-1)
    return {"main": (keys, valid),
            "4x": (flat_k.repeat(4), flat_v.repeat(4)),
            "n=4096": (flat_k[:4096], flat_v[:4096]),
            "fixed cost": (flat_k[:32], flat_v[:32])}


def device_activities(fn, calls: int = 20):
    """Device activities (kernels, memsets, copies) a call of ``fn`` queues,
    by ``torch.profiler`` over ``calls`` calls; None where the profiler
    recorded none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return n / calls if n else None


def case_times(cases: dict, call, reps: int) -> dict:
    """``time_kernel`` (cold too) of ``call(*args)`` at each of ``cases``
    (label -> args)."""
    return {label: time_kernel(lambda: call(*args), reps, cold=True)
            for label, args in cases.items()}


def range_cases(keys, valid) -> dict:
    """The inputs at which key_range is timed: the path's largest
    (``main``), its keys four times over, and the fixed cost of a call (32
    keys)."""
    flat_k, flat_v = keys.reshape(-1), valid.reshape(-1)
    return {"main": (keys, valid),
            "4x": (flat_k.repeat(4), flat_v.repeat(4)),
            "fixed cost": (flat_k[:32], flat_v[:32])}


def sort_bloom_kernel_times(k, v, keys, valid, m_bits: int,
                            n_hashes: int, range_keys=None,
                            range_valid=None) -> dict:
    """The bitonic sort's, the bloom build's and, where its inputs are
    given, key_range's times at ``sort_cases``, ``bloom_cases`` and
    ``range_cases`` (``case_times``), and their device activities a call at
    the main input. It calls only the wrappers, so it times any tree of the
    port (``tools/time_sort_bloom.py``)."""
    from repro_torch.kernels.bitonic_sort import bitonic_sort_tile
    from repro_torch.kernels.bloom import bloom_build
    from repro_torch.kernels.zone_map import key_range

    def build(kk, vv):
        return bloom_build(kk, vv, m_bits=m_bits, k=n_hashes)

    out = {"bitonic_sort_tile": case_times(sort_cases(k, v),
                                           bitonic_sort_tile, 50),
           "bloom_build": case_times(bloom_cases(keys, valid), build, 100),
           "activities": {
               "bitonic_sort_tile": device_activities(
                   lambda: bitonic_sort_tile(k, v)),
               "bloom_build": device_activities(lambda: build(keys, valid))}}
    if range_keys is not None:
        out["key_range"] = case_times(range_cases(range_keys, range_valid),
                                      key_range, 100)
        out["activities"]["key_range"] = device_activities(
            lambda: key_range(range_keys, range_valid))
    return out


def measure_sort(k, v, launches: int) -> dict:
    """K3 at the main path's largest call: the JSON row, held bit for bit
    against the reference's network, and the ``sort_cases`` readings, each
    beside its bound, the plain version and ``torch.sort``."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bitonic_sort import bitonic_sort_tile

    bsz, n = k.shape
    gk, gv = bitonic_sort_tile(k, v)
    wk, wv = ref.bitonic_network_ref(k, v)
    err = max(float((gk - wk).abs().max()), float((gv - wv).abs().max()))
    cases = sort_cases(k, v)
    times = case_times(cases, bitonic_sort_tile, 50)
    rows = {}
    for label, (kk, vv) in cases.items():
        b_ms, b_by = bound(*sort_least_work(*kk.shape))
        rows[label] = dict(
            name="bitonic_sort_tile", route="cuda",
            source="src/repro_torch/csrc/bitonic_sort.cu",
            replaces="src/repro/kernels/bitonic_sort.py:66",
            launches=launches, max_abs_err=err, **times[label],
            plain_ms=cuda_ms(lambda: ref.bitonic_network_ref(kk, vv), 20),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: torch.sort(kk, dim=-1), 50),
            library_device_ms=device_ms(lambda: torch.sort(kk, dim=-1), 50),
            shape=f"B={kk.shape[0]} n={kk.shape[1]}")
    print(f"  bitonic_sort_tile at B={bsz}, n={n}: keys and values equal "
          "the reference's network; device activities a call "
          f"{device_activities(lambda: bitonic_sort_tile(k, v))}")
    print_cases("bitonic_sort_tile", rows, "torch.sort")
    return rows["main"]


def measure_bloom_build(keys, valid, m_bits: int, k: int,
                        launches: int) -> dict:
    """K4 at the filter path's largest call: the JSON row, and the
    ``bloom_cases`` readings, each bit for bit against the plain version
    and beside its bound and the plain version's time."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bloom import bloom_build, build_branch

    def build(kk, vv):
        return bloom_build(kk, vv, m_bits=m_bits, k=k)

    cases = bloom_cases(keys, valid)
    times = case_times(cases, build, 100)
    rows = {}
    for label, (kk, vv) in cases.items():
        flat_k, flat_v = kk.reshape(-1), vv.reshape(-1)
        n, n_valid = flat_k.numel(), int(flat_v.sum())
        want = ref.bloom_build_ref(flat_k, flat_v, m_bits, k)
        b_ms, b_by = bound(*bloom_build_least_work(n, n_valid, m_bits, k))
        rows[label] = dict(
            name="bloom_build", route="cuda",
            source="src/repro_torch/csrc/bloom.cu",
            replaces="src/repro/kernels/bloom.py:140",
            launches=launches,
            max_abs_err=float((build(kk, vv).long() - want.long()).abs()
                              .max()),
            **times[label],
            plain_ms=cuda_ms(lambda: ref.bloom_build_ref(flat_k, flat_v,
                                                         m_bits, k), 20),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=f"n={n} valid={n_valid} m_bits={m_bits} k={k} "
                  f"{build_branch(n, m_bits)}")
    print(f"  bloom_build: device activities a call "
          f"{device_activities(lambda: build(keys, valid))}")
    print_cases("bloom_build", rows, None)
    return rows["main"]


def print_cases(name: str, rows: dict, library: str | None) -> None:
    for label, r in rows.items():
        require(r["max_abs_err"] == 0,
                f"{name} disagrees with its plain version at {r['shape']}")
        lib = ""
        if library:
            lib = f", {library} {r['library_ms']:.4f} ms"
            if "library_device_ms" in r:
                lib += f" (device {r['library_device_ms']:.4f} ms)"
        print(f"    {label:10s} {r['shape']:44s} events {r['ms']:.4f} ms, "
              f"device {r['device_ms']:.4f} ms, L2 emptied "
              f"{r['device_cold_ms']:.4f} ms; bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}); plain {r['plain_ms']:.4f} ms{lib}")


def hist_least_work(n: int, nd: int, masked: bool) -> tuple[float, float]:
    """Least work of partition_hist: each destination (and mask byte) read
    once, each count written once; one operation an element. Returns
    (bytes, operations)."""
    return (4 + masked) * n + 4 * nd, n


def measure_hist(dest, nd: int, valid, launches: int) -> dict:
    """K1 at a path's largest call, masked as the exchange calls it:
    the JSON row, and beside it the unmasked call, the same input four
    times over, L2 emptied, the old pair (``torch.where`` then the
    histogram) and a read-only reduction of the same destination bytes."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.partition_hist import partition_hist

    n = dest.numel()
    masked = lambda: partition_hist(dest, nd=nd, valid=valid)  # noqa: E731
    unmasked = lambda: partition_hist(dest, nd=nd)  # noqa: E731
    got = masked()
    err = float((got - ref.partition_hist_ref(dest, nd, valid)).abs().max())
    shifted = torch.where(valid, dest, -1) + 1  # bincount's bin 0 takes -1
    b_ms, b_by = bound(*hist_least_work(n, nd, True))
    row = dict(
        name="partition_hist", route="cuda",
        source="src/repro_torch/csrc/partition_hist.cu",
        replaces="src/repro/kernels/partition_hist.py:46",
        launches=launches, max_abs_err=err,
        **time_kernel(masked, 100, cold=True),
        plain_ms=cuda_ms(lambda: ref.partition_hist_ref(dest, nd, valid), 20),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.bincount(shifted,
                                                  minlength=nd + 1), 50),
        shape=f"n={n} nd={nd} masked")
    print(f"  partition_hist at n={n}, nd={nd} "
          f"({float(valid.float().mean()):.3f} of the rows valid):")
    print(f"    masked, as the exchange calls it: "
          f"{device_readings(masked, 100, b_ms)}; bound {b_ms:.5f} ms "
          f"({b_by})")
    u_ms, _ = bound(*hist_least_work(n, nd, False))
    print(f"    unmasked: {device_readings(unmasked, 100, u_ms)}; bound "
          f"{u_ms:.5f} ms")
    old = device_ms(lambda: partition_hist(torch.where(valid, dest, -1),
                                           nd=nd), 100)
    print(f"    the old pair, torch.where then the unmasked call: device "
          f"{old:.4f} ms")
    small = lambda: partition_hist(dest[:4096], nd=nd,  # noqa: E731
                                   valid=valid[:4096])
    print(f"    the same call on its first 4,096 rows (the fixed cost): "
          f"device {device_ms(small, 100):.4f} ms")
    total = lambda: dest.sum()  # noqa: E731
    print(f"    yardstick, dest.sum() over the same {4 * n / 1e6:.1f} MB: "
          f"device {device_ms(total, 100):.4f} ms, L2 emptied "
          f"{device_ms(total, 100, flush=l2_flush()):.4f} ms")
    d4, v4 = dest.repeat(4), valid.repeat(4)
    b4, _ = bound(*hist_least_work(4 * n, nd, True))
    u4, _ = bound(*hist_least_work(4 * n, nd, False))
    masked4 = lambda: partition_hist(d4, nd=nd, valid=v4)  # noqa: E731
    unmasked4 = lambda: partition_hist(d4, nd=nd)  # noqa: E731
    total4 = lambda: d4.sum()  # noqa: E731
    print(f"    four times the input (n={4 * n}): masked "
          f"{device_readings(masked4, 50, b4)}, bound {b4:.5f} ms; unmasked "
          f"{device_readings(unmasked4, 50, u4)}, bound {u4:.5f} ms; "
          f"dest.sum() {device_ms(total4, 50):.4f} ms, L2 emptied "
          f"{device_ms(total4, 50, flush=l2_flush()):.4f} ms")
    return row


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
    rows = []

    _, (keys, valid), kw = calls["bloom_build"]
    rows.append(measure_bloom_build(keys, valid, kw["m_bits"], kw["k"],
                                    launches["bloom_build"]))

    _, (keys, words), kw = calls["bloom_probe"]
    rows.append(measure_bloom_probe(keys, words, kw["k"],
                                    launches["bloom_probe"]))

    _, (keys, valid), _ = calls["key_range"]
    rows.append(measure_key_range(keys, valid, launches["key_range"]))
    report_kernels(rows)
    return rows


def key_range_least_work(n: int) -> tuple[float, float]:
    """Least work of key_range: each key and mask byte read once and the
    two words written once; one compare each way a key. Returns (bytes,
    operations)."""
    return 5.0 * n + 8, 2.0 * n


def measure_key_range(keys, valid, launches: int) -> dict:
    """K6 at the filter path's largest call: the JSON row, and the
    ``range_cases`` readings, each bit for bit against the plain version
    and beside its bound, the plain version's time and
    ``torch.aminmax(keys[valid])``; its device activities a call, and what
    the wrapper costs on the host, part by part."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.zone_map import key_range, range_branch

    cases = range_cases(keys, valid)
    times = case_times(cases, key_range, 100)
    rows = {}
    for label, (kk, vv) in cases.items():
        flat_k, flat_v = kk.reshape(-1), vv.reshape(-1)
        n = flat_k.numel()
        want = ref.key_range_ref(flat_k, flat_v)
        b_ms, b_by = bound(*key_range_least_work(n))
        # The masked keys' compaction syncs the host on every call, so
        # its device time alone cannot be queued behind a sleep.
        lib = lambda: torch.aminmax(flat_k[flat_v])  # noqa: E731
        rows[label] = dict(
            name="key_range", route="cuda",
            source="src/repro_torch/csrc/zone_map.cu",
            replaces="src/repro/kernels/zone_map.py:75",
            launches=launches,
            max_abs_err=float((key_range(kk, vv).long() - want.long()).abs()
                              .max()),
            **times[label],
            plain_ms=cuda_ms(lambda: ref.key_range_ref(flat_k, flat_v), 50),
            bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib, 50),
            shape=f"{tuple(kk.shape)} valid={int(flat_v.sum())} "
                  f"{range_branch(n)}")
    print(f"  key_range: device activities a call "
          f"{device_activities(lambda: key_range(keys, valid))}")
    print_cases("key_range", rows, "torch.aminmax(keys[valid])")
    print("  key_range on the host, us a call: "
          f"{key_range_host_split(keys, valid)}")
    return rows["main"]


def key_range_host_split(keys, valid, reps: int = 2000) -> str:
    """What one key_range call costs on the host, part by part, by the
    host clock over ``reps`` calls of each part: the flat views of keys
    and mask (``flat_keys``, ``flat_valid``), the output's
    ``torch.empty``, the ctypes call that launches the kernel, and the
    whole wrapper."""
    import torch

    from repro_torch.kernels import zone_map
    from repro_torch.kernels.build import library
    from repro_torch.kernels.launch import flat_keys, flat_valid, workspace

    flat = flat_keys(keys)
    v = flat_valid(valid, flat)
    out = torch.empty(2, dtype=torch.int32, device=flat.device)
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    branch = zone_map.range_branch(flat.numel())
    code = zone_map.RANGE_BRANCHES.index(branch)
    ws = (None if branch == "block"
          else workspace(flat.device, stream, 2).data_ptr())
    parts = {
        "flat_keys+flat_valid": lambda: flat_valid(valid, flat_keys(keys)),
        "torch.empty": lambda: torch.empty(2, dtype=torch.int32,
                                           device=flat.device),
        "ctypes call": lambda: lib.repro_key_range(
            flat.data_ptr(), v.data_ptr(), flat.numel(), code, ws,
            out.data_ptr(), stream),
        "wrapper": lambda: zone_map.key_range(keys, valid)}
    readings = []
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        readings.append(f"{name} {(t1 - t0) / reps * 1e6:.2f}")
    return ", ".join(readings)


def bloom_probe_least_work(flat_k, words, k: int) -> tuple[float, float]:
    """Least work of bloom_probe on these keys: each key read once and its
    byte written once, the filter read once; two hash chains a key (13
    operations) and 7 for each bit the key's data makes it test, up to its
    first clear bit. Returns (bytes, operations)."""
    import torch

    from repro_torch.kernels import ref

    m_bits = words.numel() * 32
    alive = torch.ones_like(flat_k, dtype=torch.bool)
    tested = 0
    w64 = words.long() & 0xFFFFFFFF
    for i in range(k):
        tested += int(alive.sum())
        pos = ref.bloom_positions(flat_k, i, m_bits)
        alive &= ((w64[pos >> 5] >> (pos & 31)) & 1).bool()
    n = flat_k.numel()
    return 5.0 * n + m_bits // 8, 13.0 * n + 7 * tested


def measure_bloom_probe(keys, words, k: int, launches: int) -> dict:
    """K5 at the filter path's largest call: the JSON row, and beside it
    the device time back to back and with L2 emptied at this input and at
    four times it, the fixed cost of a call, and a copy of the keys."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bloom import bloom_probe

    m_bits = words.numel() * 32
    flat_k = keys.reshape(-1)
    n = flat_k.numel()
    probe = lambda: bloom_probe(keys, words, k=k)  # noqa: E731
    got = probe()
    want = ref.bloom_probe_ref(flat_k, words, k)
    nbytes, ops = bloom_probe_least_work(flat_k, words, k)
    b_ms, b_by = bound(nbytes, ops)
    row = dict(
        name="bloom_probe", route="cuda",
        source="src/repro_torch/csrc/bloom.cu",
        replaces="src/repro/kernels/bloom.py:167",
        launches=launches,
        max_abs_err=float((got.reshape(-1).int() - want.int()).abs().max()),
        **time_kernel(probe, 200, cold=True),
        plain_ms=cuda_ms(lambda: ref.bloom_probe_ref(flat_k, words, k), 20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{tuple(keys.shape)} m_bits={m_bits} k={k} kept="
              f"{float(want.float().mean()):.3f}")
    keys4 = keys.repeat(1, 4)
    b4, _ = bound(*bloom_probe_least_work(keys4.reshape(-1), words, k))
    four = lambda: bloom_probe(keys4, words, k=k)  # noqa: E731
    head = flat_k[:4096]
    print(f"  bloom_probe at {tuple(keys.shape)}, m_bits={m_bits}, k={k}: "
          f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.1f}M operations; bound "
          f"{b_ms:.5f} ms ({b_by})")
    print(f"    {device_readings(probe, 200, b_ms)}; four times the input "
          f"{device_readings(four, 100, b4)}, bound {b4:.5f} ms")
    print(f"    the same call on 4,096 keys (the fixed cost): device "
          f"{device_ms(lambda: bloom_probe(head, words, k=k), 100):.4f} ms; "
          f"{copy_yardstick(n)}; four times: {copy_yardstick(4 * n)}")
    return row


def report_kernels(rows: list) -> None:
    for r in rows:
        require(r["max_abs_err"] == 0, f"{r['name']} disagrees with its "
                f"plain version at {r['shape']}")
        lib = ("none (no single PyTorch call computes it)"
               if r["library_ms"] is None else f"{r['library_ms']:.4f} ms")
        cold = (f", L2 emptied {r['device_cold_ms']:.4f} ms"
                if "device_cold_ms" in r else "")
        print(f"  {r['name']:18s} {r['shape']:22s} kernel {r['ms']:.4f} ms "
              f"(device {r['device_ms']:.4f} ms{cold}), bound "
              f"{r['bound_ms']:.5f} "
              f"ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library "
              f"{lib}")


# ---------------------------------------------------------------------------
# Phase 5c: the text-only and skew-target suites
# ---------------------------------------------------------------------------

def text_suite():
    """q16-q18 and q24-q34, parsed from their SQL text: the queries of the
    golden fixture that the earlier phases leave out."""
    from repro_torch.sql import skewed_queries, text_queries
    return {**skewed_queries(), **text_queries()}


def run_text_path(catalog) -> None:
    """q16-q18 and q24-q34 under the four default strategies on the main
    path's catalog (uniform keys: the skew-aware strategy is a later
    slice): a warm-up pass, then the reported pass with every launch count
    set to 0 just before and read just after, then one pass under
    ``torch.profiler``. Every strategy must give the same rows, and K1, K2
    and K3 must have launched."""
    import numpy as np
    import torch

    from repro_torch.joins.ref import rows_as_set, rows_close
    from repro_torch.kernels import ops
    from repro_torch.sql import Executor, default_strategies

    queries, strategies = text_suite(), default_strategies()
    require(len(queries) == 14, f"q16-q18, q24-q34: {sorted(queries)}")

    def run_all():
        for qname, plan in queries.items():
            for s in strategies:
                yield qname, s, Executor(catalog, s).execute(plan)

    t_warm = time.perf_counter()
    for _ in run_all():  # first calls of every torch op, not reported
        pass
    print(f"  warm-up pass: {time.perf_counter() - t_warm:.1f} s")

    results: dict = {}
    suite: dict = {}
    ops.reset_launch_counts()
    t_phase = time.perf_counter()
    before = ops.launch_counts()
    for qname, s, res in run_all():
        after = ops.launch_counts()
        delta = ",".join(str(after[k] - before[k]) for k in after)
        before = after
        cols = res.table.to_numpy()
        results[(qname, s.name)] = cols
        tot = suite.setdefault(s.name, [0.0, 0.0, 0.0, 0.0])
        for i, v in enumerate((res.network_bytes, res.local_bytes,
                               res.straggler_bytes, res.wall_time_s)):
            tot[i] += v
        print(f"  {qname:26s} {s.name:13s} "
              f"{','.join(m.value for m in res.methods()):52s} "
              f"net={res.network_bytes:.0f} local={res.local_bytes:.0f} "
              f"straggler={res.straggler_bytes:.0f} rows={res.rows} "
              f"wall={res.wall_time_s * 1e3:.2f}ms launches={delta}")
        for name, c in cols.items():
            if c.dtype.kind == "f":
                require(bool(np.isfinite(c).all()),
                        f"{qname} {s.name}: non-finite {name}")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"  text suites: {time.perf_counter() - t_phase:.1f} s for "
          f"{len(results)} runs; launches {launches}")
    for name, (net, local, strag, wall) in suite.items():
        print(f"  suite {name:13s} network {net:.0f}, local {local:.0f}, "
              f"straggler {strag:.0f} bytes; wall {wall * 1e3:.2f} ms")
    for name in MAIN_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} never launched on the text suites")

    for qname in queries:
        first = rows_as_set(results[(qname, strategies[0].name)])
        gap = 0.0
        for s in strategies[1:]:
            other = rows_as_set(results[(qname, s.name)])
            require(rows_close(first, other),
                    f"{qname}: {s.name} rows differ from "
                    f"{strategies[0].name}")
            gap = max(gap, float_gap(first, other))
        print(f"  {qname:26s} {len(first)} rows agree across strategies; "
              f"worst relative gap {gap:.3e}")

    profile_pass(run_all)


# ---------------------------------------------------------------------------
# Phase 5d: skew, re-optimization and verification
# ---------------------------------------------------------------------------

#: The Zipf exponent of the reference's skew suite (``zipf_catalogs``), and
#: the override of its forced-divergence re-optimization catalog.
SKEW_ZIPF = 1.2
REOPT_OVERRIDES = {"ss_item_sk": 1.3}


def reopt_chain():
    """The 3-leaf chain of the reference's re-optimization suite:
    (store_sales ⋈ σ(item)) ⋈ date_dim."""
    from repro_torch.sql.logical import Filter, Join, Scan
    return Join(Join(Scan("store_sales"),
                     Filter(Scan("item"), "i_item_sk", "lt", 150.0),
                     "ss_item_sk", "i_item_sk"),
                Scan("date_dim"), "ss_sold_date_sk", "d_date_sk")


class SkewSpy:
    """Counts the executor's calls of its join methods (one more than a
    join's overflow retries), keeps the largest ``partition_hist`` call at
    ``nd`` bins (``hot_fine_buckets``' histogram), and collects the build
    rows each hash join's bucketing drops (``slot_scatter``'s overflow,
    which ``hash_join`` does not read), as device tensors summed after the
    run, so that no host sync is added to it."""

    def __init__(self, nd: int):
        self.nd, self.calls, self.largest = nd, 0, None
        self.dropped: list = []

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.joins import exchange, local_join
        from repro_torch.sql import executor
        hist, run = exchange.partition_hist, executor.run_equi_join
        scatter = local_join.slot_scatter

        def spy_hist(dest, *, nd, valid=None):
            if nd == self.nd and (self.largest is None
                                  or dest.numel() > self.largest[0].numel()):
                self.largest = (dest, valid)
            return hist(dest, nd=nd, valid=valid)

        def spy_run(*args, **kwargs):
            self.calls += 1
            return run(*args, **kwargs)

        def spy_scatter(*args, **kwargs):
            out = scatter(*args, **kwargs)
            self.dropped.append(out.overflow)
            return out

        exchange.partition_hist, executor.run_equi_join = spy_hist, spy_run
        local_join.slot_scatter = spy_scatter
        try:
            yield self
        finally:
            exchange.partition_hist, executor.run_equi_join = hist, run
            local_join.slot_scatter = scatter


def same_rows(a: dict, b: dict) -> bool:
    """Multiset equality of two results' column dicts without building a
    Python tuple per row (the chain's results hold millions): both sorted
    by every column, integer columns first, then integers equal and floats
    within ``rows_close``'s tolerance."""
    import numpy as np
    if sorted(a) != sorted(b) or len(next(iter(a.values()), ())) != len(
            next(iter(b.values()), ())):
        return False
    names = sorted(a, key=lambda n: (a[n].dtype.kind == "f", n))
    ia, ib = (np.lexsort([c[n] for n in reversed(names)]) for c in (a, b))
    for n in names:
        x, y = a[n][ia], b[n][ib]
        if x.dtype.kind == "f":
            if not np.allclose(x, y, rtol=1e-3, atol=1e-4):
                return False
        elif not np.array_equal(x, y):
            return False
    return True


def describe_skew_run(res) -> str:
    return " ".join(
        f"{d.selection.method.value}(r={d.selection.salt_r},"
        f"s={d.left_stats.skew:.3f}/{d.right_stats.skew:.3f})"
        for d in res.decisions)


def run_skew_path(uniform, dev, scale: float):
    """Phase 5d. q16-q18 on ``generate(scale, 8, 0, skew=SKEW_ZIPF)`` under
    RelJoin, SkewAware and Reorder(SkewAware): a warm-up pass, then the
    reported pass (launch counts and K1's branch counts set to 0 just
    before and read just after), then one pass under ``torch.profiler``.
    q16-q18 under SkewAware on the uniform catalog take RelJoin's methods.
    Then checkpoint re-optimization on the reference's chain and q13-q15,
    reopt on beside reopt off, on the uniform catalog and on the
    forced-divergence one. Every run has every plan-analysis gate armed.
    Returns the phase's launch counts and ``hot_fine_buckets``' largest
    input: ``(dest, valid, nd)``."""
    import numpy as np
    import torch

    from repro_torch.core.cost_model import JoinMethod
    from repro_torch.joins.exchange import HOT_FINE_MULT
    from repro_torch.joins.ref import rows_as_set, rows_close
    from repro_torch.kernels import ops
    from repro_torch.kernels.partition_hist import partition_hist
    from repro_torch.sql import (Executor, RelJoinStrategy,
                                 ReorderingStrategy, SkewAwareStrategy,
                                 misordered_queries, skewed_queries)

    zipf = make_catalog(dev, scale, p=8, skew=SKEW_ZIPF)
    queries = skewed_queries()
    strategies = [RelJoinStrategy(), SkewAwareStrategy(),
                  ReorderingStrategy(SkewAwareStrategy())]
    spy = SkewSpy(HOT_FINE_MULT * zipf.p)

    def run_all():
        for qname, plan in queries.items():
            for s in strategies:
                spy.calls = 0
                res = Executor(zipf, s, verify=True).execute(plan)
                yield qname, s, res, spy.calls - len(res.decisions)

    t_warm = time.perf_counter()
    with spy.installed():
        for _ in run_all():  # first calls of every torch op, not reported
            pass
    print(f"  warm-up pass: {time.perf_counter() - t_warm:.1f} s")

    results: dict = {}
    dropped: dict = {}
    spy.largest, spy.dropped = None, []
    ops.reset_launch_counts()
    for branch in partition_hist.branch_launches:
        partition_hist.branch_launches[branch] = 0
    t_phase = time.perf_counter()
    with spy.installed():
        before = ops.launch_counts()
        for qname, s, res, retries in run_all():
            after = ops.launch_counts()
            delta = ",".join(str(after[k] - before[k]) for k in after)
            before = after
            dropped[(qname, s.name)] = spy.dropped
            spy.dropped = []
            cols = res.table.to_numpy()
            results[(qname, s.name)] = (res, rows_as_set(cols))
            print(f"  {qname:24s} {s.name:24s} {describe_skew_run(res)} "
                  f"net={res.network_bytes:.0f} local={res.local_bytes:.0f} "
                  f"straggler={res.straggler_bytes:.0f} retries={retries} "
                  f"rows={res.rows} wall={res.wall_time_s * 1e3:.2f}ms "
                  f"launches={delta}")
            for name, c in cols.items():
                if c.dtype.kind == "f":
                    require(bool(np.isfinite(c).all()),
                            f"{qname} {s.name}: non-finite {name}")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    branches = dict(partition_hist.branch_launches)
    print(f"  skew path: {time.perf_counter() - t_phase:.1f} s for "
          f"{len(results)} runs; launches {launches}; partition_hist by "
          f"branch {branches}")
    require(branches["shared"] > 0,
            "partition_hist's shared branch never launched on the skew path")
    lost = {k: sum(int(t.sum()) for t in v) for k, v in dropped.items()}
    print("  build rows dropped by hash_join's bucketing (not read, as in "
          "the reference): " + ", ".join(
              f"{q} {s} {n}" for (q, s), n in lost.items()))
    for name in ("partition_hist", "tiled_probe"):
        require(launches[name] > 0,
                f"kernel {name} never launched on the skew path")
    salted = 0
    for qname in queries:
        (base, base_rows), *others = [results[(qname, s.name)]
                                      for s in strategies]
        for s, (res, rows) in zip(strategies[1:], others):
            require(rows_close(base_rows, rows),
                    f"{qname}: {s.name} rows differ from {strategies[0].name}")
        skew_res = others[0][0]
        if JoinMethod.SALTED_SHUFFLE_HASH in skew_res.methods():
            salted += 1
            require(skew_res.straggler_bytes < base.straggler_bytes,
                    f"{qname}: SkewAware's straggler bytes "
                    f"{skew_res.straggler_bytes:.0f} not below RelJoin's "
                    f"{base.straggler_bytes:.0f}")
        salted += sum(JoinMethod.SALTED_SHUFFLE_HASH in r.methods()
                      for r, _ in others[1:])
        print(f"  {qname:24s} {len(base_rows)} rows agree across the three "
              f"arms; straggler bytes RelJoin {base.straggler_bytes:.0f}, "
              f"SkewAware {skew_res.straggler_bytes:.0f}, Reorder(SkewAware) "
              f"{others[1][0].straggler_bytes:.0f}")
    require(salted > 0, "no run selected SALTED_SHUFFLE_HASH")

    for qname, plan in queries.items():
        got = Executor(uniform, SkewAwareStrategy(), verify=True).execute(plan)
        want = Executor(uniform, RelJoinStrategy(), verify=True).execute(plan)
        require(got.methods() == want.methods(),
                f"{qname}: SkewAware's methods {got.methods()} on uniform "
                f"keys are not RelJoin's {want.methods()}")
    print("  uniform keys: SkewAware's methods equal RelJoin's on q16-q18")

    t_profile = time.perf_counter()
    profile_pass(lambda: ((q, s, r) for q, s, r, _ in run_all()))
    print(f"  profile pass and its report: "
          f"{time.perf_counter() - t_profile:.1f} s")

    tilted = make_catalog(dev, scale, p=8, skew_overrides=REOPT_OVERRIDES)
    plans = {"reopt_chain": reopt_chain(), **misordered_queries()}
    triggers = 0
    t_reopt = time.perf_counter()
    for label, cat in (("uniform", uniform), ("tilted", tilted)):
        for qname, plan in plans.items():
            runs = {reopt: Executor(cat, ReorderingStrategy(
                RelJoinStrategy(), reopt=reopt), adaptive=False,
                verify=True).execute(plan) for reopt in (False, True)}
            off, on = runs[False], runs[True]
            require(on.reopts, f"{label} {qname}: no checkpoint recorded")
            for d in on.reopts:
                require(d.triggered == (d.q_error > d.threshold),
                        f"{label} {qname}: checkpoint {d.boundary} "
                        f"triggered={d.triggered} at q-error {d.q_error}")
                require(d.triggered or d.new_next == d.old_next,
                        f"{label} {qname}: untriggered checkpoint "
                        f"{d.boundary} changed the continuation")
            require(on.rows == off.rows and same_rows(on.table.to_numpy(),
                                                      off.table.to_numpy()),
                    f"{label} {qname}: reopt rows differ from reopt off")
            if label == "uniform":
                require(on.reopt_count == 0,
                        f"uniform {qname}: {on.reopt_count} checkpoints "
                        "triggered")
                require(on.methods() == off.methods()
                        and on.network_bytes == off.network_bytes,
                        f"uniform {qname}: reopt changed the decisions")
            elif qname == "reopt_chain":
                triggers += on.reopt_count
            print(f"  reopt {label:7s} {qname:24s} checkpoints "
                  + ", ".join(f"{d.boundary}:q={d.q_error:.3f}"
                              f"{'*' if d.triggered else ''}"
                              f"->{d.new_next}" for d in on.reopts)
                  + f"; methods {','.join(m.value for m in on.methods())}"
                  f" (off {','.join(m.value for m in off.methods())}); "
                  f"net {on.network_bytes:.0f} (off {off.network_bytes:.0f})"
                  f"; rows {on.rows}; wall {on.wall_time_s * 1e3:.2f} ms "
                  f"(off {off.wall_time_s * 1e3:.2f})")
    require(triggers > 0, "no checkpoint triggered on the forced-divergence "
            "catalog's chain")
    print(f"  re-optimization: {time.perf_counter() - t_reopt:.1f} s for "
          f"{4 * len(plans)} runs, row checks included")
    del tilted, zipf
    return launches, (*spy.largest, spy.nd)


# ---------------------------------------------------------------------------
# Phase 5e: the query service and the nested-loop joins
# ---------------------------------------------------------------------------

#: The shared-subtree pairs of the service suite: q33 repeats q19's join
#: and q34 repeats q22's.
SHARED_PAIRS = (("q19_filtered_customer", "q33_shared_customer_join"),
                ("q22_zone_map_window", "q34_shared_window_join"))
#: The kernels the service batch must launch (K3 only where RelJoin picks a
#: sort join).
SERVICE_KERNELS = ("partition_hist", "tiled_probe") + FILTER_KERNELS


def service_batch(catalog, **kw):
    """The service suite submitted to a fresh ``QueryService`` with every
    plan-analysis gate armed, and the service's batch reports."""
    from repro_torch.sql import QueryService, service_queries

    service = QueryService(catalog, verify=True, **kw)
    for qname, plan in service_queries().items():
        service.submit(plan, name=qname)
    return service, service.run()


def run_service_path(catalog) -> None:
    """Phase 5e. The service suite (q19-q23, q33, q34) as one unbudgeted
    batch of a ``QueryService(catalog, verify=True)``, after a warm-up
    batch, with every launch count set to 0 just before the reported batch
    and read just after: rows equal each query's ``execute_solo`` run, the
    two pairs shared, q33 and q34 run no join, fewer joins and bytes than
    serial. Then the suite resubmitted (every plan a cache hit, the filter
    cache's hits rising), a cost-budgeted run (more than one batch, the
    same rows) and one batch under ``torch.profiler``. Then the nested-loop
    joins on the card against the broadcast hash join."""
    import numpy as np
    import torch

    from repro_torch.joins.ref import rows_as_set, rows_close
    from repro_torch.kernels import ops
    from repro_torch.sql import QueryService, service_queries

    queries = service_queries()
    require(len(queries) == 7, f"q19-q23, q33, q34: {sorted(queries)}")

    t_warm = time.perf_counter()
    service_batch(catalog)  # first calls of every torch op, not reported
    print(f"  warm-up batch: {time.perf_counter() - t_warm:.1f} s")

    service = QueryService(catalog, verify=True)
    subs = {q: service.submit(plan, name=q) for q, plan in queries.items()}
    ops.reset_launch_counts()
    reports = service.run()
    launches = ops.launch_counts()
    require(len(reports) == 1, f"unbudgeted run formed {len(reports)} "
            "batches")
    report = reports[0]
    print(f"  batch: wall {report.wall_time_s * 1e3:.2f} ms (host clock, "
          f"ends in a synchronize); launches {launches}; bitonic_sort_tile "
          f"{launches['bitonic_sort_tile']} (not required)")
    for name in SERVICE_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} never launched on the service batch")
    for s in report.shared:
        print(f"  shared x{s.occurrences} {','.join(s.consumers)}: "
              f"{','.join(m.value for m in s.result.methods())} "
              f"net={s.result.network_bytes:.0f} rows={s.result.rows} "
              f"wall={s.result.wall_time_s * 1e3:.2f}ms")
    by_consumers = {frozenset(s.consumers) for s in report.shared}
    for pair in SHARED_PAIRS:
        require(frozenset(pair) in by_consumers, f"{pair} not shared")

    serial_bytes, serial_joins, solo_wall, solo_call = 0.0, 0, 0.0, 0.0
    for qname, plan in queries.items():
        res = report.results[qname]
        t0 = time.perf_counter()
        solo = service.execute_solo(plan)
        torch.cuda.synchronize()
        solo_call += time.perf_counter() - t0
        serial_bytes += solo.network_bytes
        serial_joins += len(solo.decisions)
        solo_wall += solo.wall_time_s
        cols = res.table.to_numpy()
        require(rows_close(rows_as_set(cols),
                           rows_as_set(solo.table.to_numpy())),
                f"{qname}: batched rows differ from solo")
        for name, c in cols.items():
            if c.dtype.kind == "f":
                require(bool(np.isfinite(c).all()),
                        f"{qname}: non-finite {name}")
        print(f"  {qname:26s} quote={subs[qname].quoted_cost:.0f} "
              f"{','.join(m.value for m in res.methods()) or '-':29s} "
              f"net={res.network_bytes:.0f} rows={res.rows} "
              f"wall={res.wall_time_s * 1e3:.2f}ms; solo "
              f"{','.join(m.value for m in solo.methods())} "
              f"net={solo.network_bytes:.0f} "
              f"wall={solo.wall_time_s * 1e3:.2f}ms; rows equal")
    for qname in (pair[1] for pair in SHARED_PAIRS):
        res = report.results[qname]
        require(not res.decisions and res.network_bytes == 0,
                f"{qname}: {len(res.decisions)} joins, "
                f"{res.network_bytes:.0f} bytes")
    batch_joins = (sum(len(s.result.decisions) for s in report.shared)
                   + sum(len(r.decisions) for r in report.results.values()))
    require(batch_joins < serial_joins,
            f"batched joins {batch_joins} not below serial {serial_joins}")
    require(report.total_network_bytes < serial_bytes,
            f"batched bytes {report.total_network_bytes:.0f} not below "
            f"serial {serial_bytes:.0f}")
    print(f"  batched {batch_joins} joins, {report.total_network_bytes:.0f} "
          f"bytes; serial {serial_joins} joins, {serial_bytes:.0f} bytes; "
          f"wall: batch {report.wall_time_s * 1e3:.2f} ms (gates and "
          f"execution), sum of solo walls {solo_wall * 1e3:.2f} ms "
          f"(execution), sum of execute_solo calls {solo_call * 1e3:.2f} ms "
          f"(optimize, gates and execution); stats {service.stats()}")

    hits = service.filter_cache.hits
    warm = [service.submit(plan, name=q) for q, plan in queries.items()]
    require(all(s.plan_cached for s in warm),
            "a resubmission missed the plan cache")
    again = service.run()
    require(service.filter_cache.hits > hits,
            "the warm batch took no filter from the cache")
    for qname in queries:
        require(rows_close(rows_as_set(again[0].results[qname].table
                                       .to_numpy()),
                           rows_as_set(report.results[qname].table
                                       .to_numpy())),
                f"{qname}: warm batch rows differ")
    print(f"  warm resubmission: {len(warm)} of {len(warm)} plan-cache "
          f"hits, filter-cache hits {hits} -> {service.filter_cache.hits}, "
          f"wall {again[0].wall_time_s * 1e3:.2f} ms, rows unchanged")

    budget = sum(s.quoted_cost for s in subs.values()) / 2
    _, split = service_batch(catalog, cost_budget=budget, policy="cost")
    require(len(split) > 1, f"budget {budget:.0f} formed one batch")
    require(sorted(q for r in split for q in r.results) == sorted(queries),
            "the budgeted run did not run every query once")
    for r in split:
        for qname, res in r.results.items():
            require(rows_close(rows_as_set(res.table.to_numpy()),
                               rows_as_set(report.results[qname].table
                                           .to_numpy())),
                    f"{qname}: budgeted rows differ")
    print(f"  budget {budget:.0f} (policy cost): {len(split)} batches "
          + " | ".join(",".join(r.results) + f" {r.wall_time_s * 1e3:.2f}ms"
                       for r in split) + "; rows unchanged")

    profile_pass(lambda: service_batch(catalog)[1])
    torch.cuda.synchronize()
    t_nl = time.perf_counter()
    run_nested_loop_joins(catalog)
    print(f"  nested-loop joins: {time.perf_counter() - t_nl:.1f} s, row "
          "checks included")


def same_probe_rows(a, b) -> bool:
    """Row-for-row equality of two joins' outputs on the same probe table:
    every method that keeps the probe side's layout (the broadcast hash
    join, both nested-loop joins) leaves each output row where its probe
    row was, so the validity masks and the valid entries of every column
    must be equal, on the card."""
    import torch
    if list(a.columns) != list(b.columns) or not torch.equal(a.valid,
                                                             b.valid):
        return False
    return all(torch.equal(torch.where(a.valid, a.columns[n], 0),
                           torch.where(b.valid, b.columns[n], 0))
               for n in a.columns)


def run_nested_loop_joins(catalog) -> None:
    """store_sales against store and date_dim under BROADCAST_NL and
    CARTESIAN through ``run_equi_join``: rows equal BROADCAST_HASH's for
    inner, left_semi and left_anti; wall time and chunk count of each. The
    dimension's odd keys are masked invalid, so that the semi and the anti
    join both keep rows and the nested loop meets invalid build rows."""
    import torch

    from repro_torch.core.cost_model import JoinMethod
    from repro_torch.joins.exchange import broadcast
    from repro_torch.joins.local_join import nl_chunk_rows
    from repro_torch.joins.methods import run_equi_join

    fact = catalog.table("store_sales")
    for dim, a_key, b_key in (("store", "ss_store_sk", "s_store_sk"),
                              ("date_dim", "ss_sold_date_sk", "d_date_sk")):
        b = catalog.table(dim)
        b = b.with_valid(b.valid & (b.column(b_key) % 2 == 0))
        nb = broadcast(b)[0].valid.shape[0]
        chunks = -(-fact.valid.numel() // nl_chunk_rows(nb))
        for jt in ("inner", "left_semi", "left_anti"):
            runs = {}
            for method in (JoinMethod.BROADCAST_HASH, JoinMethod.BROADCAST_NL,
                           JoinMethod.CARTESIAN):
                run_equi_join(method, fact, b, a_key, b_key, jt,
                              use_kernel=True)  # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, rep = run_equi_join(method, fact, b, a_key, b_key, jt,
                                         use_kernel=True)
                torch.cuda.synchronize()
                runs[method] = (out, rep, time.perf_counter() - t0)
            base = runs[JoinMethod.BROADCAST_HASH][0]
            cells = []
            for method, (out, rep, wall) in runs.items():
                if method is not JoinMethod.BROADCAST_HASH:
                    require(same_probe_rows(out, base),
                            f"{dim} {jt} {method.value}: rows differ from "
                            "broadcast_hash")
                net = sum(e.network_bytes for e in rep.exchanges)
                cells.append(f"{method.value} {wall * 1e3:.2f}ms "
                             f"net={net:.0f} local={rep.local_bytes:.0f}")
            print(f"  store_sales x {dim} ({fact.valid.numel()} x {nb} rows, "
                  f"{chunks} chunks) {jt:9s} rows={rep.output_rows}: "
                  + " | ".join(cells) + "; NL rows equal broadcast_hash, "
                  "row for row")


# ---------------------------------------------------------------------------
# Phase 5b: reordering and the hypercube
# ---------------------------------------------------------------------------

#: The queries whose ``Reorder(RelJoin)`` run takes the hypercube multi-way
#: join at this catalog's scale, as the reference planner selects it there.
CUBE_QUERIES = ("q35_triangle", "q36_triangle_shared_axis",
                "q37_four_clique")


def run_reorder_path(catalog):
    import numpy as np

    from repro_torch.core.cost_model import JoinMethod
    from repro_torch.joins.ref import rows_as_set, rows_close
    from repro_torch.kernels import ops
    from repro_torch.sql import (Executor, ReorderingStrategy,
                                 cyclic_queries, default_strategies,
                                 misordered_queries)

    queries = {**misordered_queries(), **cyclic_queries()}
    cyclic, strategies = cyclic_queries(), default_strategies()
    require(sorted(cyclic) == sorted(CUBE_QUERIES), "q35-q37 suite")

    def runs():
        """(query, strategy, arm) of the reported pass: every query under
        ``Reorder(s)``, and the cyclic ones also with ``hypercube=False``."""
        for qname in queries:
            for s in strategies:
                yield qname, s, "reorder"
                if qname in cyclic:
                    yield qname, s, "binary"

    def run_pass():
        for qname, s, arm in runs():
            ex = Executor(catalog, ReorderingStrategy(s),
                          hypercube=arm == "reorder")
            yield qname, s, arm, ex.execute(queries[qname])

    t_warm = time.perf_counter()
    for _ in run_pass():  # first calls of every torch op, not reported
        pass
    base = {}
    for qname, plan in queries.items():
        for s in strategies:
            res = Executor(catalog, s).execute(plan)
            base[(qname, s.name)] = rows_as_set(res.table.to_numpy())
    print(f"  warm-up pass and the unreordered runs: "
          f"{time.perf_counter() - t_warm:.1f} s")

    spy = LargestInputs()
    results = {}
    ops.reset_launch_counts()
    t_phase = time.perf_counter()
    with spy.installed():
        before = ops.launch_counts()
        for qname, s, arm, res in run_pass():
            after = ops.launch_counts()
            delta = ",".join(str(after[k] - before[k]) for k in after)
            before = after
            cols = res.table.to_numpy()
            results[(qname, s.name, arm)] = res
            print(f"  {qname:24s} Reorder({s.name:12s}) {arm:7s} "
                  f"{','.join(m.value for m in res.methods()):52s} "
                  f"net={res.network_bytes:.0f} rows={res.rows} "
                  f"wall={res.wall_time_s:.4f}s launches={delta}")
            require(rows_close(rows_as_set(cols), base[(qname, s.name)]),
                    f"{qname} Reorder({s.name}) {arm}: rows differ from the "
                    "unreordered run")
            for name, c in cols.items():
                if c.dtype.kind == "f":
                    require(bool(np.isfinite(c).all()),
                            f"{qname} {s.name} {arm}: non-finite {name}")
            if arm == "binary":
                require(JoinMethod.HYPERCUBE_SHUFFLE not in res.methods(),
                        f"{qname} {s.name}: hypercube=False took the cube")
    launches = ops.launch_counts()
    print(f"  reorder path: {time.perf_counter() - t_phase:.1f} s for "
          f"{len(results)} runs; launches {launches}")
    for qname in CUBE_QUERIES:
        res = results[(qname, "RelJoin(w=1)", "reorder")]
        require(res.methods() == [JoinMethod.HYPERCUBE_SHUFFLE],
                f"{qname} Reorder(RelJoin): methods {res.methods()}, not the "
                "hypercube")
    require(launches["tiled_probe3"] >= 2,
            f"tiled_probe3 launched {launches['tiled_probe3']} times on the "
            "reorder path (q35 and q36 take the fused branch)")

    print("  cube against binary arm, Reorder(s): network bytes, wall ms")
    for qname in CUBE_QUERIES:
        cells = []
        for s in strategies:
            c = results[(qname, s.name, "reorder")]
            b = results[(qname, s.name, "binary")]
            cells.append(f"{s.name} {c.network_bytes:.0f} vs "
                         f"{b.network_bytes:.0f}, {c.wall_time_s * 1e3:.2f} "
                         f"vs {b.wall_time_s * 1e3:.2f}")
        print(f"    {qname:24s} " + " | ".join(cells))
    for s in strategies:
        suite = [results[(q, s.name, "reorder")] for q in queries]
        print(f"    suite Reorder({s.name:12s}) network "
              f"{sum(r.network_bytes for r in suite):.0f}, wall "
              f"{sum(r.wall_time_s for r in suite) * 1e3:.2f} ms")

    profile_pass(run_pass)
    return launches, spy.calls


def measure_probe3(calls: dict, launches: dict) -> list:
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.tiled_probe import tiled_probe3

    _, (a1, a2, b, c), _ = calls["tiled_probe3"]
    bsz, na = a1.shape
    nb, nc = b.shape[1], c.shape[1]
    got = tiled_probe3(a1, a2, b, c)
    want = ref.tiled_probe3_ref(a1, a2, b, c)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    b_ms, b_by = bound(*probe_least_work([a1, a2], [b, c]))
    compares = dense_compares(want[0], nb) + dense_compares(want[1], nc)
    hits = float((want[0] >= 0).float().mean()), float(
        (want[1] >= 0).float().mean())
    valid = float((a1 != -1).float().mean())
    row = dict(
        name="tiled_probe3", route="cuda",
        source="src/repro_torch/csrc/tiled_probe3.cu",
        replaces="src/repro/kernels/tiled_probe.py:146",
        launches=launches["tiled_probe3"], max_abs_err=err,
        **time_kernel(lambda: tiled_probe3(a1, a2, b, c), 10, cold=True),
        plain_ms=cuda_ms(lambda: ref.tiled_probe3_ref(a1, a2, b, c), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"B={bsz} na={na} nb={nb} nc={nc}")
    # The same builds probed by a 64th of each row's slots: mostly the
    # tables' build at the head of every block.
    head = [k[:, :max(1, na // 64)].contiguous() for k in (a1, a2)]
    build_ms = device_ms(lambda: tiled_probe3(*head, b, c), 10)
    print(f"  tiled_probe3 input: {valid:.3f} of the probe slots hold a "
          f"row; hit rates {hits[0]:.3f} and {hits[1]:.3f}; "
          f"a dense scan would make {compares:.4g} compares; "
          f"{copy_yardstick(a1.numel() + a2.numel())}; the same builds "
          f"probed by a 64th of the slots take {build_ms:.4f} ms")
    report_kernels([row])
    return [row]


# ---------------------------------------------------------------------------
# Phase 5f: the distributed twins
# ---------------------------------------------------------------------------

#: The kernels every rank of the twins must launch (K3 only where a sort
#: join's receive width is a power of two up to 4096).
TWIN_KERNELS = ("tiled_probe", "bloom_build", "key_range")
#: Timed runs of each twin and of its global-view method.
TWIN_REPS = 3
#: The binary twins: (name, twin, global-view method, probe table, build
#: table, probe key, build key).
BINARY_TWINS = (
    ("shuffle_hash store_sales x customer", "dist_shuffle_hash_join",
     "shuffle_hash_join", "store_sales", "customer", "ss_customer_sk",
     "c_customer_sk"),
    ("shuffle_sort store_sales x customer", "dist_shuffle_sort_join",
     "shuffle_sort_join", "store_sales", "customer", "ss_customer_sk",
     "c_customer_sk"),
    ("broadcast_hash store_sales x date_dim", "dist_broadcast_hash_join",
     "broadcast_hash_join", "store_sales", "date_dim", "ss_sold_date_sk",
     "d_date_sk"),
    ("broadcast_hash store_sales x store", "dist_broadcast_hash_join",
     "broadcast_hash_join", "store_sales", "store", "ss_store_sk",
     "s_store_sk"))
CUBE_TWIN = "hypercube q35"


def stack1(table):
    """A stacked table as one partition, (1, p * cap)."""
    from repro_torch.joins import Table
    return Table({n: c.reshape(1, -1) for n, c in table.columns.items()},
                 table.valid.reshape(1, -1))


def q35_cube_inputs(catalog):
    """q35's three cube inputs and spec as ``Reorder(RelJoin)`` plans them
    at the catalog's p, and the least capacity factor (2, 4, 8, ...) at
    which the global view's exchange overflows nowhere, as the executor's
    retry loop finds it."""
    from repro_torch.joins import hypercube_multiway_join
    from repro_torch.sql import (Executor, RelJoinStrategy,
                                 ReorderingStrategy, cyclic_queries)

    seen = []

    class Capture(Executor):
        def _run_hypercube_with_retry(self, tables, spec):
            seen.append((tables, spec))
            return super()._run_hypercube_with_retry(tables, spec)

    Capture(catalog, ReorderingStrategy(RelJoinStrategy())).execute(
        cyclic_queries()["q35_triangle"])
    require(len(seen) == 1, f"q35 ran {len(seen)} cubes")
    tables, spec = seen[0]
    factor = 2.0
    while True:
        _, rep = hypercube_multiway_join(list(tables), spec,
                                         capacity_factor=factor,
                                         use_kernel=True)
        if all(e.overflow_rows == 0 for e in rep.exchanges):
            return tables, spec, factor
        factor *= 2
        require(factor <= 64, "q35's cube overflows at every factor")


def twin_filter_columns(catalog):
    """(name, (keys, valid) table, m_bits, k) of the filter builds: q19's
    filtered customer keys (c_income < 74000) and every store_sales
    customer key."""
    from repro_torch.core.cost_model import bloom_params
    from repro_torch.core.psts import distinct_count
    from repro_torch.joins import Table

    cust, ss = catalog.table("customer"), catalog.table("store_sales")
    out = []
    for name, t, key, valid in (
            ("customer c_income < 74000", cust, "c_customer_sk",
             cust.valid & (cust.column("c_income") < 74000)),
            ("store_sales ss_customer_sk", ss, "ss_customer_sk", ss.valid)):
        m, k = bloom_params(distinct_count(t.column(key), valid))
        out.append((name, Table({"k": t.column(key)}, valid), m, k))
    return out


def twin_inputs(catalog) -> dict:
    """What every rank of a run at world p receives: the stacked tables,
    q35's cube with its spec and factor, and the filter columns."""
    names = {t for case in BINARY_TWINS for t in case[3:5]}
    return {"tables": {n: catalog.table(n) for n in names},
            "cube": q35_cube_inputs(catalog),
            "filters": twin_filter_columns(catalog)}


def one_partition(inputs: dict) -> dict:
    """``twin_inputs`` for a run at world 1: every table as one partition,
    the cube's dims all 1."""
    import dataclasses

    cube, spec, factor = inputs["cube"]
    return {"tables": {n: stack1(t) for n, t in inputs["tables"].items()},
            "cube": (tuple(stack1(t) for t in cube),
                     dataclasses.replace(spec, dims=(1,) * len(spec.dims)),
                     factor),
            "filters": [(n, stack1(t), m, k)
                        for n, t, m, k in inputs["filters"]]}


def row_matrix(table, names):
    """The valid rows of ``table``'s columns ``names`` as an (n, C) int32
    matrix of their bit patterns (float32 and bool as int32)."""
    import torch
    v = table.valid.reshape(-1)
    cols = []
    for n in names:
        c = table.columns[n].reshape(-1)[v]
        cols.append(c.view(torch.int32) if c.dtype == torch.float32
                    else c.to(torch.int32))
    return torch.stack(cols, 1)


def sorted_rows(mat):
    """Rows of an int32 matrix in lexicographic order, on its device: a
    stable sort by each column, last column first."""
    import torch
    order = torch.arange(mat.shape[0], device=mat.device)
    for j in reversed(range(mat.shape[1])):
        order = order[torch.argsort(mat[order, j], stable=True)]
    return mat[order]


def global_twin_results(inputs: dict, reps: int) -> tuple:
    """The global-view method of every twin on the stacked tables of
    ``inputs`` (the kernel path), timed: name -> ("rows", column names,
    sorted row matrix) or ("payload", tensors), and name -> walls."""
    import torch

    from repro_torch.core.psts import key_set
    from repro_torch.joins import methods
    from repro_torch.kernels.bloom import bloom_build
    from repro_torch.kernels.zone_map import key_range

    tabs = inputs["tables"]
    cube, spec, factor = inputs["cube"]
    calls = {}
    for name, _, method, a, b, ak, bk in BINARY_TWINS:
        calls[name] = (lambda m=method, a=a, b=b, ak=ak, bk=bk:
                       getattr(methods, m)(tabs[a], tabs[b], ak, bk,
                                           use_kernel=True)[0])
    calls[CUBE_TWIN] = lambda: methods.hypercube_multiway_join(
        list(cube), spec, capacity_factor=factor, use_kernel=True)[0]
    for name, t, m, k in inputs["filters"]:
        calls[f"bloom {name}"] = (lambda t=t, m=m, k=k: (bloom_build(
            t.column("k"), t.valid, m_bits=m, k=k),))
        calls[f"zone_map {name}"] = (lambda t=t: (key_range(t.column("k"),
                                                            t.valid),))
        calls[f"key_set {name}"] = (lambda t=t: key_set(t.column("k"),
                                                        t.valid))
    expected, walls = {}, {}
    for name, fn in calls.items():
        out = fn()  # warm-up
        walls[name] = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
        if isinstance(out, tuple):
            expected[name] = ("payload", out)
        else:
            names = sorted(out.columns)
            expected[name] = ("rows", names,
                              sorted_rows(row_matrix(out, names)))
    return expected, walls


def rows_to_rank0(mat, world: int):
    """Every rank's (n_r, C) row matrix on rank 0, concatenated (other
    ranks get an empty matrix): one uneven ``all_to_all_single``, after an
    all-gather of the row counts. Outside the twins: it checks them."""
    import torch
    import torch.distributed as dist

    n = torch.tensor([mat.shape[0]], device=mat.device)
    counts = [torch.empty_like(n) for _ in range(world)]
    dist.all_gather(counts, n)
    width, first = mat.shape[1], dist.get_rank() == 0
    send = mat.reshape(-1).contiguous()
    into = [send.numel() if r == 0 else 0 for r in range(world)]
    outof = [int(c) * width if first else 0 for c in counts]
    recv = torch.empty(sum(outof), dtype=send.dtype, device=send.device)
    dist.all_to_all_single(recv, send, outof, into)
    return recv.reshape(-1, width)


def twin_cases(inputs: dict, mesh, cube_mesh) -> dict:
    """name -> (mesh, call) of every twin on this rank's partitions."""
    from repro_torch.joins import distributed as td

    t = {n: td.place(tab, mesh) for n, tab in inputs["tables"].items()}
    cube, spec, factor = inputs["cube"]
    ctabs = tuple(td.place_cube(tab, cube_mesh) for tab in cube)
    cases = {}
    for name, twin, _, a, b, ak, bk in BINARY_TWINS:
        cases[name] = (mesh, lambda f=getattr(td, twin), a=a, b=b, ak=ak,
                       bk=bk: f(t[a], t[b], ak, bk, mesh))
    cases[CUBE_TWIN] = (cube_mesh, lambda: td.dist_hypercube_join(
        ctabs, spec, cube_mesh, capacity_factor=factor))
    for name, tab, m, k in inputs["filters"]:
        local = td.place(tab, mesh)
        cases[f"bloom {name}"] = (mesh, lambda x=local, m=m, k=k:
                                  td.dist_bloom_build(x, "k", mesh,
                                                      m_bits=m, k=k))
        cases[f"zone_map {name}"] = (mesh, lambda x=local:
                                     td.dist_zone_map_build(x, "k", mesh))
        cases[f"key_set {name}"] = (mesh, lambda x=local:
                                    td.dist_key_set_build(x, "k", mesh))
    return cases


def run_twins_on_rank(world: int, dev, inputs: dict, expected: dict,
                      reps: int) -> dict:
    """Every twin on this rank: a warm-up pass, then with the launch
    counts set to 0 the reported pass, ``reps`` runs of each twin, each
    from a barrier to a synchronize after its result; its result checked
    against the global view's (rows gathered and sorted on rank 0, payloads
    on every rank). Returns this rank's walls, bytes sent by collective,
    dropped rows and launch counts."""
    import torch
    import torch.distributed as dist

    from repro_torch.joins import distributed as td
    from repro_torch.kernels import build, ops

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        build.library()  # the parent's build, found in build/
    mesh = td.make_join_mesh(world, device=dev)
    cube_mesh = td.make_cube_mesh(inputs["cube"][1].dims, device=dev)
    cases = twin_cases(inputs, mesh, cube_mesh)
    for _, call in cases.values():  # first calls of every op, not reported
        call()
    sync()
    ops.reset_launch_counts()
    report = {}
    for name, (m, call) in cases.items():
        walls, before = [], ops.launch_counts()
        for _ in range(reps):
            m.stats.reset()
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            out = call()
            sync()
            walls.append(time.perf_counter() - t0)
        after = ops.launch_counts()
        cell = {"walls": walls, "sent": dict(m.stats.sent_bytes),
                "dropped": int(m.stats.dropped_rows),
                "launches": {k: (after[k] - before[k]) // reps
                             for k in after if after[k] > before[k]}}
        want = expected[name]
        if want[0] == "rows":
            _, names, rows = want
            require(sorted(out.columns) == names,
                    f"{name}: columns {sorted(out.columns)}, not {names}")
            got = rows_to_rank0(row_matrix(out, names), world)
            if dist.get_rank() == 0:
                require(torch.equal(sorted_rows(got), rows),
                        f"{name}: {got.shape[0]} rows differ from the "
                        f"global view's {rows.shape[0]}")
            cell["rows"] = int(got.shape[0])
        else:
            outs = out if isinstance(out, tuple) else (out,)
            require(all(torch.equal(g, w) for g, w in zip(outs, want[1],
                                                          strict=True)),
                    f"{name}: payload differs from the global build")
        report[name] = cell
    report["launches"] = ops.launch_counts()
    return report


def twins_rank(rank: int, world: int, backend: str, store: str,
               out_dir: str, device: str, inputs: dict, expected: dict,
               reps: int) -> None:
    """One rank process of ``run_twins``: joins the ``backend`` group
    through a ``FileStore``, runs every twin and writes its report."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    dev = torch.device(device)
    extra = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300), **extra)
    try:
        report = run_twins_on_rank(world, dev, inputs, expected, reps)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()
        # A spawned process ends without collecting its objects: release
        # the parent's shared tensors now, so that it may free them.
        inputs.clear()
        expected.clear()


def run_twins(inputs: dict, expected: dict, world: int, backend: str,
              device: str = "cuda:0", reps: int = TWIN_REPS) -> list:
    """``world`` rank processes (``torch.multiprocessing``, spawn) running
    every twin under ``backend``; a rank's exception fails the call.
    Returns every rank's report."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(twins_rank, nprocs=world, start_method="spawn",
                           args=(world, backend, str(Path(tmp) / "store"),
                                 tmp, device, inputs, expected, reps))
        return [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                for r in range(world)]


def check_twin_reports(reports: list, label: str) -> None:
    """Fail unless every rank launched K2, K4 and K6 and no twin dropped a
    row; print each twin's slowest-rank walls, bytes by collective per
    rank, rows and launches."""
    for r, rep in enumerate(reports):
        for name in TWIN_KERNELS:
            require(rep["launches"][name] > 0,
                    f"{label}: {name} never launched on rank {r}")
    for name in reports[0]:
        if name == "launches":
            continue
        cells = [rep[name] for rep in reports]
        dropped = sum(c["dropped"] for c in cells)
        require(dropped == 0, f"{label} {name}: {dropped} rows past a "
                "pair's capacity")
        walls = [max(c["walls"][i] for c in cells)
                 for i in range(len(cells[0]["walls"]))]
        sent = {k: [c["sent"][k] for c in cells] for k in cells[0]["sent"]}
        rows = f" rows={cells[0]['rows']}" if "rows" in cells[0] else ""
        print(f"  {label} {name}:{rows} wall (slowest rank) "
              + ", ".join(f"{w * 1e3:.2f}" for w in walls)
              + f" ms; launches/rank {cells[0]['launches']}; bytes sent "
              + "; ".join(f"{k} {v}" for k, v in sent.items() if any(v)))
    print(f"  {label} launches by rank: "
          + " | ".join(",".join(f"{k}={v}" for k, v in rep["launches"].items()
                                if v) for rep in reports)
          + f"; bitonic_sort_tile {[r['launches']['bitonic_sort_tile'] for r in reports]}"
          " (not required)")


def run_twins_path(catalog, smi: str) -> None:
    """Phase 5f. The global view of every twin on the catalog (the
    expected rows and payloads, and its walls), then the twins at world p
    (gloo: NCCL refuses two ranks on one card) and at world 1 (NCCL) on the
    same card."""
    t0 = time.perf_counter()
    inputs = {catalog.p: twin_inputs(catalog)}
    inputs[1] = one_partition(inputs[catalog.p])
    cube, spec, factor = inputs[catalog.p]["cube"]
    print(f"  q35 cube: dims {spec.dims}, axis keys {spec.axis_keys}, "
          f"factor {factor} (the global view's first without overflow); "
          f"inputs {[t.count() for t in cube]} rows")
    for name, t, m, k in inputs[catalog.p]["filters"]:
        print(f"  filter column {name}: {t.valid.numel()} keys, "
              f"{t.count()} valid, m_bits {m}, k {k}")
    expected, walls = global_twin_results(inputs[catalog.p], TWIN_REPS)
    print(f"  global view ({smi}; set-up {time.perf_counter() - t0:.1f} s):")
    for name, w in walls.items():
        rows = (f" rows={expected[name][2].shape[0]}"
                if expected[name][0] == "rows" else "")
        print(f"    {name}:{rows} wall "
              + ", ".join(f"{x * 1e3:.2f}" for x in w) + " ms")
    for world, backend in ((catalog.p, "gloo"), (1, "nccl")):
        t1 = time.perf_counter()
        reports = run_twins(inputs[world], expected, world, backend)
        print(f"  world {world} under {backend}, every rank on the one card "
              f"({smi}): {time.perf_counter() - t1:.1f} s, spawn and "
              "warm-up included; rows equal the global view, payloads "
              "bit-identical")
        check_twin_reports(reports, f"world {world}")


# ---------------------------------------------------------------------------
# Phase 6: cross-checks
# ---------------------------------------------------------------------------

def check_golden(catalog) -> None:
    from repro_torch.sql import (Executor, RelJoinStrategy,
                                 ReorderingStrategy, cyclic_queries,
                                 default_strategies, every_query,
                                 filtered_queries, misordered_queries,
                                 optimize, signature)

    gold = json.loads(GOLDEN.read_text())["queries"]
    queries = {**every_query(), **text_suite(), **filtered_queries(),
               **cyclic_queries()}
    require(sorted(queries) == sorted(gold),
            f"queries {sorted(set(gold) - set(queries))} of the golden "
            "fixture missing")
    reordered = {**misordered_queries(), **cyclic_queries()}
    n = n_dp = 0
    for qname, plan in queries.items():
        strategies = [(s.name, s) for s in default_strategies()]
        if qname in reordered:
            strategies.append(("Reorder(RelJoin(w=1))",
                               ReorderingStrategy(RelJoinStrategy())))
        for name, s in strategies:
            res = Executor(catalog, s).execute(plan)
            got = [{"method": d.selection.method.value,
                    "swapped": bool(d.selection.swapped_sides)}
                   for d in res.decisions]
            require(got == gold[qname]["strategies"][name],
                    f"{qname} {name}: decisions {got} differ from the "
                    "golden fixture")
            n += 1
        opt = optimize(plan, catalog)
        dp = {"reordered": opt.reordered, "signature": signature(opt.plan)}
        require(dp == gold[qname]["dp"],
                f"{qname}: optimize gives {dp}, not the golden dp entry")
        n_dp += 1
    require(n == sum(len(e["strategies"]) for e in gold.values()),
            f"{n} golden decisions checked")
    print(f"  golden decisions at generate(0.1, 4, 42), q1-q37 under the "
          f"four default strategies, Reorder(RelJoin) on q13-q15 and "
          f"q35-q37: {n} of {n} equal; dp entries {n_dp} of {n_dp} equal")


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
    for qname, plan in {**all_queries(), **text_suite()}.items():
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
    print(f"  scale 3, q1-q12, q16-q18 and q24-q34: use_kernel=False rows "
          f"equal use_kernel=True in {n} of {n} runs")


# ---------------------------------------------------------------------------
# Phase 7: LM serving
# ---------------------------------------------------------------------------

#: The H100 SXM's dense bf16 tensor-core peak (NVIDIA data sheet), the rate
#: every prefill bound is counted at.
PEAK_BF16_FLOPS_PER_S = 989e12
LM_MESH = (("data", 1), ("model", 1))
LM_SMOKE_ARCHS = ("musicgen_large", "granite_8b", "tinyllama_1_1b",
                  "starcoder2_3b", "glm4_9b", "paligemma_3b")
#: Teacher-forced decode against forward: the reference's tolerance
#: (tests/test_models.py).
DECODE_RTOL, DECODE_ATOL = 0.2, 0.25
#: The card against the port's CPU run on the same params, as the CPU
#: tests hold the port to the JAX package: bf16 rounded at other points and
#: products summed in other orders, a few bf16 steps (2^-8) over a model.
CARD_RTOL, CARD_ATOL, CARD_MEAN_ATOL = 2 ** -5, 2 ** -4, 2 ** -6
#: How far below forward's largest logit an emitted token's may lie: the
#: reference's decode-vs-forward atol. Where forward's top-2 margin is
#: larger, the token must be forward's argmax.
TOKEN_GAP = 0.25


def lm_close(port, ref, what: str, rtol: float, atol: float,
             mean_atol: float | None = None) -> float:
    """Require ``port`` within ``atol + rtol * |ref|`` of ``ref`` (and, if
    given, a mean absolute difference of at most ``mean_atol``); return the
    largest absolute difference."""
    a, b = port.float().cpu(), ref.float().cpu()
    require(a.shape == b.shape, f"{what}: shapes {a.shape} and {b.shape}")
    err = (a - b).abs()
    require(bool((err <= atol + rtol * b.abs()).all()),
            f"{what}: largest difference {float(err.max()):.4f} outside "
            f"rtol {rtol}, atol {atol}")
    if mean_atol is not None:
        require(float(err.mean()) <= mean_atol,
                f"{what}: mean difference {float(err.mean()):.5f} above "
                f"{mean_atol}")
    return float(err.max())


def synchronize(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def all_position_logits(params, cfg, plan, tokens):
    """forward's logits (B, S, vocab) at every position."""
    from repro_torch.layers import embedding as emb
    from repro_torch.models import lm
    hidden, _ = lm.forward(params, cfg, plan, None, tokens)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return emb.lm_head_logits(head, hidden, mesh=None, batch_axes=(),
                              model_axis="model", strategy="replicate")


def teacher_forced_decode(params, cfg, plan, tokens):
    """decode_step's logits (B, S, vocab), fed ``tokens`` one position at
    a time from an empty cache of S positions."""
    import torch
    from repro_torch.models import lm
    B, S = tokens.shape
    cache = lm.init_cache(cfg, B, S, device=tokens.device)
    outs = []
    for t in range(S):
        logits, cache = lm.decode_step(params, cfg, plan, None,
                                       tokens[:, t:t + 1], cache)
        outs.append(logits)
    return torch.stack(outs, dim=1)


def check_lm_smoke(dev, archs=LM_SMOKE_ARCHS) -> None:
    """Phases 7a and 8a. Each smoke config on the card against the port's
    CPU run on the same params, on the CPU run's router choices
    (``routing_tap``; nothing to record without experts): forward finite;
    hidden states, prefill logits and every decode step's logits; for the
    MoE configs the loads equal and summing to tokens x top_k in every
    layer, and the dropped share equal; teacher-forced decode against
    forward on the card (an MoE forward at the dropless capacity, decode
    on its routing)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.relshard import plan_model
    from repro_torch.models import lm
    from repro_torch.models.config import SHAPE_BY_NAME
    cpu = torch.device("cpu")
    B, S, S_DEC = 2, 64, 16
    for i, arch in enumerate(archs):
        cfg = get_smoke_config(arch)
        plan = plan_model(cfg, LM_MESH, SHAPE_BY_NAME["train_4k"],
                          fsdp=False)
        host = lm.init_params(cfg, seed=i, device=cpu)
        params = lm.params_from_numpy(lm.params_to_numpy(host), dev)
        rng = np.random.default_rng(i)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
        cond = None
        if cfg.n_cond_tokens:
            cond = torch.from_numpy(0.01 * rng.standard_normal(
                (B, cfg.n_cond_tokens, cfg.d_model))).to(torch.bfloat16)
        on = (lambda x: None if x is None else x.to(dev))  # noqa: E731
        routed = {"calls": 0, "differed": 0}

        def cpu_then_card(fn, cpu_args, card_args):
            rec = []
            with routing_tap(record=rec):
                ref = fn(host, *cpu_args)
            with routing_tap(force=rec) as st:
                out = fn(params, *card_args)
            routed["calls"] += st["calls"]
            routed["differed"] += st["differed"]
            return out, ref

        def fwd(p, tk, cd):
            return lm.forward(p, cfg, plan, None, tk, cd)

        def pre(p, tk, cd):
            return lm.prefill(p, cfg, plan, None, tk, cd)

        (hidden, aux), (h_cpu, aux_cpu) = cpu_then_card(
            fwd, (tokens, cond), (on(tokens), on(cond)))
        require(bool(torch.isfinite(hidden.float()).all()),
                f"{arch}: forward is not finite on the card")
        h_err = lm_close(hidden, h_cpu, f"{arch} hidden, card vs CPU",
                         CARD_RTOL, CARD_ATOL, CARD_MEAN_ATOL)
        moe_note = ""
        if cfg.is_moe:
            require(torch.equal(aux.moe_load.cpu(), aux_cpu.moe_load),
                    f"{arch}: moe_load, card vs CPU")
            require(bool((aux.moe_load.sum(dim=1) == B * S * cfg.top_k
                          ).all()), f"{arch}: moe_load sums")
            require(float(aux.moe_dropped) == float(aux_cpu.moe_dropped),
                    f"{arch}: moe_dropped, card vs CPU")
            moe_note = (f"; moe_load equal, {B * S * cfg.top_k} a layer, "
                        f"moe_dropped {float(aux.moe_dropped):.4f} equal")
        p_err = lm_close(*cpu_then_card(pre, (tokens, cond),
                                        (on(tokens), on(cond))),
                         f"{arch} prefill logits, card vs CPU", CARD_RTOL,
                         CARD_ATOL, CARD_MEAN_ATOL)
        c0 = dataclasses.replace(cfg, n_cond_tokens=0)

        def decode(p, tk):
            return teacher_forced_decode(p, c0, plan, tk)

        dec, d_cpu = cpu_then_card(decode, (tokens[:, :S_DEC],),
                                   (on(tokens[:, :S_DEC]),))
        d_err = lm_close(dec, d_cpu, f"{arch} decode logits, card vs CPU",
                         CARD_RTOL, CARD_ATOL, CARD_MEAN_ATOL)
        rec = []
        with (dropless_moe() if cfg.is_moe else contextlib.nullcontext()), \
                routing_tap(record=rec):
            full = all_position_logits(params, c0, plan,
                                       on(tokens[:, :S_DEC]))
        with routing_tap(force=decode_order(rec, B, S_DEC)) as st:
            f_err = lm_close(decode(params, on(tokens[:, :S_DEC])), full,
                             f"{arch} decode vs forward on the card",
                             DECODE_RTOL, DECODE_ATOL)
        if cfg.is_moe:
            moe_note += (f"; routing: the card's own pick differed from the "
                         f"CPU's for {routed['differed']} token-layers of "
                         f"{routed['calls']} router calls, decode's from "
                         f"forward's for {st['differed']}, each within "
                         f"{ROUTE_GAP}")
        print(f"  smoke {arch}: forward finite; largest difference card vs "
              f"CPU: hidden {h_err:.4f}, prefill logits {p_err:.4f}, decode "
              f"logits {d_err:.4f}; decode vs forward {f_err:.4f}"
              f"{moe_note}")


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


#: Steps under the profiler in ``step_readings``: its post-processing takes
#: about a millisecond of host time a device activity.
PROFILED_STEPS = 2


def step_readings(fn, reps: int) -> dict:
    """A step of many launches: ``ms`` by CUDA events around ``reps`` back
    to back (the host's pace where it is slower than the card), then, over
    ``PROFILED_STEPS`` more under ``torch.profiler``, the device's busy time
    a step (the union of its activities), its idle share of that pass's
    wall, its activities a step and its device time by op. (``device_ms``
    cannot time such a step: the launch queue fills behind its sleep
    kernel.)"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = dict(ms=cuda_ms(fn, reps))
    reps = PROFILED_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    require(bool(spans), "the profiler recorded no device time")
    busy = union_us(spans)
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:5]
    out.update(busy_ms=busy / reps / 1e3, idle=1 - busy / wall_us,
               activities=len(spans) / reps,
               top=", ".join(f"{e.key} "
                             f"{e.self_device_time_total / reps / 1e3:.3f}"
                             for e in ops))
    return out


def lm_weight_bytes(cfg, weights, batch: int) -> int:
    """Bytes of the weights one decode step reads: every block, the final
    norm and the head, one embedding row a sequence, and the hybrid's
    shared block once for each of its applications (it does not stay in
    L2). Every expert counts: the replicated MoE path runs all of them."""
    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    total = 0
    for name, tree in weights.items():
        if name == "embed":
            total += batch * sum(t.shape[-1] * t.element_size()
                                 for t in tree_leaves(tree))
        elif name == "shared_attn":
            total += nbytes(tree) * (cfg.n_layers // cfg.attn_every)
        else:
            total += nbytes(tree)
    return total


#: Leaves read by a product (or the conv's taps): two operations per
#: element per token.
MATMUL_LEAVES = frozenset({
    "w_q", "w_k", "w_v", "w_o", "w_gate", "w_up", "w_down", "router",
    "w_in", "w_out", "conv_w", "w_r", "w_g", "decay_a", "decay_b", "w_kc",
    "w_vc"})


def weight_flops(tree, expert_share: float = 1.0) -> float:
    """2 operations per product weight, per token; the MoE experts (the
    leaves stacked (L, E, ...)) scaled by the share of them a token uses."""
    out = 0.0
    for name, v in tree.items():
        if isinstance(v, dict):
            out += weight_flops(v, expert_share)
        elif name in MATMUL_LEAVES:
            out += 2.0 * v.numel() * (expert_share if v.dim() == 4 else 1.0)
    return out


def prefill_flops(cfg, weights, batch: int, seq: int) -> float:
    """Operations a prefill of (batch, seq) needs at the least: every
    token through the blocks' product weights (an MoE token through its
    top_k experts only), the attention scores and their products over the
    causal half, the SSD and WKV chunks' products, and the head at the
    last position."""
    from repro_torch.models import lm
    from repro_torch.models.config import Family
    tokens = batch * seq
    per_token = weight_flops(weights["blocks"],
                             cfg.top_k / max(cfg.n_experts, 1))
    attn_layers = cfg.n_layers
    if cfg.family is Family.HYBRID:
        n_seg = cfg.n_layers // cfg.attn_every
        per_token += n_seg * weight_flops(weights["shared_attn"])
        attn_layers = n_seg
        c = min(seq, 128)
        heads = lm.ssm_heads(cfg)
        hd = 2 * cfg.d_model // heads
        # C.B scores, the intra products and the state update, per token
        per_token += cfg.n_layers * (2 * c * cfg.ssm_state + heads * (
            2 * c * hd + 4 * hd * cfg.ssm_state))
    if cfg.family is Family.SSM:
        attn_layers = 0
        c, hd = min(seq, 64), cfg.rwkv_head_dim
        heads = cfg.d_model // hd
        per_token += cfg.n_layers * heads * (4 * c * hd + 4 * hd * hd)
    attention = 2 * 2 * attn_layers * cfg.n_heads * cfg.hd * (seq + 1) / 2
    head = 2.0 * cfg.vocab * cfg.d_model * batch
    return per_token * tokens + attention * tokens + head


#: How far below the recorded pick a router's own pick may lie, in the
#: recorded probabilities, at every rank: the card-vs-CPU relative
#: tolerance 2^-5 applied to probabilities, which lie below 1.
ROUTE_GAP = 2 ** -5


def pick_gap(own_ids, src_probs) -> float:
    """The largest, over tokens and ranks, of how far the source's
    probability of a pick lies from the source's own pick's at that rank."""
    own_ids, src_probs = own_ids.cpu(), src_probs.float().cpu()
    top = src_probs.sort(dim=-1, descending=True).values[:, :own_ids.shape[1]]
    return float((src_probs.gather(1, own_ids) - top).abs().max())


@contextlib.contextmanager
def routing_tap(record: list | None = None, force: list | None = None):
    """Patch the port's top-k router choice (``moe.top_k_lowest_first``)
    for a cross-check. Two numeric paths (the card and the CPU, forward and
    decode) round a router's inputs differently and, where two experts'
    probabilities nearly tie, pick different ones, which moves a token by
    O(1); so outputs are compared on one routing. With ``record``, each
    call's (ids, probs) is appended (device tensors, no sync); with
    ``force``, the calls get the recorded ids in order, after the call's
    own pick is required to lie within ``ROUTE_GAP`` of the recorded one.
    Yields a dict: calls, tokens whose own pick differed, largest gap."""
    from repro_torch.layers import moe
    orig = moe.top_k_lowest_first
    queue = list(force or [])
    stats = {"calls": 0, "differed": 0, "gap": 0.0}

    def top_k(probs, k):
        vals, own = orig(probs, k)
        stats["calls"] += 1
        if record is not None:
            record.append((own, probs.detach()))
        if force is None:
            return vals, own
        require(bool(queue), "more router calls than recorded ones")
        ids, src = queue.pop(0)
        gap = pick_gap(own, src.detach())
        require(gap <= ROUTE_GAP, f"a router pick {gap:.4f} off the "
                f"recorded one, beyond {ROUTE_GAP}")
        stats["differed"] += int((own.cpu() != ids.cpu()).any(dim=1).sum())
        stats["gap"] = max(stats["gap"], gap)
        ids = ids.to(probs.device)
        return probs.gather(-1, ids), ids
    moe.top_k_lowest_first = top_k
    try:
        yield stats
    finally:
        moe.top_k_lowest_first = orig
    require(not queue, f"{len(queue)} recorded router calls were not used")


@contextlib.contextmanager
def dropless_moe():
    """Every expert takes every assignment (``moe.moe_capacity`` patched to
    the assignment count) for an oracle run of ``forward``: over B*S
    tokens the reference's capacity drops assignments that the engine's
    steps over at most 8 tokens keep."""
    from repro_torch.layers import moe
    orig = moe.moe_capacity
    moe.moe_capacity = lambda n, n_experts, factor=1.5: n
    try:
        yield
    finally:
        moe.moe_capacity = orig


@contextlib.contextmanager
def moe_factor(cf: float):
    """The MoE layers' capacities at factor ``cf`` in place of the
    reference's 1.5 (``moe.moe_capacity`` patched for the block)."""
    from repro_torch.layers import moe
    orig = moe.moe_capacity
    moe.moe_capacity = lambda n, n_experts, factor=1.5: orig(n, n_experts,
                                                               cf)
    try:
        yield
    finally:
        moe.moe_capacity = orig


def decode_order(recorded: list, B: int, S: int) -> list:
    """A forward's per-layer routing of (B*S) rows, re-cut into the
    per-step, per-layer order of a teacher-forced decode of B rows."""
    out = []
    for t in range(S):
        for ids, probs in recorded:
            out.append((ids.reshape(B, S, -1)[:, t],
                        probs.reshape(B, S, -1)[:, t]))
    return out


def trace_engine_routing(eng, rids) -> dict:
    """Wrap this engine's ``_decode`` and ``_prefill_slot`` so that each
    request in ``rids`` gets, position by position, every MoE layer's
    (ids, probs) row of its token, from its admission steps and the
    batched steps alike (device tensors)."""
    per_req = {rid: [] for rid in rids}
    admitting = {"slot": None}
    decode, prefill_slot = eng._decode, eng._prefill_slot

    def traced_prefill(i, tokens):
        admitting["slot"] = i
        try:
            prefill_slot(i, tokens)
        finally:
            admitting["slot"] = None

    def traced_decode(tokens, cache, ctx=None):
        rec = []
        with routing_tap(record=rec):
            out = decode(tokens, cache, ctx)
        i = admitting["slot"]
        rows = {i: 0} if i is not None else {j: j for j in
                                             range(len(eng.slots))}
        for slot, row in rows.items():
            req = eng.slots[slot]
            if req is not None and req.rid in per_req:
                per_req[req.rid].append([(ids[row], probs[row])
                                         for ids, probs in rec])
        return out
    eng._decode, eng._prefill_slot = traced_decode, traced_prefill
    return per_req


@contextlib.contextmanager
def compute_dtype(dtype):
    """Run the port's layers in ``dtype`` instead of bf16 (every layer
    module's ``COMPUTE_DTYPE``; ``lm.cast_params`` then keeps the fp32
    leaves as they are): the f32 twin that phase 8 holds the recurrent
    families' decode against forward in, where bf16 rounding at the two
    forms' different points grows with depth (``ROADMAP.md`` §3)."""
    from repro_torch.layers import (attention, common, embedding, moe, rwkv,
                                    ssm)
    mods = (attention, common, embedding, moe, rwkv, ssm)
    saved = [m.COMPUTE_DTYPE for m in mods]
    for m in mods:
        m.COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        for m, d in zip(mods, saved):
            m.COMPUTE_DTYPE = d


def build_engine(cfg, dev, max_seq: int, batch: int):
    """Random fp32 params (seed 0), the plan and a ServeEngine of ``batch``
    slots holding its copy of the weights; returns (params, plan, eng)."""
    from repro_torch.core.relshard import plan_model
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serving.engine import ServeEngine
    params = lm.init_params(cfg, seed=0, device=dev)
    plan = plan_model(cfg, LM_MESH, ShapeConfig("serve", max_seq, batch,
                                                "decode"), fsdp=False)
    eng = ServeEngine(cfg, plan, None, params, max_batch=batch,
                      max_seq=max_seq, device=dev)
    synchronize(dev)
    return params, plan, eng


def drain_engine(eng, cfg, dev, prompts: list, new_tokens: int, picks):
    """Submit one request per prompt and step the engine until it drains,
    checking FIFO admission, occupancy, completion, the vocab and that no
    decode call dropped an MoE assignment. Returns (requests, steps, wall
    s, the picked requests' routing for an MoE config)."""
    from repro_torch.serving.engine import Request
    reqs = [Request(i, list(p), new_tokens) for i, p in enumerate(prompts)]
    rids = [r.rid for r in reqs]
    traced = trace_engine_routing(eng, picks) if cfg.is_moe else None
    for r in reqs:
        eng.submit(r)
    max_occ, steps = 0, 0
    t1 = time.perf_counter()
    while eng.queue or eng.occupancy():
        eng.step()
        steps += 1
        max_occ = max(max_occ, eng.occupancy())
        waiting = [r.rid for r in eng.queue]
        require(waiting == rids[len(rids) - len(waiting):],
                f"{cfg.name}: admission is not FIFO")
        require(steps < 10_000, f"{cfg.name}: the engine does not drain")
    synchronize(dev)
    drain_s = time.perf_counter() - t1
    if traced is not None:
        # back to the class's methods: the wrappers' closures hold the engine
        del eng._decode, eng._prefill_slot
    require(all(r.done and len(r.out) == new_tokens for r in reqs),
            f"{cfg.name}: a request did not complete")
    require(max_occ <= eng.max_batch,
            f"{cfg.name}: occupancy {max_occ} > {eng.max_batch}")
    require(all(0 <= t < cfg.vocab for r in reqs for t in r.out),
            f"{cfg.name}: a token outside the vocab")
    require(eng.dropped_decode_calls == 0,
            f"{cfg.name}: {eng.dropped_decode_calls} decode calls dropped "
            f"an MoE assignment")
    print(f"  {cfg.name}: {len(reqs)} requests of {len(prompts[0])} prompt "
          f"tokens and {new_tokens} new drained in {steps} steps, "
          f"{drain_s * 1e3:.1f} ms (admission's per-slot prefill included): "
          f"{len(reqs) * new_tokens / drain_s:.1f} tokens/s; occupancy at "
          f"most {max_occ}, admission FIFO, every token in the vocab"
          + ("; no decode call dropped an MoE assignment" if cfg.is_moe
             else ""))
    return reqs, steps, drain_s, traced


def against_forward(eng, cfg, plan, dev, reqs, picks, traced, tokens,
                    gate: bool = True) -> str:
    """The engine's picked requests against forward over their own tokens
    (every token within TOKEN_GAP of forward's largest logit, forward's
    argmax where its margin is wider), and teacher-forced decode of
    ``tokens`` against forward (the reference's tolerance); an MoE forward
    at the dropless capacity on the routing of the run it checks. With
    ``gate`` False the differences are measured and returned, not
    required."""
    import torch
    picked_gap, cleared, n_tokens = 0.0, True, 0
    for rid in picks:
        r = reqs[rid]
        seq = torch.tensor([r.prompt + r.out[:-1]], device=dev)
        force, dropless = None, contextlib.nullcontext()
        if cfg.is_moe:
            positions = traced[rid]
            require(len(positions) == seq.shape[1],
                    f"{cfg.name} request {rid}: {len(positions)} traced "
                    f"positions for {seq.shape[1]} tokens")
            force = [(torch.stack([p[layer][0] for p in positions]),
                      torch.stack([p[layer][1] for p in positions]))
                     for layer in range(cfg.n_layers)]
            dropless = dropless_moe()
        with dropless, routing_tap(force=force) as routed:
            logits = all_position_logits(eng.weights, cfg, plan, seq)[
                0, len(r.prompt) - 1:]
        out = torch.tensor(r.out, device=dev)
        gap = logits.max(dim=-1).values - logits.gather(1, out[:, None])[:, 0]
        top2 = logits.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > TOKEN_GAP
        picked_gap = max(picked_gap, float(gap.max()))
        cleared &= bool((logits.argmax(dim=-1) == out)[clear].all())
        n_tokens += len(r.out)
        if not gate:
            continue
        require(float(gap.max()) <= TOKEN_GAP,
                f"{cfg.name} request {rid}: a token {float(gap.max()):.3f} "
                f"below forward's largest logit")
        require(cleared,
                f"{cfg.name} request {rid}: a token is not forward's argmax")
        print(f"    request {rid} against forward over its own tokens: "
              f"{int(clear.sum())} of {len(r.out)} tokens forward's argmax "
              f"by a margin above {TOKEN_GAP}, the rest within it; largest "
              f"gap {float(gap.max()):.4f}"
              + (f"; on the engine's routing (forward's own pick differed "
                 f"for {routed['differed']} token-layers, within "
                 f"{routed['gap']:.4f})" if cfg.is_moe else ""))

    B, S = tokens.shape
    rec = []
    with (dropless_moe() if cfg.is_moe else contextlib.nullcontext()), \
            routing_tap(record=rec):
        full = all_position_logits(eng.weights, cfg, plan, tokens)
    with routing_tap(force=decode_order(rec, B, S)) as routed:
        dec = teacher_forced_decode(eng.weights, cfg, plan, tokens)
    if not gate:
        err = (dec.float() - full.float()).abs()
        outside = int((err > DECODE_ATOL + DECODE_RTOL * full.abs()).sum())
        return (f"the picked requests' tokens lie up to {picked_gap:.4f} "
                f"below forward's largest logit (argmax where clear: "
                f"{cleared}); teacher-forced decode vs forward, B = {B}, S = "
                f"{S}: largest difference {float(err.max()):.4f}, "
                f"{outside} of {err.numel()} logits outside rtol "
                f"{DECODE_RTOL}, atol {DECODE_ATOL}")
    err = lm_close(dec, full, f"{cfg.name} decode vs forward", DECODE_RTOL,
                   DECODE_ATOL)
    print(f"    teacher-forced decode vs forward, B = {B}, S = {S}: largest "
          f"difference {err:.4f} (rtol {DECODE_RTOL}, atol {DECODE_ATOL})"
          + (f"; on forward's routing (decode's own pick differed for "
             f"{routed['differed']} token-layers, within "
             f"{routed['gap']:.4f})" if cfg.is_moe else ""))
    return ""


def serve_full_width(cfg, dev, smi: str, max_seq: int, n_requests: int,
                     prompt_len: int, new_tokens: int,
                     time_fp32: bool = True) -> None:
    """Phases 7b/7c and 8b-8e. One model at its full width on the card: a
    ServeEngine of 8 slots drains ``n_requests`` requests (``drain_engine``'s
    checks); four requests chosen in advance are held against forward over
    their own tokens, and teacher-forced decode against forward at B = 2,
    S = 64 (``against_forward``); the decode step (from the engine's
    resident copy, and with ``time_fp32`` with the fp32 weights cast at
    every use), the drain and one prefill are timed beside their bounds.
    For an MoE config the router's loads and filled slots are reported.
    For the recurrent families (HYBRID, SSM) the bf16 run's differences
    from forward are measured and printed, and the engine is built and
    drained again in the f32 twin (``compute_dtype``), where they are
    required."""
    import numpy as np
    import torch

    from repro_torch.layers import moe
    from repro_torch.models import lm
    from repro_torch.models.config import Family
    cuda = dev.type == "cuda"
    batch = 8
    f32_oracle = cfg.family in (Family.HYBRID, Family.SSM)
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    params, plan, eng = build_engine(cfg, dev, max_seq, batch)
    n_params = sum(t.numel() for t in tree_leaves(params))
    build_peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"  {cfg.name} ({cfg.family.value}): {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}"
          + (f", {cfg.n_experts} experts top-{cfg.top_k}" if cfg.is_moe
             else "")
          + f"; {n_params / 1e9:.3f} B params; fp32 params and the "
          f"engine's copy built in {time.perf_counter() - t0:.1f} s, peak "
          f"{build_peak / 1e9:.1f} GB allocated")

    rng = np.random.default_rng(7)
    tok8 = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, 1))).to(dev)
    step_bytes = lm_weight_bytes(cfg, eng.weights, batch)
    fp32_bytes = lm_weight_bytes(cfg, params, batch)

    def decode_timer(weights):
        cache = lm.init_cache(cfg, batch, max_seq, device=dev)
        cache["pos"].fill_(max_seq // 2)
        return lambda: lm.decode_step(weights, cfg, plan, None, tok8, cache)

    fp32_step = step_readings(decode_timer(params), reps=5) \
        if time_fp32 else None
    del params
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    prompts = [rng.integers(0, cfg.vocab, prompt_len).tolist()
               for _ in range(n_requests)]
    picks = (0, n_requests // 3, 2 * n_requests // 3, n_requests - 1)
    reqs, steps, drain_s, traced = drain_engine(eng, cfg, dev, prompts,
                                                new_tokens, picks)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).to(dev)
    drift = against_forward(eng, cfg, plan, dev, reqs, picks, traced,
                            tokens, gate=not f32_oracle)

    moe_step = ""
    if cfg.is_moe:
        aux = []
        cache = lm.init_cache(cfg, batch, max_seq, device=dev)
        lm.decode_step(eng.weights, cfg, plan, None, tok8, cache,
                       moe_aux=aux)
        loads = torch.stack([a.load for a in aux])
        dropped = max(float(a.dropped) for a in aux)
        n = batch * cfg.top_k
        cap = moe.moe_capacity(n, cfg.n_experts)
        require(bool((loads.sum(dim=1) == n).all()),
                f"{cfg.name}: a decode step's load does not sum to {n}")
        require(dropped == 0.0, f"{cfg.name}: the decode step dropped "
                f"{dropped:.4f} of its assignments")
        moe_step = (f"; {n} assignments, 0 dropped, in {cfg.n_experts} x "
                    f"{cap} expert slots a layer: "
                    f"{n / (cfg.n_experts * cap):.4f} of them filled, the "
                    f"rest computed on zeros")

    bf16_step = step_readings(decode_timer(eng.weights), reps=10)
    pb, ps = 8, 512
    prompts8 = torch.from_numpy(rng.integers(0, cfg.vocab, (pb, ps))).to(dev)
    hidden, aux = lm.forward(eng.weights, cfg, plan, None, prompts8)
    require(bool(torch.isfinite(hidden.float()).all()),
            f"{cfg.name}: prefill hidden states not finite")
    prefill_moe = ""
    if cfg.is_moe:
        require(bool((aux.moe_load.sum(dim=1) == pb * ps * cfg.top_k).all()),
                f"{cfg.name}: the prefill's load does not sum to tokens x "
                f"top_k")
        cap = moe.moe_capacity(pb * ps * cfg.top_k, cfg.n_experts)
        prefill_moe = (f"; moe_dropped {float(aux.moe_dropped):.4f}, load a "
                       f"layer across experts min/median/max "
                       + ", ".join(f"{int(lo.min())}/{int(lo.median())}/"
                                   f"{int(lo.max())}"
                                   for lo in aux.moe_load.float())
                       + f" (capacity {cap})")
    del hidden, aux
    logits = lm.prefill(eng.weights, cfg, plan, None, prompts8)
    require(logits.shape == (pb, cfg.vocab)
            and bool(torch.isfinite(logits).all()),
            f"{cfg.name}: prefill logits not finite")
    pre = step_readings(lambda: lm.prefill(eng.weights, cfg, plan, None,
                                           prompts8), reps=3)
    flops = prefill_flops(cfg, eng.weights, pb, ps)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"  {cfg.name} readings ({smi}):")
    timed = [("resident copy", bf16_step, step_bytes)]
    if fp32_step is not None:
        timed.insert(0, ("fp32 weights cast at every use", fp32_step,
                         fp32_bytes + 2 * step_bytes))
    for label, r, nbytes in timed:
        b = nbytes / PEAK_BYTES_PER_S * 1e3
        print(f"    decode step, batch {batch}, {label}: {r['ms']:.3f} ms "
              f"by events back to back; under the profiler the device is "
              f"busy {r['busy_ms']:.3f} ms a step (idle share "
              f"{r['idle']:.3f}), {r['activities']:.0f} device activities "
              f"a step; bound {b:.3f} ms ({nbytes / 1e9:.2f} GB over "
              f"{PEAK_BYTES_PER_S:.3g} B/s); device ms a step by op: "
              f"{r['top']}" + (moe_step if r is bf16_step else ""))
    print(f"    drain: {n_requests * new_tokens / drain_s:.1f} tokens/s")
    print(f"    prefill B = {pb}, S = {ps}: {pre['ms']:.2f} ms by events; "
          f"device busy {pre['busy_ms']:.2f} ms (idle share "
          f"{pre['idle']:.3f}), {pre['activities']:.0f} activities; bound "
          f"{flops / PEAK_BF16_FLOPS_PER_S * 1e3:.2f} ms ({flops / 1e12:.2f} "
          f"TFLOP over {PEAK_BF16_FLOPS_PER_S:.3g} FLOP/s bf16); device ms "
          f"by op: {pre['top']}{prefill_moe}")
    copy = sum(t.numel() * t.element_size()
               for t in tree_leaves(eng.weights))
    print(f"    peak memory allocated while serving (after the fp32 params "
          f"were freed): {peak / 2 ** 30:.2f} GiB, of which the resident "
          f"copy of the weights {copy / 2 ** 30:.2f} GiB")
    if not f32_oracle:
        return

    print(f"    bf16 against forward, measured, not required (the reference's "
          f"own decode leaves its forward as its depth grows; ROADMAP.md "
          f"§3): {drift}")
    del eng, logits
    if cuda:
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    with compute_dtype(torch.float32):
        _, plan, eng = build_engine(cfg, dev, max_seq, batch)
        require(all(t.dtype == torch.float32
                    for t in tree_leaves(eng.weights)),
                f"{cfg.name}: the f32 twin's weights are not f32")
        print(f"  {cfg.name}, the f32 twin (every layer in f32, the same "
              f"seed-0 weights and prompts):")
        reqs, _, _, traced = drain_engine(eng, cfg, dev, prompts,
                                          new_tokens, picks)
        against_forward(eng, cfg, plan, dev, reqs, picks, traced, tokens)
    print(f"    f32 twin: {time.perf_counter() - t2:.1f} s")
    del eng
    if cuda:
        torch.cuda.empty_cache()


def run_lm_path(dev, smi: str) -> None:
    """Phase 7: the smoke configs, then tinyllama-1.1b and granite-8b at
    full width; no kernel of K1-K7 launches on this path."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    check_lm_smoke(dev)
    serve_full_width(get_config("tinyllama_1_1b"), dev, smi, max_seq=256,
                     n_requests=16, prompt_len=8, new_tokens=32)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    serve_full_width(get_config("granite_8b"), dev, smi, max_seq=128,
                     n_requests=8, prompt_len=16, new_tokens=16)
    launched = {k: n for k, n in ops.launch_counts().items() if n}
    require(not launched, f"the LM path launched {launched}")
    print("  kernel launches on the LM path: none of K1-K7")


# ---------------------------------------------------------------------------
# Phase 8: the MoE, hybrid and RWKV-6 families
# ---------------------------------------------------------------------------

LM_FAMILY_ARCHS = ("dbrx_132b", "qwen3_moe_235b_a22b", "zamba2_7b",
                   "rwkv6_3b")
#: The full configs cut in depth to fit one card beside the engine's copy
#: (fp32 params and the bf16 copy: 3 qwen3 layers ~52 GB, 4 would be ~67
#: GB; 2 dbrx layers ~47 GB). The cut layers stand for the stages of a
#: pipeline on further cards; no width is cut.
LM_FAMILY_DEPTH = {"qwen3_moe_235b_a22b": 3, "dbrx_132b": 2}


def check_router_ties(dev) -> None:
    """Phase 8a, ties: qwen3's router width (d 4096, 128 experts, top 8)
    with columns 0 and 1 equal (and scaled up, so that both lead often):
    their logits are the same bits on either device, and wherever both are
    chosen expert 0 comes first, on the card as on the CPU; on the card
    every run of equal chosen probabilities is in ascending expert order;
    the card's picks lie within ROUTE_GAP of the CPU's."""
    import torch

    from repro_torch.layers import moe
    d, E, k, N = 4096, 128, 8, 1024
    gen = torch.Generator().manual_seed(8)
    router = torch.randn((d, E), generator=gen) * d ** -0.5
    router[:, 1] = router[:, 0] = router[:, 0] * 3
    x = torch.randn((N, d), generator=gen).to(torch.bfloat16)
    params = {"router": router}
    _, ids_cpu, _, _ = moe._route(params, x, E, k)
    gates, ids, _, _ = moe._route({"router": router.to(dev)}, x.to(dev), E, k)
    ids = ids.cpu()
    for name, got in (("CPU", ids_cpu), ("card", ids)):
        both = (got == 0).any(dim=1) & (got == 1).any(dim=1)
        pos0 = (got == 0).int().argmax(dim=1)
        pos1 = (got == 1).int().argmax(dim=1)
        require(int(both.sum()) > N // 4, f"ties: experts 0 and 1 chosen "
                f"together for only {int(both.sum())} tokens on the {name}")
        require(bool((pos1[both] == pos0[both] + 1).all()),
                f"ties: expert 1 before expert 0 on the {name}")
    probs = torch.softmax((x.to(dev) @ router.to(dev).to(torch.bfloat16)
                           ).float(), dim=-1)
    chosen = probs.gather(1, ids.to(dev)).cpu()
    tied = chosen[:, 1:] == chosen[:, :-1]
    require(bool((ids[:, 1:][tied] > ids[:, :-1][tied]).all()),
            "ties: equal probabilities chosen out of expert order on the card")
    cpu_probs = torch.softmax((x @ router.to(torch.bfloat16)).float(), dim=-1)
    gap = pick_gap(ids, cpu_probs)
    require(gap <= ROUTE_GAP, f"ties: a card pick {gap:.4f} off the CPU's")
    same = int((ids == ids_cpu).all(dim=1).sum())
    print(f"  router ties (d {d}, {E} experts, top {k}, {N} tokens, columns "
          f"0 and 1 equal): experts 0 and 1 chosen together for "
          f"{int(both.sum())} tokens, 0 first on the card and on the CPU; "
          f"{int(tied.sum())} equal adjacent picks on the card, all in "
          f"expert order; {same} of {N} tokens pick as on the CPU, the rest "
          f"within {gap:.4f}")


def run_lm_families(dev, smi: str) -> None:
    """Phase 8: the smoke configs of the four families card against CPU and
    the tie case, then zamba2-7b and rwkv6-3b at full width and depth, and
    qwen3-moe-235b-a22b and dbrx-132b at full width, cut in depth; no
    kernel of K1-K7 launches on this path."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    check_lm_smoke(dev, LM_FAMILY_ARCHS)
    check_router_ties(dev)
    for arch in ("zamba2_7b", "rwkv6_3b", "qwen3_moe_235b_a22b",
                 "dbrx_132b"):
        cfg = get_config(arch)
        if arch in LM_FAMILY_DEPTH:
            print(f"  reduced: {cfg.name} depth {cfg.n_layers} -> "
                  f"{LM_FAMILY_DEPTH[arch]} layers (one card holds the fp32 "
                  f"params and the engine's bf16 copy of no more; the cut "
                  f"layers stand for pipeline stages on further cards); no "
                  f"width cut")
            cfg = dataclasses.replace(cfg, n_layers=LM_FAMILY_DEPTH[arch])
        t0 = time.perf_counter()
        serve_full_width(cfg, dev, smi, max_seq=128, n_requests=8,
                         prompt_len=16, new_tokens=16, time_fp32=False)
        print(f"  {cfg.name}: {time.perf_counter() - t0:.1f} s")
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    launched = {k: n for k, n in ops.launch_counts().items() if n}
    require(not launched, f"the LM families' path launched {launched}")
    print("  kernel launches on the LM families' path: none of K1-K7")


# ---------------------------------------------------------------------------
# Phase 9: training
# ---------------------------------------------------------------------------

TRAIN_SMOKE_ARCHS = ("tinyllama_1_1b", "musicgen_large",
                     "qwen3_moe_235b_a22b", "zamba2_7b", "rwkv6_3b")
#: The card against the port's CPU run on the same params, batch and
#: routing, as the CPU tests hold the port's backward to jax.grad: the
#: loss within rtol 2^-8, each gradient leaf (and each optimizer state leaf
#: after a train step) within a relative L2 error of 2^-4; the params after
#: the step as ``step_gap`` says.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 2 ** -8, 2 ** -4
#: tinyllama-1.1b's training cell: AdamW, B 4 x S 2048, 20 steps.
TRAIN_DENSE = dict(batch=4, seq=2048, steps=20, lr=1e-3, warmup=5)
#: qwen3-moe-235b-a22b's: Adafactor at 2 of its 94 layers, B 4 x S 512.
TRAIN_MOE = dict(batch=4, seq=512, steps=5, layers=2)
#: The train_lm example's checkpoints, under the checkout (build/ is
#: ignored by git), removed after phase 9d.
TRAIN_CKPT = ROOT / "build" / "train_lm_ckpt"


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float64 on the host."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    den = float(b.norm())
    return float((a - b).norm()) / den if den else float((a - b).norm())


def loss_and_grads(params, cfg, plan, batch):
    """train_loss and its gradients with respect to every param leaf, in
    leaf order, through autograd (the config's remat policy)."""
    import torch

    from repro_torch.models import lm
    from repro_torch.training.tree import tree_leaves, tree_map
    work = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = lm.train_loss(work, cfg, plan, None, batch)
    grads = torch.autograd.grad(loss, tree_leaves(work))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def step_gap(p_d, p_c, before, ocfg) -> tuple[float, float]:
    """One train step's params on the card against the CPU's, as
    tests/test_torch_train_grads.py holds the port's step to the
    reference's: each within twice the larger of lr and the CPU's own step
    of it (its update but the weight decay), plus 2^-8 of that, and a mean
    difference of at most lr / 8. (At step 1 AdamW moves each weight by lr
    times the sign of its gradient, so a gradient near 0 may flip between
    two numeric paths and move a weight by 2 lr.) Returns the largest and
    the mean difference, in units of lr."""
    lr, worst, total, count = ocfg.lr, 0.0, 0.0, 0
    for d, c, p0 in zip(p_d, p_c, before):
        diff = (d.cpu() - c).abs()
        size = (c - (1 - lr * ocfg.weight_decay) * p0).abs()
        require(bool((diff <= 2 * size.clamp(min=lr)
                      * (1 + 2 ** -8)).all()),
                "a param after one train step lies beyond twice its step "
                "from the CPU's")
        worst = max(worst, float(diff.max()) / lr)
        total += float(diff.double().sum())
        count += diff.numel()
    require(total / count <= lr / 8, f"params after one train step differ "
            f"by {total / count / lr:.4f} lr on average, beyond 1/8")
    return worst, total / count / lr


def check_train_smoke(dev) -> None:
    """Phase 9a. Each training smoke config on the card against the port's
    CPU run on the same params and batch (``batch_for_step`` on each
    device: the same tokens) and the CPU's router choices, at the config's
    remat policy: the loss, every gradient leaf, and one ``make_train_step``
    step's update and optimizer state (the config's optimizer)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.relshard import plan_model
    from repro_torch.models import lm
    from repro_torch.models.config import SHAPE_BY_NAME
    from repro_torch.training.data import DataConfig, batch_for_step
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.training.tree import tree_leaves
    cpu = torch.device("cpu")
    for i, arch in enumerate(TRAIN_SMOKE_ARCHS):
        cfg = get_smoke_config(arch)
        plan = plan_model(cfg, LM_MESH, SHAPE_BY_NAME["train_4k"],
                          fsdp=False)
        host = lm.init_params(cfg, seed=i, device=cpu)
        params = lm.params_from_numpy(lm.params_to_numpy(host), dev)
        dc = DataConfig(cfg.vocab, 64, 2, i, cfg.n_cond_tokens, cfg.d_model)
        batch_cpu, batch = batch_for_step(dc, 0, cpu), batch_for_step(dc, 0,
                                                                      dev)
        require(all(torch.equal(batch[k].cpu(), batch_cpu[k])
                    for k in batch_cpu), f"{arch}: the batch differs "
                f"between the card and the CPU")
        rec = []
        with routing_tap(record=rec):
            loss_c, met_c, grads_c = loss_and_grads(host, cfg, plan,
                                                    batch_cpu)
        with routing_tap(force=rec) as routed:
            loss_d, met_d, grads_d = loss_and_grads(params, cfg, plan, batch)
        require(bool(torch.isfinite(loss_d)), f"{arch}: loss not finite")
        require(abs(float(loss_d) - float(loss_c))
                <= TRAIN_LOSS_RTOL * abs(float(loss_c)),
                f"{arch}: loss {float(loss_d):.6f} on the card against "
                f"{float(loss_c):.6f} on the CPU")
        g_err = max(rel_l2(d, c) for d, c in zip(grads_d, grads_c))
        require(g_err <= TRAIN_GRAD_RTOL, f"{arch}: a gradient leaf "
                f"{g_err:.4f} off the CPU's (relative L2)")
        if cfg.is_moe:
            require(torch.equal(met_d["moe_load"].cpu(), met_c["moe_load"]),
                    f"{arch}: moe_load, card vs CPU")

        ocfg = OptConfig(name=cfg.optimizer, lr=1e-3, warmup_steps=1)
        before = [t.clone() for t in tree_leaves(host)]
        sides = []
        rec = []
        for p, b, tap in ((host, batch_cpu, routing_tap(record=rec)),
                          (params, batch, None)):
            state = init_opt_state(ocfg, p)
            step = make_train_step(cfg, plan, None, ocfg)
            with tap if tap is not None else routing_tap(force=rec):
                p, state, m = step(p, state, b)
            sides.append((tree_leaves(p), tree_leaves(state), m))
        (p_c, s_c, m_c), (p_d, s_d, m_d) = sides
        u_max, u_mean = step_gap(p_d, p_c, before, ocfg)
        s_err = max(rel_l2(d, c) for d, c in zip(s_d, s_c)
                    if c.is_floating_point())
        require(s_err <= TRAIN_GRAD_RTOL, f"{arch}: one train step's "
                f"optimizer state {s_err:.4f} off the CPU's (relative L2)")
        require(float(m_d["lr"]) == float(m_c["lr"]),
                f"{arch}: the step's lr differs")
        print(f"  smoke {arch} ({cfg.remat_policy} remat, "
              f"{cfg.optimizer}): loss {float(loss_d):.5f} card, "
              f"{float(loss_c):.5f} CPU; largest relative L2 card vs CPU: "
              f"gradient leaf {g_err:.4f}, optimizer state after one step "
              f"{s_err:.4f}; params after it at most {u_max:.3f} lr apart, "
              f"{u_mean:.4f} lr on average"
              + (f"; moe_load equal; {routed['differed']} token-layers "
                 f"picked otherwise on the card, within {ROUTE_GAP}"
                 if cfg.is_moe else ""))


def device_pass(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` recording the device's
    activities alone (a training step makes tens of thousands, and the
    host-side records would take longer to process than the step): the
    device's busy time (the union of its activities), its idle share of the
    call's wall time, its activities and the kernels that take the most
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    require(bool(spans), "the profiler recorded no device time")
    busy = union_us(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                idle=1 - busy / wall_us, activities=len(spans),
                top=", ".join(f"{name[:48]} {us / 1e3:.1f} (x{n})"
                              for name, (n, us) in top))


def matmul_params(cfg, params) -> tuple[float, float]:
    """(all params, the params a token's forward multiplies by): every
    product weight and the head, an MoE token's experts at top_k of
    n_experts; the embedding table is a lookup."""
    n_all = sum(t.numel() for t in tree_leaves(params))
    n_active = weight_flops(params["blocks"], cfg.top_k
                            / max(cfg.n_experts, 1)) / 2
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return n_all, n_active + head["table"].numel()


def train_full_width(cfg, dev, smi: str, ocfg, batch: int, seq: int,
                     steps: int, state_bytes: int, reckoned_gb: float
                     ) -> None:
    """Phases 9b and 9c. ``steps`` steps of ``make_train_step`` from random
    params (seed 0) on ``batch_for_step`` data: a finite loss at every step
    and the last below the first; the step by CUDA events (the median of
    the steps after the first two), one more step under the profiler, the
    tokens a second and the peak memory, beside the step's bound: 6 N T
    FLOPs over the bf16 peak (N the params a token multiplies by), plus
    the optimizer's bytes, ``state_bytes`` a param, over the memory rate."""
    import torch

    from repro_torch.core.relshard import plan_model
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig
    from repro_torch.training.data import DataConfig, batch_for_step
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import make_train_step
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev)
    state = init_opt_state(ocfg, params)
    n_all, n_active = matmul_params(cfg, params)
    plan = plan_model(cfg, LM_MESH, ShapeConfig("train", seq, batch, "train"),
                      fsdp=False)
    step = make_train_step(cfg, plan, None, ocfg)
    dc = DataConfig(cfg.vocab, seq, batch, 0, cfg.n_cond_tokens, cfg.d_model)
    print(f"  {cfg.name} ({cfg.family.value}): {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}"
          + (f", {cfg.n_experts} experts top-{cfg.top_k}" if cfg.is_moe
             else "")
          + f"; {n_all / 1e9:.3f} B params ({n_active / 1e9:.3f} B "
          f"multiplied a token); {ocfg.name}, lr {ocfg.lr}, warm-up "
          f"{ocfg.warmup_steps}, remat {cfg.remat_policy}, B {batch} x S "
          f"{seq}; params and state built in {time.perf_counter() - t0:.1f} s")

    losses, metrics = [], None
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)] \
        if cuda else []
    t0 = time.perf_counter()
    if cuda:
        marks[0].record()
    for i in range(steps):
        params, state, metrics = step(params, state,
                                      batch_for_step(dc, i, dev))
        losses.append(metrics["loss"])
        if cuda:
            marks[i + 1].record()
    synchronize(dev)
    wall = time.perf_counter() - t0
    losses = torch.stack(losses).cpu()
    require(bool(torch.isfinite(losses).all()),
            f"{cfg.name}: a loss is not finite: {losses.tolist()}")
    require(float(losses[-1]) < float(losses[0]),
            f"{cfg.name}: the loss did not fall: {losses.tolist()}")
    times = sorted(a.elapsed_time(b) for a, b in zip(marks[2:-1], marks[3:])) \
        if cuda else [wall * 1e3 / steps]
    ms = times[len(times) // 2]
    prof = device_pass(lambda: step(params, state,
                                    batch_for_step(dc, steps, dev))) \
        if cuda else None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    flops = 6.0 * n_active * batch * seq
    b_flops = flops / PEAK_BF16_FLOPS_PER_S * 1e3
    b_bytes = state_bytes * n_all / PEAK_BYTES_PER_S * 1e3
    print(f"  {cfg.name}: loss by step "
          + " ".join(f"{x:.3f}" for x in losses.tolist())
          + f"; grad_norm {float(metrics['grad_norm']):.3f}, lr "
          f"{float(metrics['lr']):.2e} at the last step; {steps} steps in "
          f"{wall:.1f} s")
    if cfg.is_moe:
        load = metrics["moe_load"].float()
        print(f"  {cfg.name}: moe_dropped {float(metrics['moe_dropped']):.4f}"
              f" at the last step; load a layer across experts "
              f"min/median/max "
              + ", ".join(f"{int(lo.min())}/{int(lo.median())}/"
                          f"{int(lo.max())}" for lo in load)
              + f" of {batch * seq * cfg.top_k} assignments")
    print(f"  {cfg.name} readings ({smi}):")
    print(f"    train step: {ms:.1f} ms by events (median of steps 3-{steps};"
          f" range {times[0]:.1f}-{times[-1]:.1f}); "
          f"{batch * seq / ms * 1e3:.0f} tokens/s; bound "
          f"{b_flops + b_bytes:.1f} ms ({flops / 1e12:.1f} TFLOP over "
          f"{PEAK_BF16_FLOPS_PER_S:.3g} FLOP/s bf16 = {b_flops:.1f} ms, plus "
          f"{state_bytes} B x {n_all / 1e9:.2f} B params over "
          f"{PEAK_BYTES_PER_S:.3g} B/s = {b_bytes:.1f} ms)")
    if prof is not None:
        print(f"    one step under the profiler (device activities only): "
              f"wall {prof['wall_ms']:.1f} ms, device busy "
              f"{prof['busy_ms']:.1f} ms (idle share {prof['idle']:.3f}), "
              f"{prof['activities']} device activities; device ms by kernel: "
              f"{prof['top']}")
    print(f"    peak memory allocated: {peak / 1e9:.1f} GB "
          f"({peak / 2 ** 30:.2f} GiB), reckoned {reckoned_gb:.1f} GB")
    del params, state, metrics
    if cuda:
        torch.cuda.empty_cache()


@contextlib.contextmanager
def timed_checkpoints(log: list):
    """Record (what, seconds) for every ``save`` and ``restore`` that the
    train loop makes."""
    from repro_torch.training import train_loop
    mod = train_loop.ckpt_mod
    saved = mod.save, mod.restore

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            log.append((name, time.perf_counter() - t0))
            return out
        return call
    mod.save, mod.restore = timed("save", saved[0]), timed("restore",
                                                           saved[1])
    try:
        yield log
    finally:
        mod.save, mod.restore = saved


def train_example_and_restart(dev, steps: int = 300, every: int = 100
                              ) -> None:
    """Phase 9d. ``python -m repro_torch.examples.train_lm --steps 300``
    (its ``main``, on ``dev``, checkpointing every ``every`` steps) must
    print LEARNING, the reference script's own criterion. Then the same
    model resumes from its checkpoint at ``every`` and trains to
    ``2 * every``: its params and optimizer state must equal the first
    run's checkpoint at ``2 * every`` within the reference test's rtol and
    atol 2e-4."""
    import io
    import shutil

    import torch

    from repro_torch.examples import train_lm
    from repro_torch.training import checkpoint as ck
    from repro_torch.training.tree import tree_leaves
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    full_dir, resume_dir = TRAIN_CKPT / "example", TRAIN_CKPT / "restart"
    out = io.StringIO()
    log = []
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), timed_checkpoints(log):
        train_lm.main(["--steps", str(steps), "--ckpt", str(full_dir),
                       "--device", str(dev)])
    text = out.getvalue()
    print("\n".join(f"    | {line}" for line in text.splitlines()))
    require("LEARNING" in text, "train_lm did not print LEARNING")
    print(f"  train_lm --steps {steps}: LEARNING in "
          f"{time.perf_counter() - t0:.1f} s")

    name = f"step_{every:08d}"
    shutil.copytree(full_dir / name, resume_dir / name)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), timed_checkpoints(log):
        resumed = train_lm.main(["--steps", str(2 * every), "--ckpt",
                                 str(resume_dir), "--device", str(dev)])
    require(f"[train] resumed from step {every}" in out.getvalue(),
            "the second run did not resume")
    state = {"params": resumed["params"], "opt": resumed["opt_state"]}
    full, _ = ck.restore(str(full_dir), 2 * every, state)
    worst = 0.0
    for a, b in zip(tree_leaves(state), tree_leaves(full)):
        err = (a.double() - b.double()).abs()
        require(bool((err <= 2e-4 + 2e-4 * b.double().abs()).all()),
                "the resumed run differs from the full run beyond rtol "
                "2e-4, atol 2e-4")
        worst = max(worst, float(err.max()))
    saves = [s for what, s in log if what == "save"]
    restores = [s for what, s in log if what == "restore"]
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    print(f"  restart: from the checkpoint at {every} to {2 * every}, params "
          f"and optimizer state within {worst:.2e} of the first run's at "
          f"{2 * every} (rtol/atol 2e-4); a checkpoint of "
          f"{n_bytes / 1e9:.2f} GB saved in "
          + ", ".join(f"{s:.2f}" for s in saves) + " s, restored in "
          + ", ".join(f"{s:.2f}" for s in restores) + " s")
    del resumed, state, full
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run_training(dev, smi: str) -> None:
    """Phase 9: the training smoke configs card against CPU, tinyllama-1.1b
    at full width and depth with AdamW, qwen3-moe at full width with
    Adafactor at 2 of 94 layers, and the train_lm example with a restart;
    no kernel of K1-K7 launches on this path."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.training.optimizer import OptConfig
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    check_train_smoke(dev)
    print(f"  9a: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cfg = get_config("tinyllama_1_1b")
    d = TRAIN_DENSE
    n = cfg.param_count()
    train_full_width(
        cfg, dev, smi, OptConfig(name="adamw", lr=d["lr"],
                                 warmup_steps=d["warmup"]),
        d["batch"], d["seq"], d["steps"], state_bytes=28,
        reckoned_gb=16 * n / 1e9 + 9.0)
    print(f"  9b: {time.perf_counter() - t0:.1f} s")
    gc.collect()

    t0 = time.perf_counter()
    m = TRAIN_MOE
    cfg = get_config("qwen3_moe_235b_a22b")
    print(f"  reduced: {cfg.name} depth {cfg.n_layers} -> {m['layers']} "
          f"layers (one card holds the fp32 params and grads of no more; "
          f"the cut layers stand for pipeline stages on further cards); no "
          f"width cut")
    cfg = dataclasses.replace(cfg, n_layers=m["layers"])
    n = cfg.param_count()
    train_full_width(cfg, dev, smi, OptConfig(name=cfg.optimizer),
                     m["batch"], m["seq"], m["steps"], state_bytes=12,
                     reckoned_gb=8 * n / 1e9 + 16.0)
    print(f"  9c: {time.perf_counter() - t0:.1f} s")
    gc.collect()

    t0 = time.perf_counter()
    train_example_and_restart(dev)
    print(f"  9d: {time.perf_counter() - t0:.1f} s")
    launched = {k: c for k, c in ops.launch_counts().items() if c}
    require(not launched, f"the training path launched {launched}")
    print("  kernel launches on the training path: none of K1-K7")


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 10: the sharded LM paths, four ranks sharing the card
# ---------------------------------------------------------------------------

SHARD_WORLD = 4
#: 10a: the engine's requests (8 prompt tokens, 16 new) and the prefill
SHARD_PROMPT, SHARD_NEW, SHARD_SLOTS = 8, 16, 8
SHARD_PREFILL = (8, 512)
#: 10b: phase 9's batch; 10c: the experts' capacity factor at which
#: neither path drops an assignment, and the decode steps
SHARD_TRAIN = (4, 2048)
SHARD_TRAIN_STEPS = 3
MOE_DROPLESS_CF = 4.0
#: the reference's capacity factor (``moe_apply``'s default)
MOE_CF = 1.5
MOE_DECODE_STEPS = 4
#: the bf16 bounds the port is held to across numeric paths
BF16_RTOL, BF16_ATOL, BF16_MEAN = 2 ** -5, 2 ** -4, 2 ** -6


def shard_axes(data: int, model: int) -> tuple:
    return (("data", data), ("model", model))


def probe_collectives(mesh, device) -> dict:
    """Which collective kinds the backend runs on tensors of ``device``:
    each is tried once on a small tensor (every rank tries the same ones).
    Returns {kind: ran}."""
    import torch
    import torch.distributed as dist
    out = {}
    n = mesh.size
    x = torch.ones(n * 2, dtype=torch.float32, device=device)
    tries = {
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(n)], x),
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "reduce_scatter": lambda: dist.reduce_scatter_tensor(
            torch.empty(2, device=device), x.clone()),
        "all_to_all": lambda: dist.all_to_all_single(torch.empty_like(x),
                                                     x),
    }
    for kind, fn in tries.items():
        try:
            fn()
            ok = True
        except (RuntimeError, ValueError, NotImplementedError):
            ok = False
        # every rank must agree before the next collective is tried
        flag = torch.tensor([int(ok)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        out[kind] = bool(flag.item())
    return out


def shard_mesh(axes, dev):
    """A mesh over the rank's group, after trying each collective kind on
    the rank's tensors: the phase needs every kind the backend runs (gloo
    runs them on CUDA tensors by copying through host memory)."""
    from repro_torch.models import sharding as sh
    mesh = sh.Mesh(axes, device=dev)
    ran = probe_collectives(mesh, dev)
    require(all(ran.values()), "the backend refused a collective on the "
            f"ranks' tensors: {ran}")
    return mesh, ran


def spread_reading(got, want, what: str) -> dict:
    """The largest and the mean difference of ``got`` from ``want`` and
    the entries beyond the bf16 elementwise bound."""
    a, b = got.float().cpu(), want.float().cpu()
    require(a.shape == b.shape, f"{what}: shapes {a.shape} and {b.shape}")
    err = (a - b).abs()
    return {"max_err": float(err.max()), "mean_err": float(err.mean()),
            "beyond": int((err > BF16_ATOL + BF16_RTOL * b.abs()).sum()),
            "entries": err.numel()}


def within_spread(r: dict) -> bool:
    return (r["mean_err"] <= BF16_MEAN
            and r["beyond"] <= r["entries"] * 2 ** -10)


def spread_close(got, want, what: str) -> dict:
    """A sharded path's output against mesh=None's where the model axis's
    bf16 partial sums, added in another order, move a few entries past
    the bf16 elementwise bound: the mean difference within its 2^-6 and at
    most 2^-10 of the entries beyond the elementwise bound. The f32 twins
    (``twin_close``) show the same paths within the elementwise bound when
    nothing rounds to bf16, and a planted fault (``fault_reading``) what
    a missing all-reduce reads here. Returns ``spread_reading``'s."""
    require(torch_isfinite(got), f"{what}: not finite")
    r = spread_reading(got, want, what)
    require(r["mean_err"] <= BF16_MEAN, f"{what}: mean difference "
            f"{r['mean_err']:.5f} above {BF16_MEAN}")
    require(within_spread(r), f"{what}: {r['beyond']} of {r['entries']} "
            "entries beyond the bf16 elementwise bound")
    return r


def twin_close(got, want, what: str) -> dict:
    """An f32 twin (every layer in f32, the same bf16 weights) of a sharded
    output against mesh=None's f32 twin: every entry within the bf16
    elementwise bound and the mean within 2^-6."""
    require(torch_isfinite(got), f"{what}: not finite")
    r = spread_reading(got, want, what)
    require(r["beyond"] == 0 and r["mean_err"] <= BF16_MEAN,
            f"{what}: {r['beyond']} entries beyond the bf16 elementwise "
            f"bound, mean difference {r['mean_err']:.6f}")
    return r


@contextlib.contextmanager
def planted_fault(skip: int | None = None):
    """Count the calls of the model axis's all-reduce in the block
    (``sharding.reduce_fwd``, Megatron's g: after attention's ``w_o``,
    the MLP's down projection, a vocab-parallel lookup). With ``skip``, a
    planted fault: that call (from 0) returns the rank's partial sum
    unreduced. Yields a one-item list holding the count."""
    from repro_torch.models import sharding as sh
    orig, calls = sh.reduce_fwd, [0]

    def reduce_fwd(x, mesh, axes):
        calls[0] += 1
        return x if calls[0] - 1 == skip else orig(x, mesh, axes)
    sh.reduce_fwd = reduce_fwd
    try:
        yield calls
    finally:
        sh.reduce_fwd = orig


def fault_reading(run, skip: int, unshard, want, what: str) -> dict:
    """``spread_reading`` of ``run()`` with all-reduce ``skip`` missing
    (``planted_fault``), whole by ``unshard``, against ``want``; required
    to fail ``spread_close``."""
    import torch
    with torch.no_grad(), planted_fault(skip):
        out = unshard(run())
    r = spread_reading(out, want, what)
    require(not within_spread(r) or not torch_isfinite(out),
            f"{what}: with all-reduce {skip} missing the output still "
            f"passes the spread check ({r})")
    return {**r, "skip": skip}


def depth_close(got, want, what: str) -> dict:
    """``spread_close`` for logits, and each row's top token the same or a
    near-tie in mesh=None's logits (within the bf16 elementwise bound)."""
    out = spread_close(got, want, what)
    a, b = got.float().cpu(), want.float().cpu()
    top_a, top_b = a.argmax(dim=-1), b.argmax(dim=-1)
    gap = (b.gather(-1, top_b[..., None]) - b.gather(-1, top_a[..., None])
           ).abs()[..., 0]
    require(bool((gap <= BF16_ATOL + BF16_RTOL * b.abs().amax(-1)).all()),
            f"{what}: a row's top token is no near-tie of mesh=None's "
            f"(gap {float(gap.max()):.4f})")
    return {**out, "top_same": int((top_a == top_b).sum()),
            "rows": top_a.numel()}


def torch_isfinite(t) -> bool:
    import torch
    return bool(torch.isfinite(t).all())


def rank_readings(mesh, dev, times: list) -> dict:
    import torch
    times = sorted(times)
    return {"ms": times[len(times) // 2] if times else 0.0,
            "calls": dict(mesh.stats.calls),
            "bytes": dict(mesh.stats.sent_bytes),
            "peak": (torch.cuda.max_memory_allocated(dev)
                     if dev.type == "cuda" else 0)}


def print_rank_readings(label: str, readings: list, what: str) -> None:
    for r, rd in enumerate(readings):
        print(f"    {label} rank {r}: {what} {rd['ms']:.1f} ms by events "
              f"(median); collectives "
              + ", ".join(f"{k} {rd['calls'][k]} calls {rd['bytes'][k]} B"
                          for k in rd["calls"] if rd["calls"][k])
              + f"; peak memory {rd['peak'] / 1e9:.2f} GB")


def timed(dev, fn):
    """(fn's result, its milliseconds between two CUDA events, or by the
    host's clock on the CPU)."""
    import torch
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def leaf_digests(tree, specs, mesh) -> list:
    """``checkpoint.digest`` of every leaf, gathered whole, in leaf order
    (on every rank)."""
    from repro_torch.models import sharding as sh
    from repro_torch.training import checkpoint as ck
    from repro_torch.training.tree import tree_leaves
    out = []
    for t, s in zip(tree_leaves(tree), tree_leaves(specs)):
        whole = sh.unshard(t.detach(), s, mesh) if mesh is not None else t
        out.append(ck.digest(whole.cpu().numpy()))
    return out


def serve_requests(cfg, seed: int = 7) -> list:
    import torch
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(1, cfg.vocab, (SHARD_PROMPT,), generator=gen
                          ).tolist() for _ in range(SHARD_SLOTS)]


def drain(eng, prompts, new: int, dev) -> tuple:
    """Every prompt through the engine, ``new`` tokens each; (tokens per
    request, each step's ms)."""
    from repro_torch.serving.engine import Request
    reqs = [Request(i, list(p), new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    times = []
    while eng.queue or eng.occupancy():
        _, ms = timed(dev, eng.step)
        times.append(ms)
        require(len(times) < 10_000, "the engine does not drain")
    require(all(r.done and len(r.out) == new for r in reqs),
            "a request did not complete")
    return [r.out for r in reqs], times


def dense_rank(rank: int, dev, cfg, params, ref: dict, out_dir: str
               ) -> None:
    """10a and 10b on one rank: ``params`` whole (shared with the parent),
    ``ref`` the single-device results."""
    import torch

    from repro_torch.core.relshard import plan_model
    from repro_torch.models import lm
    from repro_torch.models import sharding as sh
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training import checkpoint as ck
    from repro_torch.training.data import DataConfig, batch_for_step
    from repro_torch.training.optimizer import (OptConfig, init_opt_state,
                                                opt_state_specs)
    from repro_torch.training.train_loop import make_train_step
    report: dict = {}
    slots, new = len(ref["prompts"]), ref["new"]
    max_seq = len(ref["prompts"][0]) + new

    # 10a: the engine and a prefill on 2x2 under the serve plan
    mesh, ran = shard_mesh(shard_axes(2, 2), dev)
    report["probe"] = ran
    shape = ShapeConfig("serve", max_seq, slots, "decode")
    plan = plan_model(cfg, shard_axes(2, 2), shape, fsdp=False)
    blocks = lm.shard_params(params, cfg, plan, mesh)
    eng = ServeEngine(cfg, plan, mesh, blocks, max_batch=slots,
                      max_seq=max_seq, device=dev)
    del blocks
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mesh.stats.reset()
    outs, times = drain(eng, ref["prompts"], new, dev)
    report["serve"] = {"tokens": outs, **rank_readings(mesh, dev, times)}
    mesh.stats.reset()
    with torch.no_grad():
        logits, ms = timed(dev, lambda: lm.prefill(
            eng.weights, cfg, plan, mesh, ref["prefill_tokens"]))
    # the prefill's own readings, before the logits are gathered whole
    readings = rank_readings(mesh, dev, [ms])
    vocab = plan.model_axis if plan.head_strategy == "vocab_parallel" \
        else None
    ctx = lm.shard_ctx(plan, mesh, ref["prefill_tokens"].shape[0])
    spec = sh.P(ctx.batch or None, vocab)
    whole = sh.unshard(logits, spec, mesh)
    report["prefill"] = {**depth_close(whole, ref["prefill"],
                                       "10a prefill logits"), **readings}
    del logits, whole

    # the f32 twin of that prefill, and the last all-reduce left out
    def prefill():
        return lm.prefill(eng.weights, cfg, plan, mesh,
                          ref["prefill_tokens"])
    with torch.no_grad(), compute_dtype(torch.float32), \
            planted_fault() as n_reduce:
        report["prefill_f32"] = twin_close(
            sh.unshard(prefill(), spec, mesh), ref["prefill_f32"],
            "10a prefill logits, the f32 twin")
    report["prefill_fault"] = fault_reading(
        prefill, n_reduce[0] - 1, lambda t: sh.unshard(t, spec, mesh),
        ref["prefill"], "10a prefill logits")
    del eng
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 10b: AdamW steps on 2x2 and on 1x4 under the train plan
    B, S, n_steps = ref["train"]
    ocfg = OptConfig(name="adamw")
    dc = DataConfig(cfg.vocab, S, B, 0, cfg.n_cond_tokens, cfg.d_model)
    ckpt_dir = str(Path(out_dir) / "ckpt")
    for data, model in ((2, 2), (1, 4)):
        axes = shard_axes(data, model)
        mesh = sh.Mesh(axes, device=dev)
        plan = plan_model(cfg, axes, ShapeConfig("train", S, B, "train"))
        specs = lm.param_specs(cfg, params, plan)
        blocks = sh.shard_tree(params, specs, mesh)
        state = init_opt_state(ocfg, blocks)
        step = make_train_step(cfg, plan, mesh, ocfg)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        mesh.stats.reset()
        losses, times = [], []
        for i in range(n_steps):
            (blocks, state, m), ms = timed(dev, lambda: step(
                blocks, state, batch_for_step(dc, i, dev)))
            losses.append(float(m["loss"]))
            times.append(ms)
            if i == 0:
                worst = mean = 0.0
                for b, a, p0, s in zip(tree_leaves(blocks),
                                       tree_leaves(ref["after"]),
                                       tree_leaves(params),
                                       tree_leaves(specs)):
                    a, p0 = sh.shard(a, s, mesh), sh.shard(p0, s, mesh)
                    diff = (b - a).abs()
                    size = (a - (1 - ocfg.lr * ocfg.weight_decay) * p0).abs()
                    require(bool((diff <= 2 * size.clamp(min=ocfg.lr)
                                  * (1 + 2 ** -8)).all()),
                            f"10b {data}x{model}: a param after one step "
                            "lies beyond twice its step from mesh=None's")
                    worst = max(worst, float(diff.max()) / ocfg.lr)
                    mean += float(diff.double().sum())
                mean = float(sh.all_reduce_raw(
                    mesh, torch.tensor(mean, dtype=torch.float64),
                    mesh.axis_names)) / sum(p.numel() for p in
                                            tree_leaves(params)) / ocfg.lr
                require(mean <= 1 / 8, f"10b {data}x{model}: params after "
                        f"one step differ by {mean:.4f} lr on average")
                first = {"loss": losses[0], "worst_lr": worst,
                         "mean_lr": mean}
        key = f"train_{data}x{model}"
        report[key] = {"losses": losses, **first,
                       **rank_readings(mesh, dev, times)}
        if (data, model) == (2, 2):
            report["digests_2x2"] = []
            ck.save(ckpt_dir, n_steps,
                    {"params": blocks, "opt": state}, mesh=mesh,
                    specs={"params": specs,
                           "opt": opt_state_specs(ocfg, specs)},
                    digests=report["digests_2x2"])
        else:
            # the 2x2 checkpoint onto this mesh's shardings
            from repro_torch.training.train_loop import sharding_trees
            p_sh, o_sh, _ = sharding_trees(cfg, plan, mesh, ocfg, params)
            back, _ = ck.restore(ckpt_dir, n_steps,
                                 {"params": blocks, "opt": state},
                                 shardings={"params": p_sh, "opt": o_sh})
            report["digests_1x4"] = leaf_digests(
                back, {"params": specs,
                       "opt": opt_state_specs(ocfg, specs)}, mesh)
            del back
        del blocks, state, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if rank == 0:
        with open(Path(out_dir) / "dense.pkl", "wb") as f:
            pickle.dump(report, f)
    gathered = [None] * SHARD_WORLD
    import torch.distributed as dist
    dist.all_gather_object(gathered, {k: {x: v[x] for x in ("ms", "calls",
                                                            "bytes", "peak")}
                                      for k, v in report.items()
                                      if isinstance(v, dict) and "ms" in v})
    if rank == 0:
        with open(Path(out_dir) / "dense_ranks.pkl", "wb") as f:
            pickle.dump(gathered, f)


def moe_rank(rank: int, dev, cfg, weights, ref: dict, out_dir: str) -> None:
    """10c on one rank: qwen3's bf16 ``weights`` whole (shared with the
    parent) placed on 1x4 with expert parallelism; prefill and decode on
    the parent's routing, at a capacity factor with no drop and at the
    config's."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import lm
    from repro_torch.models import sharding as sh
    mesh, ran = shard_mesh(shard_axes(1, 4), dev)
    plan = ref["plan"]
    blocks = lm.shard_params(weights, cfg, plan, mesh)
    m = mesh.coords["model"]
    B, S = ref["tokens"].shape
    n_steps = ref["steps"].shape[1]

    def seq_block(t):          # this rank's tokens of a (B*S, ...) record
        n = mesh.n(plan.model_axis)
        return t.reshape(B, S, -1)[:, m * S // n:(m + 1) * S // n] \
            .reshape(-1, t.shape[-1])
    prefill_routing = [(seq_block(i), seq_block(p)) for i, p in
                       ref["routing"]]
    vocab = plan.model_axis if plan.head_strategy == "vocab_parallel" \
        else None
    report = {"probe": ran}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for cf in (ref["dropless_cf"], MOE_CF):
        mesh.stats.reset()
        # the drops at the config's factor on the path's own routing
        tap = (routing_tap(force=prefill_routing)
               if cf == ref["dropless_cf"] else contextlib.nullcontext())
        with torch.no_grad(), moe_factor(cf), tap:
            (hidden, aux), ms = timed(dev, lambda: lm.forward(
                blocks, cfg, plan, mesh, ref["tokens"]))
        report[f"prefill_cf{cf}"] = {"dropped": float(aux.moe_dropped),
                                     "load": aux.moe_load.cpu(),
                                     **rank_readings(mesh, dev, [ms])}
        if cf == ref["dropless_cf"]:
            ctx = lm.shard_ctx(plan, mesh, B)
            whole = sh.unshard(hidden, sh.P(ctx.batch or None), mesh)
            report["hidden"] = spread_close(
                whole, ref["hidden"], "10c hidden states, expert parallel "
                "against the replicated path (no drop)")
            require(float(aux.moe_dropped) == 0.0, "10c: expert parallel "
                    f"dropped {float(aux.moe_dropped)} at cf {cf}")
        del hidden
    # decode on the replicated path's routing (tokens whole on each rank)
    # (every model rank routes the same tokens: each expert shard gets a
    # copy from each, so the config's factor drops copies that the
    # replicated path keeps)
    cache = lm.init_cache(cfg, B, n_steps, dev, mesh=mesh, plan=plan)
    mesh.stats.reset()
    times, errs, aux = [], [], []
    with torch.no_grad(), moe_factor(ref["dropless_cf"]), \
            routing_tap(force=ref["decode_routing"]):
        for t in range(n_steps):
            (lg, cache), ms = timed(dev, lambda: lm.decode_step(
                blocks, cfg, plan, mesh, ref["steps"][:, t:t + 1],
                cache, aux, max_seq=n_steps))
            times.append(ms)
            whole = sh.unshard(lg, sh.P(None, vocab), mesh)
            errs.append(depth_close(whole, ref["decode"][:, t],
                                    f"10c decode step {t}")["max_err"])
    require(all(float(a.dropped) == 0.0 for a in aux),
            "10c: an expert-parallel decode step dropped an assignment")
    report["decode"] = {"max_err": max(errs),
                        **rank_readings(mesh, dev, times)}
    del cache
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the f32 twin at the dropless factor, on the f32 twin's routing
    with torch.no_grad(), compute_dtype(torch.float32), \
            moe_factor(ref["dropless_cf"]), routing_tap(
                force=[(seq_block(i), seq_block(p))
                       for i, p in ref["routing_f32"]]):
        hidden, _ = lm.forward(blocks, cfg, plan, mesh, ref["tokens"])
    report["hidden_f32"] = twin_close(
        sh.unshard(hidden, sh.P(ctx.batch or None), mesh),
        ref["hidden_f32"], "10c hidden states, the f32 twin")
    del hidden
    gathered = [None] * SHARD_WORLD
    dist.all_gather_object(gathered, report)
    if rank == 0:
        with open(Path(out_dir) / "moe.pkl", "wb") as f:
            pickle.dump(gathered, f)


def shard_rank(rank: int, world: int, backend: str, store: str,
               out_dir: str, device: str, body: str, args: tuple) -> None:
    """One rank process of phase 10: joins the group through a
    ``FileStore`` and runs ``body`` ("dense" or "moe")."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    from repro_torch.kernels import ops
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=600))
    try:
        ops.reset_launch_counts()
        {"dense": dense_rank, "moe": moe_rank}[body](rank, dev, *args,
                                                      out_dir)
        counts = [None] * world
        dist.all_gather_object(counts, ops.launch_counts())
        if rank == 0:
            with open(Path(out_dir) / f"{body}_launches.pkl", "wb") as f:
                pickle.dump(counts, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
        for a in args:
            if isinstance(a, dict):
                a.clear()


def spawn_shards(body: str, args: tuple, device: str, tmp: str) -> None:
    """The ranks of ``body``; none may launch a kernel of K1-K7 (each
    rank's launch counts, read where its body ends)."""
    import torch.multiprocessing as mp
    mp.start_processes(shard_rank, nprocs=SHARD_WORLD, start_method="spawn",
                       args=(SHARD_WORLD, "gloo", str(Path(tmp) / "store"),
                             tmp, device, body, args))
    with open(Path(tmp) / f"{body}_launches.pkl", "rb") as f:
        counts = pickle.load(f)
    require(not any(n for c in counts for n in c.values()),
            f"phase 10's {body} ranks launched a kernel of K1-K7: {counts}")


def print_probe(ran: dict) -> None:
    print("  gloo on the ranks' tensors ran: " + ", ".join(ran))


def run_sharded_dense(cfg, dev, smi: str, tmp: str) -> dict:
    """10a and 10b. The single-device references on the card first (the
    engine's tokens, a prefill, one AdamW step), then four ranks. Returns
    rank 0's readings of the 10a prefill (phase 11b counts it)."""
    import torch

    from repro_torch.core.relshard import plan_model
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training import checkpoint as ck
    from repro_torch.training.data import DataConfig, batch_for_step
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev)
    prompts = serve_requests(cfg)
    shape = ShapeConfig("serve", SHARD_PROMPT + SHARD_NEW, SHARD_SLOTS,
                        "decode")
    plan = plan_model(cfg, shard_axes(2, 2), shape, fsdp=False)
    print(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}; 10a serve "
          f"plan on 2x2: embed {plan.embed_strategy}, head "
          f"{plan.head_strategy}, tp {plan.tp}, fsdp {plan.fsdp_axes}")
    eng = ServeEngine(cfg, plan, None, params, max_batch=SHARD_SLOTS,
                      max_seq=SHARD_PROMPT + SHARD_NEW, device=dev)
    want, _ = drain(eng, prompts, SHARD_NEW, dev)
    gen = torch.Generator().manual_seed(11)
    toks = torch.randint(0, cfg.vocab, SHARD_PREFILL, generator=gen,
                         dtype=torch.int32).to(dev)
    with torch.no_grad():
        pre = lm.prefill(eng.weights, cfg, plan, None, toks)
        with compute_dtype(torch.float32):
            pre32 = lm.prefill(eng.weights, cfg, plan, None, toks)
    del eng
    B, S = SHARD_TRAIN
    ocfg = OptConfig(name="adamw")
    tplan = plan_model(cfg, shard_axes(2, 2), ShapeConfig("train", S, B,
                                                          "train"))
    print(f"  10b train plan on 2x2: embed {tplan.embed_strategy}, head "
          f"{tplan.head_strategy}, tp {tplan.tp}, fsdp {tplan.fsdp_axes}")
    work = tree_map_clone(params)
    state = init_opt_state(ocfg, work)
    dc = DataConfig(cfg.vocab, S, B, 0, cfg.n_cond_tokens, cfg.d_model)
    work, state, m = make_train_step(cfg, tplan, None, ocfg)(
        work, state, batch_for_step(dc, 0, dev))
    ref_loss = float(m["loss"])
    del state, m
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"  single-device references on the card in "
          f"{time.perf_counter() - t0:.1f} s: {len(prompts)} requests "
          f"drained, prefill {SHARD_PREFILL}, one AdamW step (loss "
          f"{ref_loss:.4f})")
    t1 = time.perf_counter()
    spawn_shards("dense", (cfg, params, {
        "prompts": prompts, "new": SHARD_NEW, "prefill_tokens": toks,
        "prefill": pre, "prefill_f32": pre32, "after": work,
        "train": (B, S, SHARD_TRAIN_STEPS)}),
        str(dev if dev.type == "cpu" else "cuda:0"), tmp)
    with open(Path(tmp) / "dense.pkl", "rb") as f:
        rep = pickle.load(f)
    with open(Path(tmp) / "dense_ranks.pkl", "rb") as f:
        ranks = pickle.load(f)
    print(f"  four ranks under gloo on the one card ({smi}): "
          f"{time.perf_counter() - t1:.1f} s, spawn included")
    print_probe(rep["probe"])
    got = rep["serve"]["tokens"]
    same = sum(a == b for a, b in zip(got, want))
    if same != len(want):
        for i, (a, b) in enumerate(zip(got, want)):
            if a != b:
                j = next(t for t in range(len(a)) if a[t] != b[t])
                gap, size = logit_gap(params, cfg, plan, prompts[i] + a[:j],
                                      a[j], b[j], dev)
                require(gap <= BF16_ATOL + BF16_RTOL * size,
                        f"10a request {i}: tokens part at step {j} where "
                        f"mesh=None's logits differ by {gap:.4f}")
                print(f"  10a request {i}: parts at step {j}, a near-tie "
                      f"(mesh=None's logits {gap:.4f} apart)")
    pf = rep["prefill"]
    print(f"  10a: {SHARD_SLOTS} requests of {SHARD_PROMPT} + {SHARD_NEW} "
          f"tokens on 2x2: every rank's tokens equal; {same} of {len(want)} "
          f"requests equal mesh=None's; prefill {SHARD_PREFILL} logits "
          f"against mesh=None's: mean difference {pf['mean_err']:.5f}, "
          f"largest {pf['max_err']:.4f}, {pf['beyond']} of {pf['entries']} "
          f"beyond the bf16 elementwise bound; top token the same in "
          f"{pf['top_same']} of {pf['rows']} rows, the rest near-ties")
    tw, fl = rep["prefill_f32"], rep["prefill_fault"]
    print(f"  10a witness: the f32 twin of that prefill (every layer in "
          f"f32, the same bf16 weights) against mesh=None's f32 twin: "
          f"mean difference {tw['mean_err']:.3e}, largest "
          f"{tw['max_err']:.3e}, none beyond the bf16 elementwise bound; "
          f"a planted fault, the last of {fl['skip'] + 1} model-axis "
          f"all-reduces left out, reads mean {fl['mean_err']:.5f}, largest "
          f"{fl['max_err']:.4f}, {fl['beyond']} of {fl['entries']} beyond "
          f"(the spread check allows mean {BF16_MEAN}, "
          f"{int(fl['entries'] * 2 ** -10)} beyond)")
    print_rank_readings("10a decode step", [r["serve"] for r in ranks],
                        "engine step")
    print_rank_readings("10a prefill", [r["prefill"] for r in ranks],
                        f"prefill {SHARD_PREFILL}")
    for key in ("train_2x2", "train_1x4"):
        t = rep[key]
        require(all(math.isfinite(x) for x in t["losses"]),
                f"10b {key}: a loss is not finite")
        require(abs(t["loss"] - ref_loss) <= 2 ** -8 * abs(ref_loss),
                f"10b {key}: loss {t['loss']} against mesh=None's "
                f"{ref_loss}")
        print(f"  10b {key}: losses " + " ".join(f"{x:.4f}" for x in
                                                 t["losses"])
              + f" (mesh=None's first {ref_loss:.4f}); params after step 1 "
              f"within twice their step of mesh=None's (largest "
              f"{t['worst_lr']:.3f} lr, mean {t['mean_lr']:.5f} lr)")
        print_rank_readings(f"10b {key} step", [r[key] for r in ranks],
                            "train step")
    # the 2x2 checkpoint on 1x4 and on no mesh, bit for bit
    like = {"params": params, "opt": init_opt_state(ocfg, params)}
    back, _ = ck.restore(str(Path(tmp) / "ckpt"), SHARD_TRAIN_STEPS, like)
    none = leaf_digests(back, like, None)
    require(rep["digests_1x4"] == rep["digests_2x2"] == none,
            "10b: the 2x2 checkpoint does not restore bit-equal")
    print(f"  10b: the checkpoint written on 2x2 restores bit-equal on 1x4 "
          f"and on no mesh ({len(none)} leaves)")
    del params, work, back, like, pre, pre32
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ranks[0]["prefill"]


def tree_map_clone(tree):
    if isinstance(tree, dict):
        return {k: tree_map_clone(v) for k, v in tree.items()}
    return tree.clone()


def logit_gap(params, cfg, plan, prefix, a: int, b: int, dev) -> float:
    """How far apart mesh=None's logits of tokens ``a`` and ``b`` lie after
    ``prefix``, and the larger of their magnitudes."""
    import torch
    with torch.no_grad():
        lg = all_position_logits(params, cfg, plan, torch.tensor(
            [prefix], dtype=torch.int32, device=dev))[0, -1]
    return (float((lg[a] - lg[b]).abs()),
            float(torch.maximum(lg[a].abs(), lg[b].abs())))


def run_sharded_moe(cfg, dev, smi: str, tmp: str) -> None:
    """10c. The replicated path on the card (mesh=None, bf16 weights, the
    dropless capacity factor) records its routing, then four ranks run the
    expert-parallel path on it."""
    import dataclasses

    import torch

    from repro_torch.core.relshard import plan_model
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev)
    weights = lm.cast_params(params, dev)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    B, S = SHARD_PREFILL
    plan = plan_model(cfg, shard_axes(1, 4), ShapeConfig("prefill", S, B,
                                                         "prefill"))
    plan = dataclasses.replace(plan, moe_strategy="expert_parallel")
    print(f"  {cfg.name}: {cfg.n_layers} of 94 layers, {cfg.n_experts} "
          f"experts top-{cfg.top_k} ({cfg.n_experts // SHARD_WORLD} a rank); "
          f"plan on 1x4: embed {plan.embed_strategy}, head "
          f"{plan.head_strategy}, moe {plan.moe_strategy}")
    gen = torch.Generator().manual_seed(13)
    toks = torch.randint(0, cfg.vocab, SHARD_PREFILL, generator=gen,
                         dtype=torch.int32).to(dev)
    steps = torch.randint(0, cfg.vocab, (B, MOE_DECODE_STEPS), generator=gen,
                          dtype=torch.int32).to(dev)
    rec, drops = [], {}
    for cf in (MOE_DROPLESS_CF, MOE_CF):
        tap = (routing_tap(record=rec) if cf == MOE_DROPLESS_CF
               else contextlib.nullcontext())
        with torch.no_grad(), moe_factor(cf), tap:
            hidden, aux = lm.forward(weights, cfg, plan, None, toks)
        drops[cf] = float(aux.moe_dropped)
        if cf == MOE_DROPLESS_CF:
            require(drops[cf] == 0.0, f"10c: the replicated path dropped "
                    f"{drops[cf]} at cf {cf}")
            ref_hidden = hidden
    rec32 = []
    with torch.no_grad(), compute_dtype(torch.float32), \
            moe_factor(MOE_DROPLESS_CF), routing_tap(record=rec32):
        hidden32, aux = lm.forward(weights, cfg, plan, None, toks)
    require(float(aux.moe_dropped) == 0.0, "10c: the replicated path's f32 "
            "twin dropped an assignment")
    drec, aux = [], []
    cache = lm.init_cache(cfg, B, MOE_DECODE_STEPS, dev)
    logits = []
    with torch.no_grad(), moe_factor(MOE_DROPLESS_CF), \
            routing_tap(record=drec):
        for t in range(MOE_DECODE_STEPS):
            lg, cache = lm.decode_step(weights, cfg, plan, None,
                                       steps[:, t:t + 1], cache, aux)
            logits.append(lg)
    require(all(float(a.dropped) == 0.0 for a in aux),
            "10c: a replicated decode step dropped an assignment")
    del cache, hidden
    if dev.type == "cuda":
        torch.cuda.empty_cache()    # the f32 twin's slots, for the ranks
    print(f"  the replicated path on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    spawn_shards("moe", (cfg, weights, {
        "plan": plan, "tokens": toks, "steps": steps, "hidden": ref_hidden,
        "hidden_f32": hidden32, "dropless_cf": MOE_DROPLESS_CF,
        "routing": [(i, p) for i, p in rec],
        "routing_f32": [(i, p) for i, p in rec32],
        "decode_routing": [(i, p) for i, p in drec],
        "decode": torch.stack(logits, dim=1)}),
        str(dev if dev.type == "cpu" else "cuda:0"), tmp)
    with open(Path(tmp) / "moe.pkl", "rb") as f:
        ranks = pickle.load(f)
    print(f"  four ranks under gloo on the one card ({smi}): "
          f"{time.perf_counter() - t1:.1f} s, spawn included")
    print_probe(ranks[0]["probe"])
    r0 = ranks[0]
    print(f"  10c: prefill {SHARD_PREFILL} on the replicated path's routing"
          f": at cf {MOE_DROPLESS_CF} neither path drops; hidden states "
          f"against the replicated path's: mean difference "
          f"{r0['hidden']['mean_err']:.5f}, largest "
          f"{r0['hidden']['max_err']:.4f}, {r0['hidden']['beyond']} of "
          f"{r0['hidden']['entries']} beyond the bf16 elementwise bound; at "
          f"the config's cf "
          f"{MOE_CF} expert parallel drops "
          f"{r0[f'prefill_cf{MOE_CF}']['dropped']:.5f} of "
          f"assignments, the replicated path {drops[MOE_CF]:.5f}"
          f"; {MOE_DECODE_STEPS} decode steps' logits within the spread "
          f"and their top tokens the same or near-ties (largest difference "
          f"{r0['decode']['max_err']:.4f})")
    tw = r0["hidden_f32"]
    print(f"  10c witness: the f32 twin of that prefill at cf "
          f"{MOE_DROPLESS_CF} on its own routing against the replicated "
          f"path's f32 twin: mean difference {tw['mean_err']:.3e}, largest "
          f"{tw['max_err']:.3e}, none beyond the bf16 elementwise bound")
    for cf in (MOE_DROPLESS_CF, MOE_CF):
        print_rank_readings(f"10c prefill cf {cf}",
                            [r[f"prefill_cf{cf}"] for r in ranks],
                            "forward")
    print_rank_readings("10c decode step", [r["decode"] for r in ranks],
                        "decode step")
    del weights, ref_hidden, hidden32, logits
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run_sharded_path(dev, smi: str, dense_cfg=None, moe_cfg=None) -> dict:
    """Phase 10 (the configs may be narrowed for a rehearsal). Returns
    rank 0's readings of the 10a prefill."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    dense_cfg = dense_cfg or get_config("tinyllama_1_1b")
    moe_cfg = moe_cfg or dataclasses.replace(
        get_config("qwen3_moe_235b_a22b"), n_layers=2)
    print(f"  reduced: {moe_cfg.name} at {moe_cfg.n_layers} of 94 layers")
    with tempfile.TemporaryDirectory() as tmp:
        prefill = run_sharded_dense(dense_cfg, dev, smi, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        run_sharded_moe(moe_cfg, dev, smi, tmp)
    return prefill


# ---------------------------------------------------------------------------
# Phase 11: the cost tools
# ---------------------------------------------------------------------------

#: 11a: (arch, shape, mesh) run through ``python -m repro_torch.launch.dryrun``
DRYRUN_CELLS = (("tinyllama-1.1b", "decode_32k", "both"),
                ("rwkv6-3b", "long_500k", "single"),
                ("tinyllama-1.1b", "long_500k", "single"))
#: 11c: how far the memory estimate may lie from the card's reading
MEMORY_RATIO = 2.0


def roofline_line(rec: dict) -> str:
    rf = rec["roofline"]
    return (f"compute {rf['compute_s']:.3e} s, memory {rf['memory_s']:.3e} "
            f"s, collective {rf['collective_s']:.3e} s: {rf['bound']}-bound, "
            f"step {rf['step_time_s']:.3e} s; "
            f"{rec['cost']['flops_per_device']:.4g} FLOPs, "
            f"{rec['cost']['bytes_per_device']:.4g} HBM bytes, "
            f"{sum(rec['collectives_per_device'].values()):.4g} collective "
            f"bytes a device; 6ND/counted "
            f"{rec['model_flops_ratio']:.3f}; peak estimate "
            f"{rec['memory']['peak_estimate_per_device'] / 1e9:.2f} GB a "
            f"device; counted in {rec['count_s']} s")


def run_dryrun_cells(tmp: str) -> None:
    """11a: the dry run's command line in subprocesses on this machine's
    torch (its fake process group is a private module of torch: a missing
    one fails here), every record read back."""
    import json
    import os

    from repro_torch.configs import ARCH_ALIASES, get_config
    from repro_torch.models.config import SHAPE_BY_NAME, shape_applicable
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", tmp], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch, shape, mesh in DRYRUN_CELLS]
    for (arch, shape, mesh), proc in zip(DRYRUN_CELLS, procs):
        out, err = proc.communicate(timeout=600)
        require(proc.returncode == 0, f"11a: the dry run of {arch} {shape} "
                f"{mesh} failed: {out[-1500:]} {err[-1500:]}")
        name = ARCH_ALIASES[arch]
        for tag in (("single", "multi") if mesh == "both" else (mesh,)):
            with open(Path(tmp) / f"{name}_{shape}_{tag}.json") as f:
                rec = json.load(f)
            skip = shape_applicable(get_config(name), SHAPE_BY_NAME[shape])
            if skip:
                require(rec == {"arch": name, "shape": shape, "mesh": tag,
                                "status": "skip", "reason": skip},
                        f"11a: {name} {shape} {tag}: {rec}")
                print(f"  11a {name} {shape} {tag}: skip, {skip}")
                continue
            require(rec["status"] == "ok", f"11a: {name} {shape} {tag}: "
                    f"{rec.get('error')}")
            require(rec["chips"] == (512 if tag == "multi" else 256)
                    and rec["cost"]["flops_per_device"] > 0,
                    f"11a: {name} {shape} {tag}: {rec}")
            print(f"  11a {name} {shape} {tag} ({rec['chips']} GPUs, plan "
                  f"{rec['plan']}): {roofline_line(rec)}")


def count_sharded_prefill(cfg, measured: dict) -> None:
    """11b: phase 10a's prefill (the serve plan on 2x2, the engine's bf16
    copy of rank 0's blocks, 8 x 512 tokens) counted on meta tensors under
    a fake world of 4: its collectives must equal what rank 0 moved."""
    import torch

    from repro_torch.core.relshard import plan_model
    from repro_torch.launch import hlo_cost
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.models import lm
    from repro_torch.models import sharding as sh
    from repro_torch.models.config import ShapeConfig
    with fake_world(SHARD_WORLD):
        mesh = sh.Mesh(shard_axes(2, 2), device="meta")
        shape = ShapeConfig("serve", SHARD_PROMPT + SHARD_NEW, SHARD_SLOTS,
                            "decode")
        plan = plan_model(cfg, shard_axes(2, 2), shape, fsdp=False)
        weights = lm.cast_params(lm.shard_params(
            lm.init_params(cfg, device="meta"), cfg, plan, mesh))
        tokens = torch.empty(SHARD_PREFILL, dtype=torch.int32, device="meta")

        def prefill(w, t):
            with torch.no_grad():
                return lm.prefill(w, cfg, plan, mesh, t)
        _, s, mem = hlo_cost.count(prefill, weights, tokens, mesh=mesh)
    want_calls = {hlo_cost._KIND_NAMES[k]: n
                  for k, n in measured["calls"].items() if n}
    want_bytes = {hlo_cost._KIND_NAMES[k]: float(n)
                  for k, n in measured["bytes"].items() if n}
    require(s.collective_calls == want_calls
            and s.collective_wire_bytes == want_bytes,
            f"11b: counted {s.collective_calls} calls, "
            f"{s.collective_wire_bytes} bytes; rank 0 moved {want_calls}, "
            f"{want_bytes}")
    print(f"  11b {cfg.name} prefill {SHARD_PREFILL} on 2x2 counted on meta "
          f"under a fake world of {SHARD_WORLD}: collectives "
          + ", ".join(f"{k} {s.collective_calls[k]} calls "
                      f"{s.collective_wire_bytes[k]:.0f} B"
                      for k in s.collective_calls)
          + " = phase 10a's rank 0 exactly; "
          f"{s.flops:.4g} FLOPs, {s.bytes_accessed:.4g} HBM bytes a rank; "
          f"memory estimate: arguments {mem.argument_bytes / 1e9:.3f} GB, "
          f"outputs {mem.output_bytes / 1e9:.4f}, temp "
          f"{mem.temp_bytes / 1e9:.3f}, peak {mem.peak_estimate / 1e9:.3f} "
          f"GB beside phase 10a's measured peak a rank "
          f"{measured['peak'] / 1e9:.2f} GB (the engine's whole drain: its "
          f"weights, cache and the prefill)")


def count_meta_and_card(dev, smi: str) -> None:
    """11c: tinyllama-1.1b's prefill at 8 x 512 and its decode step at
    batch 8 (phase 7's plan, one device, no mesh) counted on meta and on
    the card's tensors by the same mode: FLOPs equal, the card's memory
    rise over the prefill within ``MEMORY_RATIO`` of the estimate, and
    the roofline's step beside CUDA-event times."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.relshard import plan_model
    from repro_torch.launch import hlo_cost
    from repro_torch.launch.roofline import roofline_from_counts
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig
    cfg = get_config("tinyllama_1_1b")
    batch, max_seq = 8, 256
    plan = plan_model(cfg, LM_MESH, ShapeConfig("serve", max_seq, batch,
                                                "decode"), fsdp=False)
    gen = torch.Generator().manual_seed(11)
    host = torch.randint(0, cfg.vocab, SHARD_PREFILL, generator=gen,
                         dtype=torch.int32)

    def prefill(w, t):
        with torch.no_grad():
            return lm.prefill(w, cfg, plan, None, t)

    def decode(w, t, cache):
        with torch.no_grad():
            return lm.decode_step(w, cfg, plan, None, t, cache)

    counts = {}
    for where in ("meta", dev):
        weights = lm.cast_params(lm.init_params(cfg, seed=0, device=where),
                                 where)
        tokens = host.to(where)
        tok8 = tokens[:, :1].contiguous()
        cache = lm.init_cache(cfg, batch, max_seq, device=where)
        cache["pos"].fill_(max_seq // 2)
        if where is dev:
            synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
        logits, s, mem = hlo_cost.count(prefill, weights, tokens)
        if where is dev:
            synchronize(dev)
            rise = torch.cuda.max_memory_allocated(dev) - before
            require(torch_isfinite(logits), "11c: prefill logits not finite")
        del logits
        _, sd, memd = hlo_cost.count(decode, weights, tok8, cache)
        counts[str(where)] = (s, mem, sd, memd)
        if where is not dev:
            continue
        pre_ms = cuda_ms(lambda: prefill(weights, tokens), reps=3)
        dec_ms = cuda_ms(lambda: decode(weights, tok8, cache), reps=10)
        del weights, cache
        torch.cuda.empty_cache()
    (s_m, mem_m, sd_m, _), (s_c, mem_c, sd_c, _) = counts["meta"], \
        counts[str(dev)]
    require(s_m.flops == s_c.flops and sd_m.flops == sd_c.flops,
            f"11c: FLOPs on meta {s_m.flops}, {sd_m.flops} against the "
            f"card's tensors {s_c.flops}, {sd_c.flops}")
    made = mem_m.output_bytes + mem_m.temp_bytes
    require(made / MEMORY_RATIO <= rise <= made * MEMORY_RATIO,
            f"11c: the prefill's memory rise on the card {rise} B against "
            f"an estimate of {made} B (outputs and temp)")
    print(f"  11c {cfg.name}, one device: prefill {SHARD_PREFILL} "
          f"{s_m.flops:.6g} FLOPs on meta = {s_c.flops:.6g} on the card's "
          f"tensors; decode step, batch {batch}: {sd_m.flops:.6g} = "
          f"{sd_c.flops:.6g}; HBM bytes counted on meta / on the card: "
          f"prefill {s_m.bytes_accessed:.6g} / {s_c.bytes_accessed:.6g}, "
          f"decode {sd_m.bytes_accessed:.6g} / {sd_c.bytes_accessed:.6g}")
    print(f"  11c prefill memory ({smi}): estimate of what the call makes "
          f"(outputs {mem_m.output_bytes / 1e6:.1f} MB + temp "
          f"{mem_m.temp_bytes / 1e6:.1f} MB) {made / 1e6:.1f} MB against "
          f"max_memory_allocated's rise over the call {rise / 1e6:.1f} MB "
          f"(ratio {rise / made:.3f}); the same counted on the card's "
          f"tensors {(mem_c.output_bytes + mem_c.temp_bytes) / 1e6:.1f} MB; "
          f"peak estimate with the arguments {mem_m.peak_estimate / 1e9:.3f}"
          f" GB")
    for label, summary, ms in (("prefill", s_m, pre_ms),
                               (f"decode step, batch {batch}", sd_m,
                                dec_ms)):
        rf = roofline_from_counts(summary, 1)
        print(f"  11c {label}: roofline step {rf.step_time_s() * 1e3:.3f} "
              f"ms ({rf.bound}-bound: compute {rf.compute_s * 1e3:.3f}, "
              f"memory {rf.memory_s * 1e3:.3f} ms) beside {ms:.3f} ms by "
              f"CUDA events ({smi})")


def run_cost_tools(dev, smi: str, prefill_10a: dict) -> None:
    """Phase 11; no kernel of K1-K7 may launch."""
    import tempfile

    from repro_torch.configs import get_config
    with tempfile.TemporaryDirectory() as tmp:
        run_dryrun_cells(tmp)
    count_sharded_prefill(get_config("tinyllama_1_1b"), prefill_10a)
    count_meta_and_card(dev, smi)


def ptxas_usage(report: str):
    """(kernel, "registers, spills, shared memory") for each entry function
    in ``nvcc -Xptxas -v`` output. Kernel names are the last component of
    their mangled names; dynamic shared memory is set at launch and is not
    in the report."""
    def name(sym):
        i, last = (3 if sym.startswith("_ZN") else 2), sym
        while i < len(sym) and sym[i].isdigit():
            j = i
            while j < len(sym) and sym[j].isdigit():
                j += 1
            last, i = sym[j:j + int(sym[i:j])], j + int(sym[i:j])
        # Template arguments that are integer or bool constants
        # (``ILi8ELi3ELb1EE``), so that instantiations tell apart.
        targs = re.match(r"I((?:L[a-z]n?\d+E)+)E", sym[i:])
        if targs:
            last += "<" + ",".join(re.findall(r"L[a-z](n?\d+)E",
                                              targs.group(1))) + ">"
        return last

    kernel, spills = "?", ""
    for line in report.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            kernel = name(line.split("'")[1])
        elif "spill stores" in line:
            spills = line
        elif line.startswith("ptxas info") and "Used" in line:
            yield kernel, f"{line.split(':', 1)[1].strip()}; {spills}"


@contextlib.contextmanager
def phase(title: str):
    """Print a phase's title, and its wall time when it ends."""
    print(f"== {title}")
    t0 = time.perf_counter()
    yield
    print(f"  phase wall time: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scale", type=float, default=30.0,
                        help="main-path catalog scale (default 30)")
    parser.add_argument("--save-inputs", type=Path, default=None,
                        help="save the bitonic sort's, the bloom build's "
                             "and key_range's timed inputs here "
                             "(torch.save)")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    smi = nvidia_smi()
    with phase("1. environment"):
        print(smi)
        print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}")
        nvcc = build.find_nvcc()
        version = subprocess.run([nvcc, "--version"], capture_output=True,
                                 text=True, check=True).stdout
        print(" ".join(line.strip() for line in version.splitlines()
                       if "release" in line or line.startswith("Build")))

    with phase("2. build"):
        t0 = time.perf_counter()
        build.library()
        print(f"  built {', '.join(s.name for s in build.sources())} in "
              f"{time.perf_counter() - t0:.1f} s "
              f"(cached={build.build_log['cached']})")
        for src, report in build.build_log.get("ptxas", {}).items():
            for kernel, usage in ptxas_usage(report):
                print(f"  {src} {kernel}: {usage}")

    with phase("3. kernels against their plain versions"):
        check_kernels_edge_cases(dev)
        check_filter_kernels_edge_cases(dev)
        check_move_rows_edge_cases(dev)

    with phase("4. main path"):
        catalog = make_catalog(dev, args.scale, p=8)
        launches, calls = run_main_path(catalog)
        print("  kernel timings at the main path's largest inputs "
              f"({smi}):")
        rows = measure_kernels(calls, launches)
        _, sort_args, _ = calls["bitonic_sort_tile"]

    with phase("5. runtime filters"):
        launches, calls = run_filter_path(catalog)
        print("  filter kernel timings at the filter path's largest inputs "
              f"({smi}):")
        rows += measure_filter_kernels(calls, launches)
        if args.save_inputs is not None:
            _, bloom_args, kw = calls["bloom_build"]
            _, range_args, _ = calls["key_range"]
            args.save_inputs.parent.mkdir(parents=True, exist_ok=True)
            torch.save({"sort": [a.cpu() for a in sort_args],
                        "bloom": [a.cpu() for a in bloom_args],
                        "m_bits": kw["m_bits"], "k": kw["k"],
                        "range": [a.cpu() for a in range_args]},
                       args.save_inputs)
            print(f"  saved the timed sort, build and key_range inputs to "
                  f"{args.save_inputs}")

    with phase("5b. reordering and the hypercube"):
        launches, calls = run_reorder_path(catalog)
        print("  tiled_probe3 timing at the reorder path's largest input "
              f"({smi}):")
        rows += measure_probe3(calls, launches)

    with phase("5c. the text-only and skew-target suites"):
        run_text_path(catalog)

    with phase("5d. skew, re-optimization and verification"):
        launches, (dest, valid, nd) = run_skew_path(catalog, dev,
                                                    args.scale)
        print("  partition_hist timing at hot_fine_buckets' largest input "
              f"({smi}):")
        rows.append(measure_hist(dest, nd, valid,
                                 launches["partition_hist"]))
        report_kernels(rows[-1:])

    with phase("5e. the query service and the nested-loop joins"):
        run_service_path(catalog)

    with phase("5f. the distributed twins"):
        run_twins_path(catalog, smi)
        del catalog

    with phase("6. cross-checks"):
        from repro_torch.sql import generate
        from repro_torch.sql import plan_analysis, service
        small = generate(0.1, 4, 42, device=dev)
        check_golden(small)
        check_filters_against_cpu(small)
        check_gather_path(dev)
        t0 = time.perf_counter()
        code = plan_analysis.main(["--scale", "0.05", "--p", "4",
                                   "--seed", "42"])
        require(code == 0, "plan_analysis.main reported violations")
        print(f"  plan_analysis.main on the card: 0 violations in "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        require(service.main([]) == 0, "service.main failed")
        print(f"  service.main on the card: 0 failures in "
              f"{time.perf_counter() - t0:.1f} s")
        del small

    with phase("7. LM serving"):
        run_lm_path(dev, smi)

    with phase("8. LM families: MoE, hybrid and RWKV-6"):
        run_lm_families(dev, smi)

    with phase("9. training"):
        run_training(dev, smi)

    with phase("10. sharded LM paths, four ranks on the one card"):
        from repro_torch.kernels import ops
        ops.reset_launch_counts()
        prefill_10a = run_sharded_path(dev, smi)
        require(not any(ops.launch_counts().values()),
                "phase 10 launched a kernel of K1-K7")

    with phase("11. the cost tools"):
        ops.reset_launch_counts()
        run_cost_tools(dev, smi, prefill_10a)
        require(not any(ops.launch_counts().values()),
                "phase 11 launched a kernel of K1-K7")
        print("  kernel launches in phase 11: none of K1-K7")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "device_cold_ms", "shape")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
