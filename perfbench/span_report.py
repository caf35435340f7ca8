"""Where the device waits, by the program's own spans: one traced window
of a cell, read by innermost ``rj.*`` span.

    python3 perfbench/span_report.py --workload sf1.adhoc --seed 7 \\
        --seconds 51 --out chiprun_out/spans_7.json

Runs the cell's set-up and window as ``run.py --trace 1`` does (the same
spans of ``spans.json`` around the layers, the same profiler), then
writes, beside the three per-layer metrics of the program's spans:

- ``idle_by_span``: the window's device-idle seconds by the innermost
  ``rj.*`` span the host was in (self time: a child span's part goes to
  the child), ``(none)`` where it was in none;
- ``syncs_by_site``: ``rj.sync.*`` events a query, by name;
- ``spans_per_query``: every ``rj.*`` event a query, and by name;
- ``syncs_per_batch``: the ``rj.sync.*`` events inside each ``rj.batch``,
  in order (a batch is one query in a cell of one client), for comparing
  two runs of one seed;
- ``blocking``: the runtime's blocking calls (``cudaStreamSynchronize``,
  ``cudaDeviceSynchronize``, device-to-host ``cudaMemcpyAsync``) inside
  ``rj.query`` spans, how many lie inside an ``rj.sync.*`` span, and the
  innermost span and host operation of each that does not;
- ``span_cost_us``: the host cost of one span's enter and exit while the
  profiler records, and of the shared no-op while it does not.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import program_spans as ps  # noqa: E402
from perfbench import run  # noqa: E402

BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
METRICS = ("host_syncs_per_query", "executor_busy_share",
           "selection_idle_ms")


def innermost_segments(spans):
    """Cut the timeline of nested ``(start, end, name)`` spans into
    ``(start, end, name)`` segments of the innermost span; the gaps
    between top-level spans are left out."""
    out = []
    stack = []  # (end, name)
    t = None
    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, name = stack.pop()
            if t < end:
                out.append((t, end, name))
            t = end
        if stack and t < s:
            out.append((t, s, stack[-1][1]))
        stack.append((e, n))
        t = s
    while stack:
        end, name = stack.pop()
        if t < end:
            out.append((t, end, name))
        t = end
    return out


def idle_by_span(tracer, spans):
    import numpy as np

    ws, we = tracer.window_ns
    busy = tracer.busy_intervals()
    segs = innermost_segments(spans)
    s = np.clip(np.asarray([x[0] for x in segs], np.int64), ws, we)
    e = np.clip(np.asarray([x[1] for x in segs], np.int64), ws, we)
    idle = (e - s) - (ps.busy_before(busy, e) - ps.busy_before(busy, s))
    total: dict = collections.Counter()
    for (_, _, name), v in zip(segs, idle.tolist()):
        total[name] += v / 1e9
    window_idle = (we - ws) / 1e9 - tracer.busy_s
    total["(none)"] = window_idle - sum(total.values())
    return dict(total.most_common())


def inside(intervals, t):
    """Whether ``t`` lies inside one of the sorted, disjoint
    ``intervals``."""
    i = bisect.bisect_right(intervals[0], t) - 1
    return i >= 0 and t <= intervals[1][i]


def label_at(segments, t):
    """The label of the innermost segment holding ``t``."""
    i = bisect.bisect_right(segments[0], t) - 1
    return segments[2][i] if i >= 0 and t <= segments[1][i] else "(none)"


def blocking_calls(events, spans):
    """Blocking runtime calls inside rj.query spans, and whether each lies
    inside an rj.sync.* span; the innermost span and host operation of
    each that does not."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    d2h = {ev.correlation_id() for ev in events
           if ev.device_type() == cuda and "DtoH" in ev.name()}
    query = _merged([(s, e) for s, e, n in spans if n == ps.QUERY])
    sync = _merged([(s, e) for s, e, n in spans if n.startswith(ps.SYNC)])
    own = _columns(innermost_segments(spans))
    ops = _columns(innermost_segments(
        [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
         for ev in events
         if ev.device_type() != cuda and ev.name().startswith("aten::")]))
    by_name: dict = collections.Counter()
    covered, uncovered = 0, collections.Counter()
    for ev in events:
        name = ev.name()
        if name == "cudaMemcpyAsync":
            name += " DtoH" if ev.correlation_id() in d2h else " other"
        elif name not in BLOCKING:
            continue
        t = ev.start_ns()
        if not inside(query, t):
            continue
        by_name[name] += 1
        if name == "cudaMemcpyAsync other":
            continue
        if inside(sync, t):
            covered += 1
        else:
            uncovered[f"{label_at(own, t)} > {label_at(ops, t)}"] += 1
    return {"calls": dict(by_name), "inside_sync": covered,
            "outside_sync": dict(uncovered.most_common())}


def _columns(segments):
    return ([x[0] for x in segments], [x[1] for x in segments],
            [x[2] for x in segments])


def _merged(pairs):
    import numpy as np

    from perfbench.trace import _union_ns

    if not pairs:
        return ([], [])
    s, e = _union_ns(np.asarray([p[0] for p in pairs], np.int64),
                     np.asarray([p[1] for p in pairs], np.int64))
    return (s.tolist(), e.tolist())


def span_cost_us(n=20000):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    t0 = time.perf_counter()
    for _ in range(n):
        with obs.span(obs.QUERY):
            pass
    off = (time.perf_counter() - t0) / n * 1e6
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        for _ in range(n):
            with obs.span(obs.QUERY):
                pass
        on = (time.perf_counter() - t0) / n * 1e6
    return {"off": off, "on": on}


def report(workload, seed, seconds, *, device="cuda", factor=1.0) -> dict:
    """One traced window of ``workload`` and its reading by span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench import cell
    from perfbench.trace import WINDOW, Tracer

    cuda = torch.device(device).type == "cuda"
    c = cell.Cell.for_workload(workload, seed, root=ROOT, device=device,
                               factor=factor)
    c.warm_up()
    tracer = Tracer({})
    tracer._install()
    try:
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
            with torch.profiler.record_function(WINDOW):
                records, _ = c.window(seconds, tracer)
            c.sync()
    finally:
        tracer._uninstall()
    tracer._read(prof)
    events = list(prof.profiler.kineto_results.events())
    ws, we = tracer.window_ns
    spans = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
             for ev in events
             if ev.device_type() != torch.autograd.DeviceType.CUDA
             and ev.name().startswith("rj.") and ws <= ev.start_ns() <= we]
    done = sum(r.ok for r in records)
    ctx = cell.Context(records, {}, {}, {}, tracer)
    names = collections.Counter(n for _, _, n in spans)
    batches = sorted((s, e) for s, e, n in spans if n == "rj.batch")
    sync_starts = sorted(s for s, _, n in spans if n.startswith(ps.SYNC))
    return {
        "workload": workload, "seed": seed,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "window_s": tracer.window_s, "busy_s": tracer.busy_s,
        "queries": done, "failed": len(records) - done,
        "metrics": {m: cell.load_reader(m).read(ctx) for m in METRICS},
        "idle_by_span": idle_by_span(tracer, spans),
        "syncs_by_site": {n: v / done for n, v in sorted(names.items())
                          if n.startswith(ps.SYNC)},
        "spans_per_query": {"all": len(spans) / done,
                            **{n: v / done for n, v in names.most_common()}},
        "syncs_per_batch": [bisect.bisect_right(sync_starts, e)
                            - bisect.bisect_left(sync_starts, s)
                            for s, e in batches],
        "blocking": blocking_calls(events, spans),
        "span_cost_us": span_cost_us(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    run._environment()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    out = report(args.workload, args.seed, args.seconds)
    out["run_s"] = time.perf_counter() - T_START
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    short = {k: v for k, v in out.items() if k != "syncs_per_batch"}
    print(json.dumps(short), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
