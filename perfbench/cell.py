"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name in ``BENCHMARK.json``:
``configs/<config>.json``, ``mixes/<traffic>.json`` with the
``queries/<template>.json`` it names, ``metrics/<metric>.py`` and
``limits/<workload>.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import compare, datagen
from perfbench.reference.evaluate import evaluate
from perfbench.traffic import Instance, Mix

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Record:
    """One query of the window."""

    client: int
    instance: Instance
    submitted: float
    plan_s: float
    latency_s: float = math.nan
    ok: bool = False
    wall_time_s: float = 0.0
    network_bytes: float = 0.0
    answer: Optional[Dict[str, np.ndarray]] = None
    error: str = ""


@dataclasses.dataclass
class Context:
    """What a per-layer reader (``metrics/<name>.py``) reads."""

    records: List[Record]
    stats_before: dict
    stats_after: dict
    launched: Dict[str, int]
    tracer: object = None
    paired: Dict[str, bool] = dataclasses.field(default_factory=dict)

    def roofline(self, kernel: str, device_names, exclusive_of=()):
        """Percent of the roofline: the launches' least time over the
        device time of ``device_names``' activities. Nothing to read where
        no launch was traced, or where a kernel in ``exclusive_of`` ran too
        and shares those names."""
        from perfbench.roofline import least_seconds
        t = self.tracer
        if t is None or any(self.launched.get(k) for k in exclusive_of):
            return None
        works = t.launches.get(kernel) or []
        device = t.kernel_seconds(device_names)
        if self.paired.get(kernel):
            if len(device) != t.counts.get(kernel, -1):
                return None
            device = device[:len(works)]
        if not works or not sum(device):
            return None
        return 100.0 * sum(least_seconds(*w) for w in works) / sum(device)


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_spec(bench: dict, workload: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]]


def _in_cell(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_reader(name: str, root: Path = HERE):
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_strategy(names):
    """``["FilteredStrategy", "RelJoinStrategy"]`` -> the outer strategy
    wrapping the inner; a wrapper that takes a filter cache gets a fresh
    one, which the service then shares across each batch."""
    from repro_torch.sql import strategies
    from repro_torch.sql.runtime_filters import FilterCache

    made = None
    for name in reversed(names):
        cls = getattr(strategies, name)
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        if made is not None:
            kw["inner"] = made
        if "cache" in fields:
            kw["cache"] = FilterCache()
        made = cls(**kw)
    return made


def fetch(table) -> Dict[str, np.ndarray]:
    """The valid rows of a result table, as host numpy columns."""
    idx = torch.nonzero(table.valid.reshape(-1)).squeeze(1)
    return {n: c.reshape(-1).index_select(0, idx).cpu().numpy()
            for n, c in table.columns.items()}


def limits(workload: str, root: Path = HERE) -> dict:
    return json.loads((root / "limits" / f"{workload}.json").read_text())


class Cell:
    """The program and the benchmark's inputs for one configuration, mix and
    seed. ``factor`` shrinks the tables (a smaller copy for tests on the
    CPU)."""

    def __init__(self, config: dict, mix: Mix, seed: int, *, device="cuda",
                 factor: float = 1.0):
        from repro_torch.sql.planner import catalog_schema
        from repro_torch.sql.service import QueryService

        self.seed = int(seed)
        self.config, self.mix = config, mix
        self.device = torch.device(device)
        t0 = time.perf_counter()
        self.tables = datagen.base_tables(config, self.seed, self.device,
                                          factor)
        self.sync()
        t1 = time.perf_counter()
        catalog = datagen.catalog(self.tables, config["p"],
                                  datagen.key_domains(config, factor))
        self.service = QueryService(
            catalog, strategy=build_strategy(config["strategy"]),
            adaptive=config["adaptive"], verify=config["verify"])
        self._schema = catalog_schema(catalog)
        self.sync()
        #: Seconds of each part of the set-up.
        self.timings = {"tables_s": t1 - t0,
                        "catalog_s": time.perf_counter() - t1}
        self._qn = 0

    @classmethod
    def named(cls, config: str, traffic: str, seed: int, **kw) -> "Cell":
        """The cell of configuration ``config`` under mix ``traffic``, by
        their names (``configs/<config>.json``, ``mixes/<traffic>.json``)."""
        doc = json.loads((HERE / "configs" / f"{config}.json").read_text())
        return cls(doc, Mix.load(traffic, HERE), seed, **kw)

    @classmethod
    def for_workload(cls, workload: str, seed: int, *, root: Path,
                     **kw) -> "Cell":
        spec, cfg_entry = cell_spec(load_benchmark(root), workload)
        doc = json.loads((root / cfg_entry["file"]).read_text())
        return cls(doc, Mix.load(spec["traffic"], HERE), seed, **kw)

    def submit(self, sql: str, name: str):
        """Parse and bind ``sql`` against the catalog's own tables (the
        service's ``submit`` binds text against the program's synthetic
        schema alone), then submit the plan."""
        from repro_torch.sql.binder import parse_sql

        plan = parse_sql(sql, self._schema, self.service.catalog.key_domains)
        return self.service.submit(plan, name=name)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_up(self) -> None:
        """Each template once, alone, with each parameter at the middle of
        its domain, then one round of every client's first query as the
        window sends it; each answer fetched as the window fetches it."""
        t0 = time.perf_counter()
        rounds = [[inst] for inst in self.mix.first_instances()]
        rounds.append([next(s) for s in self.mix.streams(self.seed)])
        for insts in rounds:
            for i, inst in enumerate(insts):
                self.submit(inst.sql, f"warm.{i}")
            for rep in self.service.run():
                for res in rep.results.values():
                    fetch(res.table)
        self.sync()
        self.timings["warm_up_s"] = time.perf_counter() - t0

    def window(self, seconds: float, tracer=None) -> tuple:
        """The closed loop for ``seconds``: each round every client submits
        its next query and ``QueryService.run`` drains the queue. Returns
        (records, window seconds)."""
        def span(label):
            return contextlib.nullcontext() if tracer is None \
                else tracer.span(label)

        streams = self.mix.streams(self.seed)
        records: List[Record] = []
        t_open = time.perf_counter()
        deadline = t_open + seconds
        while True:
            subs = []
            with span("perfbench.submit"):
                for c, stream in enumerate(streams):
                    inst = next(stream)
                    t0 = time.perf_counter()
                    name = f"q{self._qn}"
                    self._qn += 1
                    rec = Record(c, inst, t0, 0.0)
                    try:
                        subs.append((name, self.submit(inst.sql, name),
                                     rec))
                    except Exception as e:  # a query that fails counts
                        rec.error = repr(e)
                    rec.plan_s = time.perf_counter() - t0
                    records.append(rec)
            with span("perfbench.run"):
                try:
                    reports = self.service.run()
                    error = ""
                except Exception as e:  # the whole round fails
                    self.service.admission.queue.clear()
                    reports, error = [], repr(e)
                self.sync()
            t_done = time.perf_counter()
            results = {}
            for rep in reports:
                results.update(rep.results)
            del reports
            with span("perfbench.fetch"):
                for name, _, rec in subs:
                    res = results.get(name)
                    if res is None:
                        rec.error = error or "no result returned"
                        continue
                    rec.latency_s = t_done - rec.submitted
                    rec.ok = True
                    rec.wall_time_s = res.wall_time_s
                    rec.network_bytes = res.network_bytes
                    rec.answer = fetch(res.table)
            del results
            if t_done >= deadline:
                break
        return records, t_done - t_open

    def free_program(self) -> None:
        """Drop the program's state (catalog, caches, intermediates) so
        that the reference runs on the inputs alone."""
        self.service = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, records: List[Record], control=None) -> dict:
        """Compare a seeded sample of the window's answers with the
        reference: every template that completed once, the slowest query's
        instance, and more distinct instances up to the mix's ``check``.
        ``control`` (a torch dtype) puts the reference computed in that
        precision in the program's place."""
        rng = np.random.default_rng([self.seed % (1 << 64), 0xC4EC])
        done = [r for r in records if r.ok]
        keys = []
        by_template: Dict[str, list] = {}
        for r in done:
            by_template.setdefault(r.instance.template.name, []).append(r)
        if done:
            keys.append(max(done, key=lambda r: r.latency_s).instance.key)
        for name in sorted(by_template):
            rs = by_template[name]
            keys.append(rs[rng.integers(len(rs))].instance.key)
        distinct = sorted({r.instance.key for r in done}, key=repr)
        for i in rng.permutation(len(distinct)):
            keys.append(distinct[i])
        chosen = list(dict.fromkeys(keys))[:max(self.mix.check, 1)]
        instances = {r.instance.key: r.instance for r in done}
        wrong, worst, compared, why = 0, 0.0, 0, []
        by_gap: Dict[str, float] = {}
        worst_at = ""
        for key in chosen:
            inst = instances[key]
            ref = compare.relation_to_numpy(evaluate(inst.plan, self.tables))
            if control is not None:
                got = compare.relation_to_numpy(
                    evaluate(inst.plan, self.tables, dtype=control))[0]
                answers = [got]
            else:
                answers = [r.answer for r in done if r.instance.key == key]
            for ans in answers:
                same, g, what = compare.gap(ans, ref)
                compared += 1
                if not same:
                    wrong += 1
                    why.append(f"{key[0]} {dict(key[1])}: {what}")
                else:
                    if g > worst:
                        worst_at = f"{key[0]} {dict(key[1])}: {what}"
                    worst = max(worst, g)
                    by_gap[key[0]] = max(by_gap.get(key[0], 0.0), g)
        return {"compared": compared, "instances": len(chosen),
                "wrong": wrong, "gap": worst, "why": why[:5],
                "gaps": by_gap, "worst_at": worst_at}


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        root: Path, t_start: float, device="cuda",
        factor: float = 1.0) -> dict:
    """One run of ``workload``: returns the result line's object, checks
    last."""
    from repro_torch.kernels import ops

    t_cell = time.perf_counter()
    bench = load_benchmark(root)
    cell = Cell.for_workload(workload, seed, root=root, device=device,
                             factor=factor)
    cell.warm_up()
    setup_s = time.perf_counter() - t_start

    per_layer = [m for m in bench["per_layer"] if _in_cell(m, workload)]
    readers = {m["name"]: load_reader(m["name"]) for m in per_layer} \
        if trace else {}
    kernels = {r.KERNEL: r for r in readers.values() if hasattr(r, "KERNEL")}
    tracer = None
    if trace:
        from perfbench.trace import Tracer
        tracer = Tracer(kernels)
    stats_before = cell.service.stats()
    launched_before = ops.launch_counts()
    if tracer is not None:
        with tracer.window():
            records, window_s = cell.window(seconds, tracer)
    else:
        records, window_s = cell.window(seconds)
    launched = {k: v - launched_before[k]
                for k, v in ops.launch_counts().items()}
    stats_after = cell.service.stats()
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    if tracer is not None:
        tracer.resolve()
    cell.free_program()

    lim = limits(workload)
    result = cell.check(records)
    done = [r for r in records if r.ok]
    failed = len(records) - len(done)
    checks = {
        "failed_queries": {"value": failed, "limit": 0},
        "wrong_answers": {"value": result["wrong"], "limit": 0},
        "agg_gap": {"value": result["gap"], "limit": lim["agg_gap"]},
    }
    correct = (bool(done) and failed == 0 and result["wrong"] == 0
               and result["gap"] <= lim["agg_gap"])

    metrics = {}
    if not trace:
        lat = [r.latency_s for r in done]
        values = {
            "queries_per_s": len(done) / window_s,
            "query_p95_ms": 1e3 * percentile(lat, 95) if lat else None,
            "setup_s": setup_s,
        }
        for m in bench["end_to_end"]:
            if _in_cell(m, workload) and values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx = Context(records, stats_before, stats_after, launched,
                      tracer, {k: getattr(r, "PAIRED", False)
                               for k, r in kernels.items()})
        for m in per_layer:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    out = {"correct": correct, "attempted": len(records), "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if cell.device.type == "cuda"
                      else cell.device.type,
                      "kind": (torch.cuda.get_device_name(cell.device)
                               if cell.device.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if tracer is not None:
        out["device"]["busy_s"] = tracer.busy_s
        out["device"]["window_s"] = tracer.window_s
        out["breakdown"] = {"device_ops": tracer.device_ops(),
                            "idle_gaps": tracer.idle_gaps()}
    by_template: Dict[str, list] = {}
    for r in done:
        by_template.setdefault(r.instance.template.name, []).append(
            r.latency_s)
    out["info"] = {"window_s": window_s, "queries": len(done),
                   "template_ms": {t: [len(v), 1e3 * float(np.mean(v))]
                                   for t, v in sorted(by_template.items())},
                   "compared": result["compared"],
                   "instances_checked": result["instances"],
                   "launches": launched, "why_wrong": result["why"],
                   "gaps": result["gaps"], "worst_at": result["worst_at"],
                   "errors": sorted({r.error for r in records if r.error})[:5]}
    out["info"]["run_s"] = time.perf_counter() - t_start
    out["info"]["setup"] = {"before_cell_s": t_cell - t_start,
                            **cell.timings}
    out["checks"] = checks
    return out
