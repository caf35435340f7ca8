"""Render the port's dry-run records (``experiments/dryrun_torch/*.json``,
written by ``repro_torch.launch.dryrun``) into the dry-run and roofline
tables.

    PYTHONPATH=src python -m repro_torch.launch.report > roofline.md
"""

from __future__ import annotations

import glob
import json
import os

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh: str):
    recs = {}
    for f in glob.glob(os.path.join(DRYRUN_DIR, f"*_{mesh}.json")):
        with open(f) as fh:
            r = json.load(fh)
        recs[(r["arch"], r["shape"])] = r
    return recs


def fmt_bytes(b):
    return f"{b / 2 ** 30:.2f}"


def dryrun_table(mesh: str) -> str:
    recs = load(mesh)
    lines = [
        f"### Mesh: {mesh} "
        f"({'2x16x16 = 512 GPUs' if mesh == 'multi' else '16x16 = 256 GPUs'})",
        "",
        "| arch | shape | status | plan (embed/head/moe) | GiB/dev (args+temp) "
        "| GFLOPs/dev | coll GiB/dev | count s |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape) in sorted(recs, key=lambda t: (t[0],
                                SHAPE_ORDER.index(t[1]))):
        r = recs[(arch, shape)]
        if r["status"] == "skip":
            lines.append(f"| {arch} | {shape} | SKIP(full-attention) | — | — "
                         f"| — | — | — |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {arch} | {shape} | **ERROR** "
                         f"| {r.get('error', '?')[:60]} | — | — | — | — |")
            continue
        plan = r["plan"]
        mem = r["memory"]
        coll = sum(r["collectives_per_device"].values())
        lines.append(
            f"| {arch} | {shape} | ok "
            f"| {plan['embed'][:5]}/{plan['head'][:5]}/{plan['moe'][:6]} "
            f"| {fmt_bytes(mem['argument_bytes_per_device'])}+"
            f"{fmt_bytes(mem['temp_bytes_per_device'])} "
            f"| {r['cost']['flops_per_device'] / 1e9:.0f} "
            f"| {fmt_bytes(coll)} | {r['count_s']} |")
    return "\n".join(lines)


def roofline_table() -> str:
    recs = load("single")
    lines = [
        "| arch | shape | compute s | memory s | collective s | bound "
        "| step s | roofline frac | 6ND/counted |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape) in sorted(recs, key=lambda t: (t[0],
                                SHAPE_ORDER.index(t[1]))):
        r = recs[(arch, shape)]
        if r["status"] != "ok":
            tag = ("SKIP" if r["status"] == "skip" else "ERROR")
            lines.append(f"| {arch} | {shape} | — | — | — | {tag} | — | — "
                         f"| — |")
            continue
        rf = r["roofline"]
        step = rf["step_time_s"]
        frac = rf["compute_s"] / step if step else 0
        lines.append(
            f"| {arch} | {shape} | {rf['compute_s']:.4f} "
            f"| {rf['memory_s']:.4f} | {rf['collective_s']:.4f} "
            f"| {rf['bound']} | {step:.4f} | {frac:.2f} "
            f"| {r['model_flops_ratio']:.2f} |")
    return "\n".join(lines)


def summary():
    recs_s, recs_m = load("single"), load("multi")
    ok_s = sum(r["status"] == "ok" for r in recs_s.values())
    sk_s = sum(r["status"] == "skip" for r in recs_s.values())
    er_s = sum(r["status"] == "error" for r in recs_s.values())
    ok_m = sum(r["status"] == "ok" for r in recs_m.values())
    sk_m = sum(r["status"] == "skip" for r in recs_m.values())
    er_m = sum(r["status"] == "error" for r in recs_m.values())
    return (f"single-pod: {ok_s} ok / {sk_s} skip / {er_s} error; "
            f"multi-pod: {ok_m} ok / {sk_m} skip / {er_m} error "
            f"(of 40 cells each)")


def main():
    print("## Dry-run summary\n")
    print(summary(), "\n")
    print(dryrun_table("single"), "\n")
    print(dryrun_table("multi"), "\n")
    print("## Roofline (single-pod, 256 GPUs)\n")
    print(roofline_table())


if __name__ == "__main__":
    main()
