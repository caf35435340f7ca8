"""Full engine scenario on the port: the TPC-DS-shaped suite under all
four selection strategies, reporting the paper's headline numbers
(workload reduction, per-query winners, PSTS).

    PYTHONPATH=src python -m repro_torch.examples.reljoin_tpcds \\
        [--scale 0.3] [--p 8] [--device cpu]

The twin of ``examples/reljoin_tpcds.py``: the same catalog, queries and
printed workloads, wins and PSTS; it runs on the CUDA card unless
``--device`` names another.
"""

import argparse

from repro_torch.core import compute_psts
from repro_torch.sql import Executor, all_queries, default_strategies, generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.3)
    ap.add_argument("--p", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    catalog = generate(scale=args.scale, p=args.p, seed=0,
                       device=args.device)
    queries = all_queries()
    suites = {}
    for strat in default_strategies():
        rows = {}
        for q, plan in queries.items():
            rows[q] = Executor(catalog, strat).execute(plan)
        suites[strat.name] = rows
        tot = sum(r.workload() for r in rows.values())
        wall = sum(r.wall_time_s for r in rows.values())
        print(f"{strat.name:16s} total workload {tot/2**20:9.1f}MB  "
              f"wall {wall:6.1f}s")

    rel, aqe = suites["RelJoin(w=1)"], suites["AQE"]
    wins = sum(rel[q].workload() <= min(s[q].workload()
               for s in suites.values()) for q in queries)
    print(f"\nRelJoin best-or-tied on {wins}/{len(queries)} queries")
    rep = compute_psts(
        [m for q in queries for m in rel[q].methods()],
        [m for q in queries for m in aqe[q].methods()],
        sum(rel[q].workload() for q in queries),
        sum(aqe[q].workload() for q in queries))
    print(f"PSTS (workload, AQE baseline): {rep.psts:.2f} "
          f"(join diff {rep.pct_join_diff:.1f}%, "
          f"workload diff {rep.pct_time_diff:.1f}%)")


if __name__ == "__main__":
    main()
