"""Quickstart: RelJoin in 60 seconds, on the port.

1. Build a tiny star schema, 2. run one query under every selection
strategy, 3. see why RelJoin picks what it picks (the k vs k0 criterion),
4. run a query straight from SQL text.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The twin of ``examples/quickstart.py``: the same catalog, queries and
printed rows, methods and bytes; it runs on the CUDA card unless
``--device`` names another.
"""

import argparse

from repro_torch.core import CostParams, k0_threshold
from repro_torch.sql import (Executor, all_queries, default_strategies,
                             generate, parse_sql)
from repro_torch.sql.logical import signature


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    catalog = generate(scale=0.1, p=8, seed=0, device=args.device)
    plan = all_queries()["q2_chain7"]  # the paper's q72-shaped chain
    params = CostParams(p=8, w=1.0)
    print(f"k0 threshold (p=8, w=1): {k0_threshold(params):.1f}\n")

    for strat in default_strategies():
        res = Executor(catalog, strat).execute(plan)
        methods = ",".join(m.value.replace("_", "")[:9]
                           for m in res.methods())
        print(f"{strat.name:16s} rows={res.rows:5d} "
              f"workload={res.workload() / 2 ** 20:8.1f}MB "
              f"net={res.network_bytes / 2 ** 20:6.2f}MB "
              f"wall={res.wall_time_s:5.2f}s  [{methods}]")

    print("\nRelJoin decisions (adaptive runtime statistics):")
    res = Executor(catalog, default_strategies()[-1]).execute(plan)
    for i, d in enumerate(res.decisions):
        k = (max(d.left_stats.size_bytes, d.right_stats.size_bytes)
             / max(min(d.left_stats.size_bytes, d.right_stats.size_bytes), 1))
        print(f"  join {i}: {d.selection.method.value:15s} k={k:8.1f} "
              f"({d.selection.reason})")

    print("\nSame engine, straight from SQL text:")
    plan = parse_sql("""
        SELECT s_state, SUM(ss_net_profit)
        FROM store_sales
        JOIN store ON ss_store_sk = s_store_sk
        JOIN (SELECT * FROM date_dim WHERE d_month = 11)
          ON ss_sold_date_sk = d_date_sk
        GROUP BY s_state
    """)
    print(f"  plan: {signature(plan)}")
    res = Executor(catalog, default_strategies()[-1]).execute(plan)
    print(f"  rows={res.rows} methods={[m.value for m in res.methods()]}")


if __name__ == "__main__":
    main()
