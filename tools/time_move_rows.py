#!/usr/bin/env python3
"""Check and time the row mover (``repro_torch.kernels.move_rows``) on one
NVIDIA card.

    python3 tools/time_move_rows.py

First every case of ``chip_smoke.MOVE_CASES`` against the plain version,
bit for bit. Then, at the main path's shapes in ``sf1.adhoc`` (store_sales
at TPC-DS SF1 over p = 8 partitions, 23 columns: the exchange's
all-to-all, compaction, and the payload merge of an 18,000-row replica),
for each: the events around back-to-back wrapper calls (``ms``, host
launch cost included where it outlasts the device), the device time
alone, back to back (``device_ms``, ``chip_smoke.device_ms``), the bound
(the least bytes over 3.35e12 B/s: the index read once, each live row of
each column read once, every output slot and ``valid`` written once), the
plain version (``plain_ms``: the per-column ``torch.gather`` after one
clamp and int64 copy of the index, and in the exchange the transpose copy
of each column, as the port moved rows before the mover) and one
``torch.gather`` a column through a ready int64 index (``gather_loop_ms``).
It prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: The timed cases of ``chip_smoke.MOVE_CASES``.
TIMED = ("exchange_sf1", "compact_sf1", "merge_replica_outer")


def least_bytes(columns: dict, idx) -> float:
    """The mover's least traffic: the index once, each live row of each
    column read once, every output slot and ``valid`` written once."""
    slots = idx.numel()
    live = int((idx >= 0).sum())
    widths = sum(c.element_size() for c in columns.values())
    return slots * idx.element_size() + live * widths + slots * (widths + 1)


def time_case(cs, name: str, dev) -> dict:
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.move_rows import move_rows

    columns, idx, zero_fill = cs.move_rows_case(name, dev)
    safe = idx.clamp(min=0).to(torch.int64)

    def gather_loop():
        for c in columns.values():
            if c.dim() == 1:
                c[safe]
            else:
                torch.gather(c, 1, safe.reshape(c.shape[0], -1))

    kernel = lambda: move_rows(columns, idx, zero_fill=zero_fill)  # noqa
    plain = lambda: ref.move_rows_ref(columns, idx, zero_fill)  # noqa
    nbytes = least_bytes(columns, idx)
    row = dict(
        shape=f"idx {tuple(idx.shape)} {idx.dtype}, {len(columns)} columns "
              f"of {tuple(next(iter(columns.values())).shape)}",
        ms=cs.cuda_ms(kernel, 20), device_ms=cs.device_ms(kernel, 20),
        bound_ms=nbytes / cs.PEAK_BYTES_PER_S * 1e3, bytes=nbytes,
        plain_ms=cs.cuda_ms(plain, 10),
        plain_device_ms=cs.device_ms(plain, 10),
        gather_loop_ms=cs.cuda_ms(gather_loop, 10),
        gather_loop_device_ms=cs.device_ms(gather_loop, 10))
    print(f"  {name}: {row}")
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_move_rows: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    print(smi)
    cs.check_move_rows_edge_cases(dev)
    rows = {name: time_case(cs, name, dev) for name in TIMED}
    print(json.dumps({"device": smi, "move_rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
