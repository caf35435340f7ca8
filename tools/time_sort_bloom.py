#!/usr/bin/env python3
"""Time one tree's bitonic sort (K3), bloom build (K4) and key_range (K6) on
one NVIDIA card.

    python3 chip_smoke.py --save-inputs build/sort_bloom_inputs.pt
    python3 tools/time_sort_bloom.py --src OTHER/src \
        --inputs build/sort_bloom_inputs.pt
    python3 tools/time_sort_bloom.py --range-sweep

``--src`` is the ``src`` directory of any tree of the port (this tree's by
default); its kernels build into that tree's ``build/``. The inputs are the
ones ``chip_smoke.py`` timed the kernels at on the main path and the
filter path. The readings are ``chip_smoke.sort_bloom_kernel_times``: at
the path's input, four times it, n = 4,096 (K3, K4) and a fixed-cost input,
the events around back-to-back wrapper calls, the device time back to back
and with L2 emptied, and the device activities a call. It prints the card's
name and power limit, then one JSON line. To compare two trees, run it on
each in turns (one, other, other, one) on one card.

``--range-sweep`` times this tree's key_range with each branch forced (its
code passed straight to the C entry point) at key counts from 90 to 2^22,
half of them valid: the readings that set ``zone_map.ONE_BLOCK_KEYS``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: Key counts of the branch sweep.
SWEEP_N = (90, 1024, 4096, 8192, 10_240, 12_288, 16_384, 32_768, 65_536,
           131_072, 262_144, 524_288, 1 << 20, 1 << 22)


def range_sweep(chip_smoke) -> dict:
    """Device ms (back to back) of key_range at each ``SWEEP_N`` with each
    branch forced, each result checked against the plain version."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.build import check, library
    from repro_torch.kernels.launch import workspace
    from repro_torch.kernels.zone_map import RANGE_BRANCHES

    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    ws = workspace(torch.device("cuda", torch.cuda.current_device()),
                   stream, 2)
    out = {}
    for n in SWEEP_N:
        keys = torch.randint(-(2 ** 31), 2 ** 31 - 1, (n,), device="cuda",
                             dtype=torch.int32, generator=gen)
        valid = torch.rand(n, device="cuda", generator=gen) < 0.5
        want = ref.key_range_ref(keys, valid)
        res = torch.empty(2, dtype=torch.int32, device="cuda")
        row = {}
        for code, branch in enumerate(RANGE_BRANCHES):
            def call(code=code):
                check(library().repro_key_range(
                    keys.data_ptr(), valid.data_ptr(), n, code,
                    ws.data_ptr(), res.data_ptr(), stream), "key_range")
            call()
            chip_smoke.require(torch.equal(res, want),
                               f"key_range {branch} at n={n}")
            row[branch] = chip_smoke.device_ms(call, 100)
        out[n] = row
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the src directory of the tree to time")
    parser.add_argument("--inputs", type=Path, default=None,
                        help="the file chip_smoke.py --save-inputs wrote")
    parser.add_argument("--range-sweep", action="store_true",
                        help="time this tree's key_range branches forced")
    args = parser.parse_args()
    if (args.inputs is None) == (not args.range_sweep):
        parser.error("give --inputs or --range-sweep")

    import torch
    if not torch.cuda.is_available():
        print("time_sort_bloom: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # puts this tree's src on sys.path; the next line wins
    if args.range_sweep:
        import repro_torch
        print(chip_smoke.nvidia_smi())
        print(json.dumps({"src": str(Path(repro_torch.__file__).parents[1]),
                          "key_range_branches": range_sweep(chip_smoke)}))
        return 0
    sys.path.insert(0, str(args.src.resolve()))
    import repro_torch
    from repro_torch.kernels import build

    build.library()
    saved = torch.load(args.inputs)
    k, v = (a.cuda() for a in saved["sort"])
    keys, valid = (a.cuda() for a in saved["bloom"])
    rk, rv = (a.cuda() for a in saved["range"])
    times = chip_smoke.sort_bloom_kernel_times(k, v, keys, valid,
                                               saved["m_bits"], saved["k"],
                                               rk, rv)
    print(chip_smoke.nvidia_smi())
    print(json.dumps({"src": str(Path(repro_torch.__file__).parents[1]),
                      **times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
