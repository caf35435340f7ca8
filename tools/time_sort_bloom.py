#!/usr/bin/env python3
"""Time one tree's bitonic sort (K3) and bloom build (K4) on one NVIDIA card.

    python3 chip_smoke.py --save-inputs build/sort_bloom_inputs.pt
    python3 tools/time_sort_bloom.py --src OTHER/src \
        --inputs build/sort_bloom_inputs.pt

``--src`` is the ``src`` directory of any tree of the port (this tree's by
default); its kernels build into that tree's ``build/``. The inputs are the
ones ``chip_smoke.py`` timed the two kernels at on the main path and the
filter path. The readings are ``chip_smoke.sort_bloom_kernel_times``: at
the path's input, four times it, n = 4,096 and a fixed-cost input, the
events around back-to-back wrapper calls, the device time back to back and
with L2 emptied, and the device activities a call. It prints the card's
name and power limit, then one JSON line. To compare two trees, run it on
each in turns (one, other, other, one) on one card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the src directory of the tree to time")
    parser.add_argument("--inputs", type=Path, required=True,
                        help="the file chip_smoke.py --save-inputs wrote")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("time_sort_bloom: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # puts this tree's src on sys.path; the next line wins
    sys.path.insert(0, str(args.src.resolve()))
    import repro_torch
    from repro_torch.kernels import build

    build.library()
    saved = torch.load(args.inputs)
    k, v = (a.cuda() for a in saved["sort"])
    keys, valid = (a.cuda() for a in saved["bloom"])
    times = chip_smoke.sort_bloom_kernel_times(k, v, keys, valid,
                                               saved["m_bits"], saved["k"])
    print(chip_smoke.nvidia_smi())
    print(json.dumps({"src": str(Path(repro_torch.__file__).parents[1]),
                      **times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
