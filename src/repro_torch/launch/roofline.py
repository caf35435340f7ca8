"""Roofline terms from a counted program, on H100 constants.

    compute term    = FLOPs / (chips * peak_FLOP/s)
    memory term     = HBM_bytes / (chips * HBM_bw)
    collective term = collective_bytes / (chips * link_bw)

``hlo_cost.count`` gives one device's FLOPs, bytes and collective wire
bytes (an SPMD program; multiply by the chip count for cluster totals).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from .hlo_cost import CostSummary

# NVIDIA H100 SXM, NVIDIA's H100 data sheet (dense rates, 700 W):
# 989 TFLOP/s bf16 (the peak chip_smoke.py uses) and 3.35 TB/s of HBM3.
# NVLink 4 gives a GPU 900 GB/s, both directions together: 450e9 is what
# one GPU sends, and the counted collective bytes are those a rank sends.
# A 16-wide mesh axis spans two 8-GPU nodes, whose InfiniBand NDR links
# give 50 GB/s a GPU, so ``collective_s`` is a floor: the model keeps one
# link rate, as the reference's does.
PEAK_FLOPS = 989e12          # bf16 per GPU
HBM_BW = 3.35e12             # bytes/s per GPU
LINK_BW = 450e9              # bytes/s a GPU sends over NVLink


@dataclasses.dataclass
class Roofline:
    flops: float                  # cluster total
    hbm_bytes: float              # cluster total
    collective_bytes: float       # cluster total (wire)
    chips: int
    per_collective: Dict[str, float]
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bound: str = ""

    def __post_init__(self):
        self.compute_s = self.flops / (self.chips * PEAK_FLOPS)
        self.memory_s = self.hbm_bytes / (self.chips * HBM_BW)
        self.collective_s = self.collective_bytes / (self.chips * LINK_BW)
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bound = max(terms, key=terms.get)

    def step_time_s(self) -> float:
        """Roofline-optimistic step time (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def model_flops_ratio(self, model_flops: float) -> float:
        return model_flops / self.flops if self.flops else 0.0


def roofline_from_counts(summary: CostSummary, n_devices: int) -> Roofline:
    """The three terms from one device's ``hlo_cost.CostSummary``, times
    the chip count for cluster totals."""
    return Roofline(flops=summary.flops * n_devices,
                    hbm_bytes=summary.bytes_accessed * n_devices,
                    collective_bytes=summary.total_collective_bytes
                    * n_devices,
                    chips=n_devices,
                    per_collective=summary.collective_wire_bytes)


def model_flops(cfg, shape, per_token_factor: float = 6.0) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode counts one token/seq."""
    n = cfg.active_param_count()
    if shape.kind == "decode":
        tokens = shape.global_batch
        return 2.0 * n * tokens     # forward only
    tokens = shape.global_batch * shape.seq_len
    factor = per_token_factor if shape.kind == "train" else 2.0
    return factor * n * tokens
