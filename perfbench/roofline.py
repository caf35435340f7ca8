"""The yardstick of the kernels' roofline shares: the card's published
peaks and each kernel's least work, counted from its inputs.

Copied from ``chip_smoke.py`` (``PEAK_BYTES_PER_S``, ``PEAK_INT_OPS_PER_S``,
``bound``, ``hist_least_work``, ``probe_least_work``,
``bloom_probe_least_work``) and ``repro_torch.joins.slots.hash32`` with the
bloom seeds of ``repro_torch.kernels.ref``, so that a later change to a
kernel is still measured against the same count. Each input byte counts
once when read and each output byte once when written, whatever the kernel
reads again.
"""

from __future__ import annotations

import torch

#: Published H100 SXM peaks (NVIDIA data sheet, 700 W): the device memory
#: rate, and the 32-bit integer instruction rate every one of these
#: kernels' operations is: the 67 TFLOP/s float32 peak times 64/128 (CUDA
#: C++ Programming Guide, results per clock per SM of 32-bit integer add,
#: multiply-add, logic and shift against float32 FMA at compute capability
#: 9.0), over the 2 operations an FMA counts for.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_OPS_PER_S = 67e12 * 64 / 128 / 2

BLOOM_SEED_1 = 0x165667B1
BLOOM_SEED_2 = 0xD6E8FEB8
_MASK32 = 0xFFFFFFFF


def least_seconds(nbytes: float, ops: float) -> float:
    """Least time for moving ``nbytes`` and doing ``ops``: the larger of
    the two bounds."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT_OPS_PER_S)


def hist_least_work(n: int, nd: int, masked: bool) -> tuple[float, float]:
    """partition_hist (K1): each destination (and mask byte) read once,
    each count written once; one operation an element."""
    return (4 + masked) * n + 4 * nd, n


def probe_least_work(n_probe: int, n_build: int) -> tuple[float, float]:
    """tiled_probe (K2): every probe and build key read once and one
    output a probe key written, 4 bytes each; one hash and one compare per
    probe key and per build key."""
    return 4.0 * (2 * n_probe + n_build), 2.0 * (n_probe + n_build)


def hash32(keys: torch.Tensor, seed: int) -> torch.Tensor:
    h = keys.to(torch.int64) & _MASK32
    h = (h * seed) & _MASK32
    h = h ^ (h >> 15)
    h = (h * 0xC2B2AE35) & _MASK32
    return h ^ (h >> 13)


def bloom_probe_least_work(flat_k: torch.Tensor, words: torch.Tensor,
                           k: int) -> tuple[float, float]:
    """bloom_probe (K5) on these keys: each key read once and its byte
    written once, the filter read once; two hash chains a key (13
    operations) and 7 for each bit the key's data makes it test, up to its
    first clear bit."""
    m_bits = words.numel() * 32
    h1 = hash32(flat_k, BLOOM_SEED_1)
    h2 = hash32(flat_k, BLOOM_SEED_2) | 1
    w64 = words.long() & _MASK32
    alive = torch.ones_like(flat_k, dtype=torch.bool)
    tested = 0
    for i in range(k):
        tested += int(alive.sum())
        pos = ((h1 + ((i * h2) & _MASK32)) & _MASK32) & (m_bits - 1)
        alive &= ((w64[pos >> 5] >> (pos & 31)) & 1).bool()
    n = flat_k.numel()
    return 5.0 * n + m_bits // 8, 13.0 * n + 7 * tested
