"""bloom_build / bloom_probe — the bloom runtime filter over join keys.

``bloom_build`` folds a key column into an ``m_bits``-wide bloom filter
packed into ``m_bits/32`` words; ``bloom_probe`` gives the keep-mask of a
probe-side key column against it, applied before the probe side's exchanges
so rejected rows never ship. Positions are Kirsch-Mitzenmacher double
hashes ``h1 + i*h2`` (``ref.bloom_positions``), bit-identical to the
reference's.

The words are an int32 tensor holding the reference's uint32 bit patterns
(``payload_from_numpy`` converts). On CUDA tensors the wrappers launch
``csrc/bloom.cu``; on CPU tensors they run the plain versions in
``ref.py``.
"""

from __future__ import annotations

import torch

from . import ref
from .build import check, library
from .launch import cuda_stream, flat_keys, flat_valid, require_kernel_input
from .ref import BLOOM_SEED_1, BLOOM_SEED_2


def bloom_build(keys: torch.Tensor, valid: torch.Tensor | None = None, *,
                m_bits: int, k: int) -> torch.Tensor:
    """Bloom filter of the valid entries of ``keys`` (any shape, integer
    dtype, read as int32): int32 ``(m_bits/32,)`` words. An empty or
    all-invalid input gives the zero filter, which rejects every key."""
    if m_bits < 32 or m_bits & (m_bits - 1):
        raise ValueError(f"m_bits must be a power of two >= 32, got {m_bits}")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    flat = flat_keys(keys)
    v = flat_valid(valid, flat)
    if flat.device.type == "cpu" and v.device.type == "cpu":
        return ref.bloom_build_ref(flat, v, m_bits, k)
    require_kernel_input("bloom_build", flat, v)
    if not flat.numel() or not k:
        return torch.zeros(m_bits // 32, dtype=torch.int32,
                           device=flat.device)
    words = torch.empty(m_bits // 32, dtype=torch.int32, device=flat.device)
    with cuda_stream(flat) as stream:
        err = library().repro_bloom_build(
            flat.data_ptr(), v.data_ptr(), flat.numel(), m_bits, k,
            BLOOM_SEED_1, BLOOM_SEED_2, words.data_ptr(), stream)
    check(err, "bloom_build")
    bloom_build.launches += 1
    return words


def bloom_probe(keys: torch.Tensor, words: torch.Tensor, *, k: int
                ) -> torch.Tensor:
    """Keep-mask of ``keys`` against a ``bloom_build`` filter: True iff all
    k probed bits are set (never a false negative). Same shape as
    ``keys``."""
    if words.dim() != 1 or words.dtype != torch.int32 or not words.numel():
        raise ValueError("bloom_probe expects the int32 (m_bits/32,) words "
                         "of bloom_build")
    m_bits = words.numel() * 32
    if m_bits & (m_bits - 1):
        raise ValueError(f"filter of {m_bits} bits is not a power of two")
    flat = flat_keys(keys)
    if flat.device.type == "cpu" and words.device.type == "cpu":
        return ref.bloom_probe_ref(flat, words, k).reshape(keys.shape)
    require_kernel_input("bloom_probe", flat, words)
    out = torch.empty(flat.shape, dtype=torch.bool, device=flat.device)
    if not flat.numel():
        return out.reshape(keys.shape)
    with cuda_stream(flat) as stream:
        err = library().repro_bloom_probe(
            flat.data_ptr(), flat.numel(), words.data_ptr(), m_bits, k,
            BLOOM_SEED_1, BLOOM_SEED_2, out.data_ptr(), stream)
    check(err, "bloom_probe")
    bloom_probe.launches += 1
    return out.reshape(keys.shape)


bloom_build.launches = 0  # type: ignore[attr-defined]
bloom_probe.launches = 0  # type: ignore[attr-defined]
