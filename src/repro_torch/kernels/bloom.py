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

The build is one launch in one of three branches, chosen here from the
number of keys and the filter's size (``build_branch``), passed to the
kernel as a code and counted in ``bloom_build.branch_launches``: up to
``ONE_CLUSTER_KEYS`` keys one cluster of 8 blocks builds the filter in
shared memory and merges it through distributed shared memory; beyond,
each block builds its keys' filter in shared memory and ORs it into the
per-stream workspace's accumulator (``launch.workspace``, shared with
``partition_hist``), which the last block moves into the output; filters
too large for shared memory are ORed into that accumulator directly.

The probe kernel stages the filter in each block's shared memory where it
fits (``filter_fits_shared``: m_bits / 8 bytes within 227 KB, so m_bits <=
2^20) and reads it from device memory otherwise; the wrapper chooses by
size and counts launches by branch in ``bloom_probe.filter_launches``.
"""

from __future__ import annotations

import torch

from . import ref
from .build import check, library
from .launch import (cuda_stream, flat_keys, flat_valid, require_kernel_input,
                     workspace)
from .ref import BLOOM_SEED_1, BLOOM_SEED_2

#: Dynamic shared memory one block may use on an H100 after the kernel's
#: opt-in (227 KB); larger filters are read from device memory.
SHARED_FILTER_BYTES = 232_448


def filter_fits_shared(m_bits: int) -> bool:
    """Whether an ``m_bits``-bit filter fits in one block's shared
    memory."""
    return m_bits // 8 <= SHARED_FILTER_BYTES


#: Keys up to which one cluster of 8 blocks builds the whole filter in
#: shared memory, with no global atomic: the filter path's builds (12,000
#: keys at most at scale 30) take this branch. At 65,536 bits the cluster
#: and the blocks branch measured the same between 48,000 and 65,536 keys
#: on an H100 (PERF.md).
ONE_CLUSTER_KEYS = 49_152
#: The build kernel's branch codes, by position.
BUILD_BRANCHES = ("cluster", "blocks", "device")


def build_branch(n: int, m_bits: int) -> str:
    """The build kernel's branch for ``n`` keys into ``m_bits`` bits."""
    if not filter_fits_shared(m_bits):
        return "device"
    return "cluster" if n <= ONE_CLUSTER_KEYS else "blocks"


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
    branch = build_branch(flat.numel(), m_bits)
    with cuda_stream(flat) as stream:
        ws = (None if branch == "cluster"
              else workspace(flat.device, stream, m_bits // 32).data_ptr())
        err = library().repro_bloom_build(
            flat.data_ptr(), v.data_ptr(), flat.numel(), m_bits, k,
            BLOOM_SEED_1, BLOOM_SEED_2, BUILD_BRANCHES.index(branch), ws,
            words.data_ptr(), stream)
    check(err, "bloom_build")
    bloom_build.launches += 1
    bloom_build.branch_launches[branch] += 1
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
    shared = filter_fits_shared(m_bits)
    with cuda_stream(flat) as stream:
        err = library().repro_bloom_probe(
            flat.data_ptr(), flat.numel(), words.data_ptr(), m_bits, k,
            BLOOM_SEED_1, BLOOM_SEED_2, int(shared), out.data_ptr(), stream)
    check(err, "bloom_probe")
    bloom_probe.launches += 1
    bloom_probe.filter_launches["shared" if shared else "device"] += 1
    return out.reshape(keys.shape)


bloom_build.launches = 0  # type: ignore[attr-defined]
#: Launches by build branch (``build_branch``).
bloom_build.branch_launches = dict.fromkeys(  # type: ignore[attr-defined]
    BUILD_BRANCHES, 0)
bloom_probe.launches = 0  # type: ignore[attr-defined]
#: Launches by where the filter lay: shared memory or device memory.
bloom_probe.filter_launches = {"shared": 0, "device": 0}  # type: ignore
