"""tiled_probe — batched first-match probes of the hash-family joins and of
the hypercube multi-way join.

``tiled_probe``: out[r, i] = min{j : b_keys[r, j] == a_keys[r, i]}, else -1.
Callers encode invalid rows with distinct negative sentinels (probe -1,
build -2) so they never match. One call covers every (partition, radix
bucket) pair of a hash join: on a CUDA tensor it launches
``csrc/tiled_probe.cu`` once; on a CPU tensor it runs the plain version in
``ref.py``.

``tiled_probe3``: the same first-match probe of two probe key columns
against two builds of their own lengths, in one pass (the hypercube's
three-way local join). On a CUDA tensor it launches ``csrc/tiled_probe3.cu``
once for every partition; on a CPU tensor it runs the plain version.

The kernels do not scan the builds. Each build row becomes an
open-addressing table (``csrc/first_match.cuh``) that maps a key to the
least index holding it, ``table_capacity(n)`` slots of 8 bytes, so a probe
key costs one hash and about one lookup. Where a row's tables fit in one
block's shared memory (``tables_fit_shared``) each block builds them there;
otherwise the wrapper allocates them in device memory and the kernel
fills, builds and probes them in three launches. The choice is made here,
by size alone, and is counted in ``table_launches``.
"""

from __future__ import annotations

import torch

from . import ref
from .build import check, library
from .launch import cuda_stream, require_kernel_input

#: Dynamic shared memory one block may use on an H100 after the kernel's
#: opt-in (227 KB); tables larger than this live in device memory.
SHARED_TABLE_BYTES = 232_448
#: One table entry: the key's 32 bits and its least index's 32 bits.
TABLE_ENTRY_BYTES = 8


def table_capacity(n: int) -> int:
    """Slots of the first-match table of an ``n``-key build row: the least
    power of two >= 1.5 n, so at most 2/3 of the slots are taken (1 for an
    empty build, whose one slot stays empty)."""
    need = -(-3 * n // 2)
    return 1 << max(need - 1, 0).bit_length()


def tables_fit_shared(*ns: int) -> bool:
    """Whether the tables of build rows of these lengths fit together in
    one block's shared memory."""
    return TABLE_ENTRY_BYTES * sum(map(table_capacity, ns)) \
        <= SHARED_TABLE_BYTES


def _device_tables(bsz: int, ns: tuple, like: torch.Tensor):
    """None where the tables fit shared memory, else uninitialised scratch
    for every row's tables (the kernel sets them empty)."""
    if tables_fit_shared(*ns):
        return None
    words = bsz * sum(map(table_capacity, ns))
    return torch.empty(words, dtype=torch.int64, device=like.device)


def _log2(n: int) -> int:
    return table_capacity(n).bit_length() - 1


def tiled_probe(a_keys: torch.Tensor, b_keys: torch.Tensor) -> torch.Tensor:
    """First-match probe: a_keys (B, na), b_keys (B, nb) -> int32 (B, na).

    1-D inputs are one batch row and give a 1-D result."""
    if a_keys.dtype != torch.int32 or b_keys.dtype != torch.int32:
        raise TypeError("tiled_probe expects int32 keys")
    if a_keys.dim() != b_keys.dim() or a_keys.dim() not in (1, 2):
        raise ValueError("tiled_probe expects two 1-D or two 2-D key tensors")
    if a_keys.dim() == 1:
        return tiled_probe(a_keys[None], b_keys[None])[0]
    bsz, na = a_keys.shape
    if b_keys.shape[0] != bsz:
        raise ValueError(f"batch mismatch: {bsz} probe rows, "
                         f"{b_keys.shape[0]} build rows")
    if a_keys.device.type == "cpu" and b_keys.device.type == "cpu":
        return ref.tiled_probe_ref(a_keys, b_keys)
    require_kernel_input("tiled_probe", a_keys, b_keys)
    nb = b_keys.shape[1]
    if bsz == 0 or na == 0 or nb == 0:
        return torch.full((bsz, na), -1, dtype=torch.int32,
                          device=a_keys.device)
    out = torch.empty((bsz, na), dtype=torch.int32, device=a_keys.device)
    tables = _device_tables(bsz, (nb,), a_keys)
    with cuda_stream(a_keys) as stream:
        err = library().repro_tiled_probe(
            a_keys.data_ptr(), b_keys.data_ptr(), bsz, na, nb, _log2(nb),
            None if tables is None else tables.data_ptr(), out.data_ptr(),
            stream)
    check(err, "tiled_probe")
    tiled_probe.launches += 1
    tiled_probe.table_launches["shared" if tables is None else "device"] += 1
    return out


tiled_probe.launches = 0  # type: ignore[attr-defined]
#: Launches by where the tables lay: shared memory or device memory.
tiled_probe.table_launches = {"shared": 0, "device": 0}  # type: ignore


def tiled_probe3(a1_keys: torch.Tensor, a2_keys: torch.Tensor,
                 b_keys: torch.Tensor, c_keys: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused first-match probe: a1_keys, a2_keys (B, na) against b_keys
    (B, nb) and c_keys (B, nc) -> two int32 (B, na).

    1-D inputs are one batch row and give 1-D results."""
    keys = (a1_keys, a2_keys, b_keys, c_keys)
    if any(k.dtype != torch.int32 for k in keys):
        raise TypeError("tiled_probe3 expects int32 keys")
    if len({k.dim() for k in keys}) != 1 or a1_keys.dim() not in (1, 2):
        raise ValueError("tiled_probe3 expects four 1-D or four 2-D key "
                         "tensors")
    if a1_keys.shape != a2_keys.shape:
        raise ValueError(f"probe columns differ in shape: "
                         f"{tuple(a1_keys.shape)} and {tuple(a2_keys.shape)}")
    if a1_keys.dim() == 1:
        out1, out2 = tiled_probe3(*(k[None] for k in keys))
        return out1[0], out2[0]
    bsz, na = a1_keys.shape
    if b_keys.shape[0] != bsz or c_keys.shape[0] != bsz:
        raise ValueError(f"batch mismatch: {bsz} probe rows, "
                         f"{b_keys.shape[0]} and {c_keys.shape[0]} build "
                         "rows")
    if all(k.device.type == "cpu" for k in keys):
        return ref.tiled_probe3_ref(*keys)
    require_kernel_input("tiled_probe3", *keys)
    nb, nc = b_keys.shape[1], c_keys.shape[1]
    if bsz == 0 or na == 0 or (nb == 0 and nc == 0):
        out1 = torch.full((bsz, na), -1, dtype=torch.int32,
                          device=a1_keys.device)
        return out1, out1.clone()
    out1 = torch.empty((bsz, na), dtype=torch.int32, device=a1_keys.device)
    out2 = torch.empty_like(out1)
    tables = _device_tables(bsz, (nb, nc), a1_keys)
    with cuda_stream(a1_keys) as stream:
        err = library().repro_tiled_probe3(
            a1_keys.data_ptr(), a2_keys.data_ptr(), b_keys.data_ptr(),
            c_keys.data_ptr(), bsz, na, nb, nc, _log2(nb), _log2(nc),
            None if tables is None else tables.data_ptr(), out1.data_ptr(),
            out2.data_ptr(), stream)
    check(err, "tiled_probe3")
    tiled_probe3.launches += 1
    tiled_probe3.table_launches["shared" if tables is None else
                                "device"] += 1
    return out1, out2


tiled_probe3.launches = 0  # type: ignore[attr-defined]
#: Launches by where the tables lay: shared memory or device memory.
tiled_probe3.table_launches = {"shared": 0, "device": 0}  # type: ignore
