"""Plain PyTorch versions of every kernel: the CPU path of each wrapper and
the oracle each CUDA kernel is held against on the card.

They take the kernels' batched shapes (a leading batch axis where the
kernel has one) and repeat the kernels' arithmetic; they are no yardstick
of speed.
"""

from __future__ import annotations

import torch

INT32_MAX = torch.iinfo(torch.int32).max

#: Elements of the (rows, na, nb) equality block the probe oracle builds at
#: once; larger batches are cut into row chunks.
_PROBE_BLOCK = 1 << 24


def partition_hist_ref(dest: torch.Tensor, nd: int) -> torch.Tensor:
    """counts[k] = #{i : dest[i] == k} as int32 (nd,); dest < 0 or >= nd
    ignored."""
    keep = (dest >= 0) & (dest < nd)
    d = dest[keep].to(torch.int64)
    out = torch.zeros(nd, dtype=torch.int32, device=dest.device)
    return out.index_add_(0, d, torch.ones_like(d, dtype=torch.int32))


def tiled_probe_ref(a_keys: torch.Tensor, b_keys: torch.Tensor
                    ) -> torch.Tensor:
    """out[r, i] = first j with b_keys[r, j] == a_keys[r, i], else -1.

    a_keys: (B, na), b_keys: (B, nb), both int32 -> int32 (B, na)."""
    bsz, na = a_keys.shape
    nb = b_keys.shape[1]
    out = torch.full((bsz, na), -1, dtype=torch.int32, device=a_keys.device)
    if na == 0 or nb == 0:
        return out
    col = torch.arange(nb, dtype=torch.int32, device=a_keys.device)
    step = max(1, _PROBE_BLOCK // (na * nb))
    for r0 in range(0, bsz, step):
        a = a_keys[r0:r0 + step]
        b = b_keys[r0:r0 + step]
        eq = a[:, :, None] == b[:, None, :]
        first = torch.where(eq, col, INT32_MAX).amin(dim=2)
        out[r0:r0 + step] = torch.where(first == INT32_MAX, -1, first)
    return out


def bitonic_sort_ref(keys: torch.Tensor, values: torch.Tensor):
    """Stable ascending sort of each row's (key, value) pairs by key."""
    order = torch.argsort(keys, dim=-1, stable=True)
    return (torch.gather(keys, -1, order), torch.gather(values, -1, order))
