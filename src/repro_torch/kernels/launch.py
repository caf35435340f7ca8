"""What every kernel wrapper checks before it hands pointers to CUDA."""

from __future__ import annotations

import contextlib

import torch


def require_kernel_input(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, expected cuda "
                             "(CPU tensors take the plain version)")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")


@contextlib.contextmanager
def cuda_stream(t: torch.Tensor):
    """Make ``t``'s card current and yield its current stream's handle."""
    with torch.cuda.device(t.device):
        yield torch.cuda.current_stream(t.device).cuda_stream


def flat_keys(keys: torch.Tensor) -> torch.Tensor:
    """A key column of any shape and integer dtype as contiguous flat
    int32, as the filter kernels read it."""
    return keys.reshape(-1).to(torch.int32).contiguous()


def flat_valid(valid: torch.Tensor | None, keys: torch.Tensor
               ) -> torch.Tensor:
    """The validity mask beside ``flat_keys(keys)``: contiguous flat bool,
    all True when ``valid`` is None."""
    if valid is None:
        return torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    if valid.numel() != keys.numel():
        raise ValueError(f"valid has {valid.numel()} entries, keys "
                         f"{keys.numel()}")
    return valid.reshape(-1).to(torch.bool).contiguous()


#: (device index, stream handle) -> int32 workspace: a ticket, then an
#: accumulator; zero between calls on that stream. The one-launch
#: reductions (``partition_hist``, ``bloom_build``) share it: calls on one
#: stream run in order, and each leaves the ticket and the accumulator
#: zero. Keying by the handle assumes that no stream's handle is reused
#: while work is still queued on it: PyTorch's own streams never release
#: theirs, but a destroyed ``torch.cuda.ExternalStream`` whose handle a new
#: stream takes while its last call is in flight would share that call's
#: accumulator.
_workspaces: dict = {}

#: Accumulator words a new workspace holds at least: the words of the
#: filter path's bloom filters (65,536 bits), more than any histogram of
#: the main path needs.
MIN_WORKSPACE_WORDS = 2048


def workspace(device: torch.device, stream: int, words: int
              ) -> torch.Tensor:
    """The zero workspace of ``stream`` on ``device``, with room for an
    accumulator of at least ``words`` int32 after its ticket."""
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < words + 1:
        # Zeroed once; the kernels leave it zero. The old one is released
        # to the allocator on this stream, after the work queued on it.
        ws = torch.zeros(max(words, MIN_WORKSPACE_WORDS) + 1,
                         dtype=torch.int32, device=device)
        _workspaces[key] = ws
    return ws
