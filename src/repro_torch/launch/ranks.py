"""Starting a launcher's ranks: one process per rank under
``torch.multiprocessing`` (spawn), a ``FileStore`` rendezvous in a fresh
temporary directory, NCCL when each rank has its own card and gloo when
ranks share one (NCCL refuses two ranks on one card) or run on the CPU.
"""

from __future__ import annotations

import shutil
import tempfile
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def backend_for(world: int, device: torch.device) -> str:
    """"nccl" when every rank gets a card of its own, else "gloo"."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(device: torch.device, rank: int, backend: str
                ) -> torch.device:
    if device.type != "cuda":
        return device
    index = rank if backend == "nccl" else (device.index or 0)
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _entry(rank, world, store, backend, device, fn, args):
    if device.type == "cpu":    # ranks that share the host share its cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=600))
    try:
        fn(rank_device(device, rank, backend), *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, device, fn, *args) -> None:
    """``fn(device, *args)`` in each of ``world`` new rank processes, every
    one joined to one process group; returns when all have ended (a rank's
    exception raises here). ``fn`` must be a module-level function."""
    device = torch.device(device)
    backend = backend_for(world, device)
    print(f"[launch] {world} ranks on {device.type}, backend {backend}"
          + (" (ranks share one card)" if backend == "gloo"
             and device.type == "cuda" else ""), flush=True)
    tmp = tempfile.mkdtemp(prefix="ranks_")
    try:
        mp.start_processes(_entry, args=(world, f"{tmp}/store", backend,
                                         device, fn, args),
                           nprocs=world, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
