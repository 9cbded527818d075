"""Multi-process initialization (counterpart of
contrastboundary_tpu/parallel/distributed.py).

A rank is one process with one device, as a JAX process with one local
device is. ``maybe_initialize_distributed`` is called once at program
start; it joins a ``torch.distributed`` process group when a launcher
describes one, and is a no-op otherwise:

- ``CBL_COORDINATOR`` (``host:port`` of rank 0), ``CBL_NUM_PROCESSES`` and
  ``CBL_PROCESS_ID``, the variables the JAX package reads;
- or torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``
  (``env://``), in place of the JAX package's ``CBL_AUTO_DISTRIBUTED``.

The backend follows the device: NCCL for CUDA, gloo for the CPU. A library
caller may name another (gloo over CUDA tensors, e.g. two ranks sharing one
card, which NCCL refuses). A device without an index becomes
``cuda:LOCAL_RANK`` (torchrun's ``LOCAL_RANK``; without it, the rank modulo
the host's card count, as a launch of one process a card, ranks numbered
host by host, places them).
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def _launcher() -> Optional[tuple]:
    """(init_method, world size, rank) the environment describes, or None."""
    coord = os.environ.get("CBL_COORDINATOR", "")
    if coord:
        return (f"tcp://{coord}", int(os.environ["CBL_NUM_PROCESSES"]),
                int(os.environ["CBL_PROCESS_ID"]))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return ("env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]))
    return None


def rank_device(device, rank: int) -> torch.device:
    """The device rank ``rank`` computes on: ``device`` itself if it is the
    CPU or names a card, else ``cuda:LOCAL_RANK``, else ``cuda:(rank mod the
    host's card count)``."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None
                        else rank % torch.cuda.device_count())


def maybe_initialize_distributed(device="cuda", backend: Optional[str] = None) -> dict:
    """Join the process group the environment describes → {'process_index',
    'process_count', 'device'}, the device this rank computes on.

    World size 1 (no launcher, or one process) initializes nothing. A group
    already initialized by the caller is taken as it is. Otherwise the
    group is initialized with ``backend`` (default: 'nccl' for a CUDA
    device, 'gloo' for the CPU); a CUDA rank's device is made current."""
    dev = torch.device(device)
    if dist.is_initialized():
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return {"process_index": dist.get_rank(), "process_count": dist.get_world_size(),
                "device": dev}
    launch = _launcher()
    if launch is None or launch[1] == 1:
        return {"process_index": 0, "process_count": 1, "device": dev}
    init_method, world, rank = launch
    dev = rank_device(dev, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method, world_size=world, rank=rank)
    return {"process_index": rank, "process_count": world, "device": dev}
