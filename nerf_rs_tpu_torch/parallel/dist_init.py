"""Multi-process initialization, the counterpart of
``nerf_rs_tpu/parallel/dist_init.py``.

A rank is one process driving one device. One JAX process drives every
device of its host; here a host process runs ``local_ranks`` ranks
(``parallel/launch.py`` starts them), so the global rank is ``process_id x
local_ranks + local_rank`` and the world ``num_processes x local_ranks``.
The JAX package's variables name the hosts: ``NERF_NUM_PROCESSES``,
``NERF_PROCESS_ID`` and ``NERF_COORDINATOR`` (``host:port``, where the
ranks meet through ``torch.distributed``'s TCP store). Ranks on the card
bind ``cuda:local_rank`` and talk over NCCL; ranks on the CPU talk over
gloo. A caller may name the backend (two ranks sharing one card take gloo:
NCCL refuses them). One rank is a no-op: no process group is created.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

# this process's place among its host's ranks and the device it drives,
# set by initialize (a process holds one rank)
_LOCAL = {"rank": 0, "ranks": 1, "device": None}


def process_count() -> int:
    return int(os.environ.get("NERF_NUM_PROCESSES", "1"))


def process_index() -> int:
    return int(os.environ.get("NERF_PROCESS_ID", "0"))


def initialize(local_rank: int = 0, local_ranks: int = 1, device_type: str = "cuda",
               backend: Optional[str] = None, init_method: Optional[str] = None,
               device: Optional[torch.device] = None) -> bool:
    """Join the process group of every host's ranks; False (and nothing
    done) for a world of one rank or when this process already joined.
    ``init_method`` defaults to the coordinator's TCP store; the launcher
    passes a file store for the ranks of one host. ``device`` overrides the
    rank's ``cuda:local_rank``."""
    nproc, pid = process_count(), process_index()
    world = nproc * local_ranks
    if dist.is_initialized() or world <= 1:
        return False
    if not (0 <= pid < nproc and 0 <= local_rank < local_ranks):
        raise ValueError(f"process {pid} of {nproc}, local rank {local_rank} of {local_ranks}")
    if init_method is None:
        coordinator = os.environ.get("NERF_COORDINATOR")
        if not coordinator:
            raise ValueError(f"NERF_NUM_PROCESSES={nproc} needs NERF_COORDINATOR=host:port")
        init_method = f"tcp://{coordinator}"
    if device is None:
        device = (torch.device("cuda", local_rank) if device_type == "cuda"
                  else torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=pid * local_ranks + local_rank)
    _LOCAL.update(rank=local_rank, ranks=local_ranks, device=device)
    return True


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL.update(rank=0, ranks=1, device=None)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    return _LOCAL["rank"]


def local_ranks() -> int:
    return _LOCAL["ranks"]


def device() -> Optional[torch.device]:
    """The device this rank drives; None outside a process group (the
    caller's own choice then holds)."""
    return _LOCAL["device"]


def is_primary() -> bool:
    """True on the rank that writes checkpoints, logs and prints (global
    rank 0)."""
    return rank() == 0


def barrier() -> None:
    """Every rank waits for every other (a no-op on one rank)."""
    if dist.is_initialized():
        dist.barrier()
