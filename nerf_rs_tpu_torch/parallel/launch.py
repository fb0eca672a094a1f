"""Starts a host's ranks: one process per device, spawned with
``torch.multiprocessing`` (the ``spawn`` start method), each joining the
process group (``dist_init.initialize``) before it runs the command. The
JAX package has no counterpart: one JAX process drives every device of its
host.

``local_ranks`` is the count the run asks for: ``--num_devices`` cards
over its host processes (0: every visible card), or that many gloo ranks on
the CPU (0: one). NCCL
never puts two ranks on one card, so asking for more cards than are
visible raises, naming both numbers; nothing falls back to fewer ranks or
to the CPU. The ranks of one host meet through a file store in a fresh
temporary directory; the ranks of several hosts through
``NERF_COORDINATOR``'s TCP store. A world of one rank runs the command in
this process, with no process group.
"""

from __future__ import annotations

import shutil
import sys
import tempfile
from typing import Callable, Optional

import torch
import torch.multiprocessing as mp

from . import dist_init


def local_ranks(num_devices: int, device_type: str) -> int:
    """The ranks this host runs for ``--num_devices`` on ``device_type``:
    the run's devices over its host processes, as a JAX mesh counts every
    process's devices (0: every visible card, or one CPU rank)."""
    nproc = dist_init.process_count()
    if num_devices % nproc:
        raise ValueError(f"{num_devices} devices do not split over {nproc} host processes")
    want = num_devices // nproc
    if device_type != "cuda":
        return max(want, 1)
    have = torch.cuda.device_count()
    if have == 0:
        raise RuntimeError("--device cuda: no CUDA device is visible; the port runs on the "
                           "card unless asked for the CPU (--device cpu)")
    n = want or have
    if n > have:
        raise ValueError(f"requested {n} devices, have {have} visible card(s): a rank drives "
                         f"one card of its own")
    return n


def _rank_main(local_rank: int, n: int, device_type: str, backend: Optional[str],
               init_method: Optional[str], same_device: bool, fn: Callable, args) -> None:
    device = torch.device("cuda", 0) if same_device and device_type == "cuda" else None
    dist_init.initialize(local_rank, n, device_type, backend, init_method, device)
    try:
        rc = fn(*args)
    finally:
        dist_init.shutdown()
    if rc:
        sys.exit(rc)


def run(fn: Callable, args=(), num_devices: int = 0, device_type: str = "cuda",
        backend: Optional[str] = None, same_device: bool = False):
    """``fn(*args)`` on every rank of this host; returns its result in a
    world of one rank, else 0 or the first failing rank's exit code. A rank
    that raises makes this raise. ``same_device`` puts every rank on the
    first card (``num_devices`` of them; gloo only, as NCCL refuses it)."""
    n = max(num_devices, 1) if same_device else local_ranks(num_devices, device_type)
    if n * dist_init.process_count() == 1:
        return fn(*args)
    store = tempfile.mkdtemp(prefix="nerf_ranks_") if dist_init.process_count() == 1 else None
    init_method = f"file://{store}/store" if store else None
    try:
        mp.start_processes(_rank_main, nprocs=n, start_method="spawn", join=True,
                           args=(n, device_type, backend, init_method, same_device, fn, args))
    except mp.ProcessExitedException as e:
        return e.exit_code if e.exit_code > 0 else 1  # a signal: negative
    finally:
        if store:
            shutil.rmtree(store, ignore_errors=True)
    return 0
