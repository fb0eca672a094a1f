"""Profiling, the counterpart of ``nerf_rs_tpu/utils/profiling.py``:
``trace(log_dir)`` records the enclosed steps with ``torch.profiler`` (the
host's operators and, on the card, its kernels) and writes a Chrome trace
JSON into ``log_dir``, which chrome://tracing and Perfetto open; the
training loop's ``--profile_steps`` window runs through it. ``Throughput``
counts step time, rays/s and the per-card rays/s and ray-samples/s over a
window of train steps, on the host clock, under the JAX package's keys; the
training loop counts coarse plus fine samples and every card of the run.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace"):
    """Profile the enclosed code into ``{log_dir}/{name}-{unix ts}.json``:
    CPU activity, and CUDA activity when a card is visible. Yields the
    trace's path, which is written when the block ends."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{name}-{int(time.time())}.json")
    with torch.profiler.profile(activities=acts) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


class Throughput:
    """Windowed throughput over train steps of ``num_rays`` rays (all the
    ranks' together) and ``num_samples`` samples a ray on ``num_chips``
    cards."""

    def __init__(self, num_rays: int, num_samples: int, num_chips: int = 1):
        self.num_rays = num_rays
        self.num_samples = num_samples
        self.num_chips = max(1, num_chips)
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1):
        self._steps += n

    def stats(self) -> Dict[str, float]:
        dt = time.perf_counter() - self._t0
        if dt <= 0 or self._steps == 0:
            return {}
        steps_per_sec = self._steps / dt
        rays_per_sec = steps_per_sec * self.num_rays
        return {
            "step_time_ms": 1000.0 / steps_per_sec,
            "rays_per_sec": rays_per_sec,
            "rays_per_sec_per_chip": rays_per_sec / self.num_chips,
            "samples_per_sec_per_chip": rays_per_sec * self.num_samples / self.num_chips,
        }
