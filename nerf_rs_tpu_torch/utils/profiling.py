"""Throughput accounting, the counterpart of ``Throughput`` in
``nerf_rs_tpu/utils/profiling.py`` (rays/s, ray-samples/s, step time
over a window of train steps, on the host clock), on one device: the
per-chip rates come with multi-GPU training (slice 8 of the port), the
profiler trace window with slice 7.
"""

from __future__ import annotations

import time
from typing import Dict


class Throughput:
    """Windowed throughput over train steps."""

    def __init__(self, num_rays: int, num_samples: int):
        self.num_rays = num_rays
        self.num_samples = num_samples
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
            "samples_per_sec": rays_per_sec * self.num_samples,
        }
