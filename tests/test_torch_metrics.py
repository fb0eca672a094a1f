"""The port's SSIM (ops/metrics.py) against the JAX package's, and the
plain-Python helpers of utils/ (throughput, sparkline, image preview)
against theirs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu.ops import metrics as jmetrics
from nerf_rs_tpu.utils import term as jterm
from nerf_rs_tpu_torch.ops import metrics
from nerf_rs_tpu_torch.utils import term
from nerf_rs_tpu_torch.utils.profiling import Throughput

torch.set_num_threads(2)


@pytest.mark.parametrize("kind", ["random", "white", "noisy_disk"])
def test_ssim_matches_jax(kind):
    """Both in full f32 (the JAX side at HIGHEST precision); only the
    summation order differs, so atol 1e-5."""
    rng = np.random.default_rng(0)
    h, w = 32, 40
    if kind == "random":
        a, b = rng.uniform(size=(2, h, w, 3)).astype(np.float32)
    else:
        yy, xx = np.mgrid[:h, :w]
        disk = np.repeat((((yy - 16) ** 2 + (xx - 20) ** 2) < 100)[..., None], 3, -1)
        noise = rng.normal(0, 0.05, (h, w, 3))
        if kind == "white":  # a white-background frame: a grey disk on white
            a = np.where(disk, 0.4, 1.0).astype(np.float32)
            b = np.clip(np.where(disk, 0.45 + noise, 1.0), 0, 1).astype(np.float32)
        else:
            a = disk.astype(np.float32)
            b = np.clip(a + noise, 0, 1).astype(np.float32)
    got = float(metrics.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) <= 1e-5, (got, want)
    assert abs(float(metrics.ssim(torch.from_numpy(a), torch.from_numpy(a))) - 1.0) <= 1e-5


def test_ssim_of_an_image_smaller_than_the_window_is_nan():
    # no valid window position (the JAX package raises there); the CPU
    # train tests evaluate 8x8 frames
    tiny = torch.zeros(8, 8, 3)
    assert np.isnan(float(metrics.ssim(tiny, tiny)))


def test_term_helpers_match_jax():
    vals = list(np.random.default_rng(1).uniform(size=130)) + [float("nan")]
    assert term.sparkline(vals) == jterm.sparkline(vals)
    img = np.random.default_rng(2).uniform(size=(20, 30, 3)).astype(np.float32)
    assert term.image_preview(img, width=12) == jterm.image_preview(img, width=12)


def test_throughput_counts_steps():
    thr = Throughput(num_rays=4096, num_samples=64)
    assert thr.stats() == {}
    thr.tick(10)
    stats = thr.stats()
    assert stats["samples_per_sec"] == pytest.approx(stats["rays_per_sec"] * 64)
    assert stats["step_time_ms"] > 0
