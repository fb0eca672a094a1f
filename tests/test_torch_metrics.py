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
    # the JAX package's keys: per-card rates, one card by default
    assert set(stats) == {"step_time_ms", "rays_per_sec", "rays_per_sec_per_chip",
                          "samples_per_sec_per_chip"}
    assert stats["rays_per_sec_per_chip"] == stats["rays_per_sec"]
    assert stats["samples_per_sec_per_chip"] == pytest.approx(stats["rays_per_sec"] * 64)
    assert stats["step_time_ms"] > 0


@pytest.mark.parametrize("fine,chips", [(0, 1), (128, 1), (128, 4)])
def test_throughput_matches_jax_on_a_stubbed_clock(fine, chips, monkeypatch):
    """The loop's Throughput (``train/loop.make_throughput``: coarse plus
    fine samples a ray, every card of the run) against the JAX loop's
    ``Throughput(num_rays, num_samples + num_fine_samples, nchips)`` on the
    same ticks of one clock: the same keys and the same floats."""
    import time

    from nerf_rs_tpu.utils.profiling import Throughput as JThroughput
    from nerf_rs_tpu_torch.config import Config, RenderConfig
    from nerf_rs_tpu_torch.train.loop import make_throughput

    clock = iter([10.0, 10.0, 12.5, 12.5])  # reset, reset, stats, stats
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    cfg = Config(render=RenderConfig(num_samples=64, num_fine_samples=fine))
    mine = make_throughput(cfg, chips)
    jax_thr = JThroughput(cfg.train.num_rays, 64 + fine, chips)
    for thr in (mine, jax_thr):
        thr.tick(7)
        thr.tick()
    got, want = mine.stats(), jax_thr.stats()
    assert got == want
    assert got["samples_per_sec_per_chip"] == pytest.approx(
        8 / 2.5 * cfg.train.num_rays * (64 + fine) / chips)
