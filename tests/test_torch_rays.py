"""Parity of the PyTorch port's ray geometry and sampling with the JAX
package on the CPU: poses, the view-angle grid, full-frame rays,
deterministic stratified samples, deltas and sample points.

Everything here is f32 elementwise math on both sides (the JAX side runs
its 3x3 products at HIGHEST precision), so the bar is atol 1e-6: a few
ulps of values that are O(1).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.ops import rays as jrays
from nerf_rs_tpu.ops import sampling as jsamp
from nerf_rs_tpu_torch.config import CameraConfig
from nerf_rs_tpu_torch.ops import rays, sampling

torch.set_num_threads(2)
ATOL = 1e-6


def _jcam(cam: CameraConfig) -> "jconfig.CameraConfig":
    """The JAX package's camera with the port's values."""
    return jconfig.CameraConfig(**dataclasses.asdict(cam))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_pose_from_yaw_pitch_matches_jax():
    rng = np.random.default_rng(0)
    yaw = rng.uniform(0, 2 * math.pi, 17).astype(np.float32)
    pitch = rng.uniform(-1, 1, 17).astype(np.float32)
    got = rays.pose_from_yaw_pitch(torch.from_numpy(yaw), torch.from_numpy(pitch))
    _close(got, jrays.pose_from_yaw_pitch(jnp.asarray(yaw), jnp.asarray(pitch)))
    # a rotation: R R^T = I
    eye = (got[..., :, :, None] * got[..., None, :, :].transpose(-1, -2)).sum(-2)
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(3), eye.shape), atol=1e-6)


@pytest.mark.parametrize("num_views", [3, 6])
def test_view_angle_grid_matches_jax(num_views):
    _close(rays.view_angle_grid(num_views), jrays.view_angle_grid(num_views))


def test_spherical_render_path_matches_jax():
    _close(rays.spherical_render_path(7, 0.4), jrays.spherical_render_path(7, 0.4))


@pytest.mark.parametrize("posed", [False, True])
def test_ray_grid_matches_jax(posed):
    cam = CameraConfig(width=16, height=12)
    pose = jrays.pose_from_yaw_pitch(jnp.float32(0.37), jnp.float32(0.21)) if posed else None
    o_j, d_j = jrays.ray_grid(pose, _jcam(cam))
    o_p, d_p = rays.ray_grid(None if pose is None else torch.from_numpy(np.array(pose)), cam)
    assert o_p.shape == (12, 16, 3) and d_p.shape == (12, 16, 3)
    _close(o_p, o_j)
    _close(d_p, d_j)


def test_rays_for_coords_matches_jax():
    cam = CameraConfig(width=32, height=32)
    coords = np.random.default_rng(1).uniform(0, 31, (40, 2)).astype(np.float32)
    pose = np.array(jrays.pose_from_yaw_pitch(jnp.float32(1.1), jnp.float32(0.5)))
    o_j, d_j = jrays.rays_for_coords(jnp.asarray(coords), jnp.asarray(pose), _jcam(cam))
    o_p, d_p = rays.rays_for_coords(torch.from_numpy(coords), torch.from_numpy(pose), cam)
    _close(o_p, o_j)
    _close(d_p, d_j)


def test_stratified_midpoints_deltas_points_match_jax():
    ts_j = jsamp.stratified_ts(None, 5, 64, 0.05, 2.0, randomized=False)
    ts_p = sampling.stratified_ts(5, 64, 0.05, 2.0, randomized=False)
    _close(ts_p, ts_j)
    _close(sampling.deltas_from_ts(ts_p, 2.0), jsamp.deltas_from_ts(ts_j, 2.0))
    rng = np.random.default_rng(2)
    o = rng.normal(size=(5, 3)).astype(np.float32)
    d = rng.normal(size=(5, 3)).astype(np.float32)
    _close(sampling.points_from_ts(torch.from_numpy(o), torch.from_numpy(d), ts_p),
           jsamp.points_from_ts(jnp.asarray(o), jnp.asarray(d), ts_j))


def test_stratified_randomized_is_seeded_and_stratified():
    gen = lambda: torch.Generator().manual_seed(3)
    a = sampling.stratified_ts(9, 16, 0.5, 2.5, True, generator=gen())
    b = sampling.stratified_ts(9, 16, 0.5, 2.5, True, generator=gen())
    assert torch.equal(a, b)
    edges = torch.linspace(0.5, 2.5, 17)
    assert (a >= edges[:-1]).all() and (a <= edges[1:]).all()
    assert (a.diff(dim=-1) > 0).all()
