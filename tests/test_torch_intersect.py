"""The port's ``ops/intersect`` on the CPU against the JAX package's
(``tests/test_intersect.py``'s cases): the closest approach of two rays
(crossing, skew, parallel, behind the origin), all pairs of two views' ray
sets and their screen map, and the density-consistency probe, each on the
same inputs through both packages. Every value within 1e-5 (f32, the same
formulas; the validity flags and the map's counts exactly).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.models import mlp as jmlp
from nerf_rs_tpu.ops import intersect as jint
from nerf_rs_tpu.ops import rays as jrays
from nerf_rs_tpu_torch.config import CameraConfig, ModelConfig
from nerf_rs_tpu_torch.convert import params_from_numpy
from nerf_rs_tpu_torch.models.mlp import NerfMLP
from nerf_rs_tpu_torch.ops import intersect, rays

torch.set_num_threads(2)

TOL = 1e-5


def _both(fn, jfn, *arrays, **kw):
    got = fn(*(torch.tensor(a, dtype=torch.float32) for a in arrays), **kw)
    want = jfn(*(jnp.asarray(a, jnp.float32) for a in arrays), **kw)
    return got, want


def _same(got, want):
    for name in ("point_a", "point_b", "s", "t"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=TOL, err_msg=name)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


@pytest.mark.parametrize("case,valid", [
    ((([0, 0, -1], [0, 0, 1], [-1, 0, 0.5], [1, 0, 0])), True),  # crossing
    ((([0, 0, 0], [1, 0, 0], [0, 0.5, 1], [0, 0, -1])), False),  # skew, 0.5 apart
    ((([0, 0, 0], [0, 0, 1], [1, 0, 0], [0, 0, 1])), False),  # parallel
    ((([0, 0, 0], [0, 0, 1], [-1, 0, -2], [1, 0, 0])), False),  # behind the origin
])
def test_ray_intersection_matches_jax(case, valid):
    got, want = _both(intersect.ray_intersection, jint.ray_intersection, *case, t_max=4.0)
    _same(got, want)
    assert bool(got.valid) == valid
    if valid:
        np.testing.assert_allclose(got.point_a.numpy(), [0.0, 0.0, 0.5], atol=TOL)


def test_pairwise_view_intersections_and_screen_map_match_jax():
    """The central rays of two orthogonal views meet near the origin; 48
    rays of each view paired all against all, at tol 5e-2, then the screen
    map (counts normalised to the largest)."""
    cam = CameraConfig()
    coords = np.stack([np.linspace(40, 88, 48), np.full(48, 64.0)], -1).astype(np.float32)
    sides = []
    for yaw in (0.0, math.pi / 2):
        o, d = rays.rays_for_coords(torch.from_numpy(coords),
                                    rays.pose_from_yaw_pitch(torch.tensor(yaw), torch.tensor(0.0)),
                                    cam)
        sides.append((o.numpy(), d.numpy()))
    (o_a, d_a), (o_b, d_b) = sides
    got, want = _both(intersect.pairwise_view_intersections, jint.pairwise_view_intersections,
                      o_a, d_a, o_b, d_b, t_max=4.0, tol=5e-2)
    assert got.valid.shape == (48, 48) and bool(got.valid.any())
    _same(got, want)
    img = intersect.trace_intersections_to_screen(got, 128, 128)
    jimg = jint.trace_intersections_to_screen(want, 128, 128)
    assert img.shape == (100, 100) and float(img.max()) == 1.0
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=0)
    none = intersect.trace_intersections_to_screen(got._replace(valid=got.valid & False), 8, 8)
    assert float(none.abs().max()) == 0.0  # no valid point: an empty map, no NaN


def test_density_consistency_matches_jax():
    """Zero under one pose for both packages, and the same mean gap under
    two (f32 fields on converted weights, summation order only: 1e-4)."""
    cfg = ModelConfig(net_depth=2, net_width=16, skip_layer=9, feature_width=16,
                      view_head_width=16, pos_enc_levels=2, dir_enc_levels=1)
    jcfg = jconfig.ModelConfig(**cfg.__dict__)
    params = jmlp.init_nerf_params(jax.random.PRNGKey(0), jcfg)
    model = NerfMLP(cfg)
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    pts = np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32)
    eye = np.eye(3, dtype=np.float32)
    rot = np.array(jrays.rotation_yaw(jnp.float32(0.8)))
    with torch.no_grad():
        assert float(intersect.density_consistency(model, cfg, torch.from_numpy(pts),
                                                   torch.from_numpy(eye),
                                                   torch.from_numpy(eye))) == 0.0
        got = float(intersect.density_consistency(model, cfg, torch.from_numpy(pts),
                                                  torch.from_numpy(eye), torch.from_numpy(rot)))
    want = float(jint.density_consistency(params, jcfg, jnp.asarray(pts), jnp.asarray(eye),
                                          jnp.asarray(rot)))
    assert got > 0.0
    np.testing.assert_allclose(got, want, atol=1e-4)
