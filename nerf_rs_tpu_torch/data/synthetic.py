"""Synthetic debug scenes, the counterpart of ``nerf_rs_tpu/data/synthetic.py``:
the flat-sphere images (a white disk of radius H/4 centred on a black
screen, the same for every view, so a dataset needs no files) and the
reference's analytic sphere density (1 inside radius 0.5), an oracle of the
field at any world point (``sphere_density``, ``render_sphere_gold``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import CameraConfig


def sphere_density(points: torch.Tensor, radius: float = 0.5) -> torch.Tensor:
    """The gold density at (..., 3) points: 1 where |p| < radius, else 0
    (the reference's dist < 0.5 => sigma = 1 rule), f32."""
    return (torch.linalg.norm(points, dim=-1) < radius).float()


def render_sphere_gold(origins: torch.Tensor, dirs: torch.Tensor, ts: torch.Tensor,
                       radius: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gold (per-sample density (..., S), per-ray hit mask (...,)) of
    rays (..., 3) sampled at distances ``ts`` (..., S) against the analytic
    sphere: the oracle a learned field is held to at the same world
    points."""
    pts = origins[..., None, :] + ts[..., :, None] * dirs[..., None, :]
    sigma = sphere_density(pts, radius)
    return sigma, (torch.amax(sigma, dim=-1) > 0).float()


def sphere_image(camera: CameraConfig, radius_frac: float = 0.25,
                 device=None) -> torch.Tensor:
    """(H, W, 4) f32 gold image: white inside the disk, black outside,
    alpha 1."""
    y = torch.arange(camera.height, dtype=torch.float32, device=device)
    x = torch.arange(camera.width, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    cy, cx = camera.height / 2.0, camera.width / 2.0
    r = torch.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    inside = (r < camera.height * radius_frac).float()
    return torch.stack([inside, inside, inside, torch.ones_like(inside)], dim=-1)


def sphere_scene_images(camera: CameraConfig, num_views: int = 84,
                        device=None) -> torch.Tensor:
    """(num_views, H, W, 4): the same frame for every view, as a
    broadcast view of one image."""
    img = sphere_image(camera, device=device)
    return img.expand(num_views, *img.shape)
