"""Synthetic flat-sphere scene, the counterpart of the image half of
``nerf_rs_tpu/data/synthetic.py``: a white disk of radius H/4 centred on
a black screen, the same for every view, so a dataset needs no files.
"""

from __future__ import annotations

import torch

from ..config import CameraConfig


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
