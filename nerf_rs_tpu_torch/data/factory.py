"""Dataset factory: Config -> DeviceDataset, the counterpart of
``nerf_rs_tpu/data/factory.py`` for the file-free sphere scene. Image
datasets (multiview PNG, Blender, LLFF) come with slice 6 of the port.
"""

from __future__ import annotations

from ..config import Config

from ..ops import rays as rays_ops
from . import synthetic
from .dataset import DeviceDataset


def make_dataset(cfg: Config, device=None) -> DeviceDataset:
    d = cfg.data
    if d.dataset not in ("sphere", "flat_sphere"):
        raise NotImplementedError(
            f"--dataset {d.dataset} comes with slice 6 of the port "
            f"(only sphere is ported)")
    n = d.num_views_per_hemisphere
    imgs = synthetic.sphere_scene_images(cfg.camera, 2 * n * (n + 1), device)
    return DeviceDataset(
        imgs, cfg.camera, angles=rays_ops.view_angle_grid(n, device),
        white_background=cfg.render.white_background, device=device,
        multiscale_levels=d.multiscale_levels,
    )
