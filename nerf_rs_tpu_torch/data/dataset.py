"""The on-device dataset, the counterpart of ``DeviceDataset`` in
``nerf_rs_tpu/data/device_dataset.py``: a uint8 RGBA pixel store and the
(yaw, pitch) of every view live on the device. ``sample_batch`` draws the
per-ray training batch there (every ray its own view, x and y);
``batch_from_idx`` rebuilds a batch from its flat pixel indices;
``view_rays`` and ``view_gold`` give one view's full-frame rays and gold
image. The multiview, host-pipeline, multiscale and error-weighted batch
modes come with slice 6 of the port.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import CameraConfig

from ..ops import rays as rays_ops
from ..train.step import Batch


def _gather_gold(images: torch.Tensor, view_idx, xi, yi,
                 white_background: bool) -> torch.Tensor:
    px = images[view_idx, yi, xi].float() / 255.0
    rgb, alpha = px[..., :3], px[..., 3:4]
    if white_background:
        rgb = rgb * alpha + (1.0 - alpha)
    return rgb


def _make_rays(angles: torch.Tensor, coords_xy: torch.Tensor, view_idx,
               camera: CameraConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays of pixel coords under their views' yaw/pitch poses."""
    a = angles[view_idx]
    pose = rays_ops.pose_from_yaw_pitch(a[..., 0], a[..., 1])
    return rays_ops.rays_for_coords(coords_xy, pose, camera)


class DeviceDataset:
    """Multiview images + view angles resident on ``device``.

    Args:
      images: (N, H, W, 3|4) uint8 or float in [0, 1].
      camera: intrinsics.
      angles: (N, 2) yaw/pitch per view.
      white_background: composite gold RGBA onto white.
    """

    def __init__(self, images: torch.Tensor, camera: CameraConfig,
                 angles: torch.Tensor, white_background: bool = False,
                 device=None):
        images = torch.as_tensor(images, device=device)
        if images.dtype != torch.uint8:
            # truncation toward zero, as the JAX store's astype(uint8)
            images = (images.float() * 255.0).clamp(0, 255).to(torch.uint8)
        if images.shape[-1] == 3:
            alpha = torch.full(images.shape[:-1] + (1,), 255, dtype=torch.uint8,
                               device=images.device)
            images = torch.cat([images, alpha], dim=-1)
        self.images = images.contiguous()
        self.num_views, self.height, self.width = images.shape[:3]
        self.camera = camera
        self.white_background = white_background
        self.angles = torch.as_tensor(angles, dtype=torch.float32,
                                      device=images.device)

    def sample_batch(self, generator: torch.Generator, num_rays: int) -> Batch:
        """``per_ray`` sampling: every ray draws (view, x, y) iid on the
        device, from ``generator`` (which must live on the store's
        device)."""
        dev = self.images.device

        def draw(high):
            return torch.randint(0, high, (num_rays,), generator=generator, device=dev)

        view_idx = draw(self.num_views)
        xi = draw(self.width)
        yi = draw(self.height)
        return self._batch(view_idx, xi, yi, (view_idx * self.height + yi) * self.width + xi)

    def batch_from_idx(self, idx: torch.Tensor) -> Batch:
        """The batch a flat pixel-index vector denotes."""
        view_idx = idx // (self.height * self.width)
        rem = idx % (self.height * self.width)
        return self._batch(view_idx, rem % self.width, rem // self.width, idx)

    def _batch(self, view_idx, xi, yi, idx) -> Batch:
        coords = torch.stack([xi, yi], dim=-1).float()
        o, d = _make_rays(self.angles, coords, view_idx, self.camera)
        gold = _gather_gold(self.images, view_idx, xi, yi, self.white_background)
        return Batch(origins=o, dirs=d, gold=gold, idx=idx)

    def view_rays(self, view: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-frame (H, W, 3) origins and directions of one view."""
        a = self.angles[view]
        pose = rays_ops.pose_from_yaw_pitch(a[0], a[1])
        return rays_ops.ray_grid(pose, self.camera)

    def view_gold(self, view: int) -> torch.Tensor:
        """Gold (H, W, 3) f32 frame of one view."""
        px = self.images[view].float() / 255.0
        rgb, alpha = px[..., :3], px[..., 3:4]
        if self.white_background:
            rgb = rgb * alpha + (1.0 - alpha)
        return rgb
