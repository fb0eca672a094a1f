"""The render half of the on-device dataset, the counterpart of
``DeviceDataset`` in ``nerf_rs_tpu/data/device_dataset.py``: a uint8
RGBA pixel store and the (yaw, pitch) of every view live on the device;
``view_rays`` and ``view_gold`` give one view's full-frame rays and gold
image. Batch sampling for training comes with the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nerf_rs_tpu.config import CameraConfig

from ..ops import rays as rays_ops


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
