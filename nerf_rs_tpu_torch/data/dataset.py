"""The on-device dataset, the counterpart of ``DeviceDataset`` in
``nerf_rs_tpu/data/device_dataset.py``: a uint8 RGBA pixel store and the
(yaw, pitch) of every view live on the device. ``sample_batch`` draws the
per-ray training batch there (every ray its own view, x and y);
``batch_from_idx`` rebuilds a batch from its flat pixel indices;
``view_rays`` and ``view_gold`` give one view's full-frame rays and gold
image, at full resolution or at 1/scale. With ``multiscale_levels`` > 1
(mip-NeRF's multiscale training) the store carries a box pyramid
(``build_pyramid``) and every batch draws equal ray counts per level
(``batch_from_draws``). The multiview, host-pipeline and error-weighted
batch modes come with slice 6 of the port.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import CameraConfig

from ..ops import rays as rays_ops
from ..ops.sampling import pixel_radius
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


def build_pyramid(images: np.ndarray, levels: int,
                  white_background: bool) -> Tuple[np.ndarray, ...]:
    """The host-side box pyramid of a (V, H, W, 4) uint8 RGBA store, as
    ``nerf_rs_tpu/data/device_dataset.build_pyramid`` builds it.

    Level l > 0 stores the 2^l-box average of the level-0 gold value
    (alpha composited by the dataset's background first, then averaged:
    the order ``view_gold(v, scale)`` uses) with alpha 255, so
    ``_gather_gold`` returns the stored value in either background mode."""
    out = [images]
    v, h, w, _ = images.shape
    f = images.astype(np.float32)
    rgb, a = f[..., :3], f[..., 3:4] / 255.0
    gold = rgb * a + 255.0 * (1.0 - a) if white_background else rgb
    for lvl in range(1, levels):
        s = 1 << lvl
        if h % s or w % s:
            raise ValueError(f"a {h}x{w} store has no 1/{s} level")
        mean = gold.reshape(v, h // s, s, w // s, s, 3).mean(axis=(2, 4))
        lvl_img = np.concatenate(
            [np.clip(mean, 0, 255), np.full(mean.shape[:-1] + (1,), 255.0, np.float32)], axis=-1)
        out.append(np.round(lvl_img).astype(np.uint8))
    return tuple(out)


def scaled_camera(camera: CameraConfig, scale: int) -> CameraConfig:
    """The camera that shoots one ray per ``scale`` x ``scale`` pixel
    block: the same field of view at 1/scale of the resolution (and of the
    focal length, where it is explicit), so its pixel footprint
    (``pixel_radius``) widens by ``scale``."""
    if camera.height % scale or camera.width % scale:
        raise ValueError(f"a {camera.width}x{camera.height} camera has no 1/{scale} scale")
    return dataclasses.replace(
        camera, width=camera.width // scale, height=camera.height // scale,
        focal=None if camera.focal is None else camera.focal / scale)


class DeviceDataset:
    """Multiview images + view angles resident on ``device``.

    Args:
      images: (N, H, W, 3|4) uint8 or float in [0, 1].
      camera: intrinsics.
      angles: (N, 2) yaw/pitch per view.
      white_background: composite gold RGBA onto white.
      multiscale_levels: > 1 keeps the 1/2 .. 1/2^(L-1) box pyramid on the
        device beside the store, and ``sample_batch`` draws from every level.
    """

    def __init__(self, images: torch.Tensor, camera: CameraConfig,
                 angles: torch.Tensor, white_background: bool = False,
                 device=None, multiscale_levels: int = 1):
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
        self.multiscale_levels = multiscale_levels
        self.ms_images = None
        if multiscale_levels > 1:
            pyr = build_pyramid(self.images.cpu().numpy(), multiscale_levels, white_background)
            self.ms_images = (self.images,) + tuple(
                torch.from_numpy(p).to(self.images.device) for p in pyr[1:])

    def level_counts(self, num_rays: int) -> List[int]:
        """Rays per pyramid level of a multiscale batch: equal blocks, the
        remainder on level 0."""
        L = self.multiscale_levels
        counts = [num_rays // L] * L
        counts[0] += num_rays - sum(counts)
        return counts

    def sample_batch(self, generator: torch.Generator, num_rays: int) -> Batch:
        """``per_ray`` sampling: every ray draws (view, x, y) iid on the
        device, from ``generator`` (which must live on the store's
        device). With a pyramid, level l's block of ``level_counts`` draws
        them on the 1/2^l store, in level order (``batch_from_draws``)."""
        dev = self.images.device

        def draw(n, high):
            return torch.randint(0, high, (n,), generator=generator, device=dev)

        if self.ms_images is not None:
            draws = []
            for lvl, n_l in enumerate(self.level_counts(num_rays)):
                draws.append((draw(n_l, self.num_views), draw(n_l, self.width >> lvl),
                              draw(n_l, self.height >> lvl)))
            return self.batch_from_draws(draws)
        view_idx = draw(num_rays, self.num_views)
        xi = draw(num_rays, self.width)
        yi = draw(num_rays, self.height)
        return self._batch(view_idx, xi, yi, (view_idx * self.height + yi) * self.width + xi)

    def batch_from_draws(self, draws: Sequence[Tuple[torch.Tensor, ...]]) -> Batch:
        """The multiscale batch of given draws, the counterpart of
        ``_sample_per_ray_ms``: ``draws[l]`` = (view, x, y) on the 1/2^l
        store. Level l's rays come from a camera of focal / 2^l and carry
        its cone radius ``pixel_radius``; ``idx`` is the level-0 index of
        the block's corner pixel."""
        parts = []
        for lvl, (view_idx, xi, yi) in enumerate(draws):
            cam_l = scaled_camera(self.camera, 1 << lvl)
            coords = torch.stack([xi, yi], dim=-1).float()
            o, d = _make_rays(self.angles, coords, view_idx, cam_l)
            gold = _gather_gold(self.ms_images[lvl], view_idx, xi, yi, self.white_background)
            radii = torch.full((xi.shape[0],), pixel_radius(cam_l), device=o.device)
            idx = (view_idx * self.height + (yi << lvl)) * self.width + (xi << lvl)
            parts.append(Batch(o, d, gold, idx=idx, radii=radii))
        return Batch(*(torch.cat(xs) for xs in zip(*parts)))

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

    def view_rays(self, view: int, scale: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-frame (H/scale, W/scale, 3) origins and directions of one
        view, through the centers of ``scale``-wide pixel blocks."""
        a = self.angles[view]
        pose = rays_ops.pose_from_yaw_pitch(a[0], a[1])
        camera = self.camera if scale == 1 else scaled_camera(self.camera, scale)
        return rays_ops.ray_grid(pose, camera)

    def view_gold(self, view: int, scale: int = 1) -> torch.Tensor:
        """Gold (H/scale, W/scale, 3) f32 frame of one view; ``scale`` > 1
        box-averages it (compositing onto the background first)."""
        px = self.images[view].float() / 255.0
        rgb, alpha = px[..., :3], px[..., 3:4]
        if self.white_background:
            rgb = rgb * alpha + (1.0 - alpha)
        if scale > 1:
            h, w = self.height // scale, self.width // scale
            rgb = rgb.reshape(h, scale, w, scale, 3).mean(dim=(1, 3))
        return rgb
