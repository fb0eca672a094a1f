"""The on-device dataset, the counterpart of ``DeviceDataset`` in
``nerf_rs_tpu/data/device_dataset.py``: a uint8 RGBA pixel store and every
view's pose live on the device, the pose as (yaw, pitch) on the
hemisphere grid (``angles``: the sphere and the multiview PNG layout) or
as a camera-to-world matrix (``c2w``: Blender and LLFF scenes, whose rays
are ``rays_from_c2w``'s, warped to NDC when the camera asks for it).

The batch modes: ``sample_batch`` draws every ray its own (view, x, y)
(``per_ray``); ``sample_multiview_batch`` draws ``views_per_batch`` views
and splits the rays evenly over them (``multiview``, the reference's
batches); ``sample_batch_error_weighted`` draws a share of the rays from
the per-pixel error store (``init_error_store``, ``update_error_store``)
and the rest uniformly. Each draws from a ``torch.Generator``, and each has
a form that takes the draws from the caller (``batch_from_draws``,
``multiview_from_draws``, ``error_weighted_from_draws``), which the tests
feed the JAX sampler's own draws. ``batch_from_idx`` rebuilds a batch from
its flat pixel indices; ``view_rays`` and ``view_gold`` give one view's
full-frame rays and gold image, at full resolution or at 1/scale. With
``multiscale_levels`` > 1 the store carries a box pyramid
(``build_pyramid``) and every per-ray batch draws equal ray counts per
level. The host pipeline (``batch_mode host``) reads the store's host copy
(``host_images``, ``host_poses``): ``data/pipeline.py``.
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


def make_rays(pose_data: torch.Tensor, mode: str, coords_xy: torch.Tensor, view_idx,
              camera: CameraConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays of pixel coords under their views' poses: yaw/pitch
    (``mode`` "angles") or camera-to-world matrices ("c2w", with the
    camera's explicit focal length), warped to NDC when ``camera.ndc``."""
    if mode == "angles":
        a = pose_data[view_idx]
        pose = rays_ops.pose_from_yaw_pitch(a[..., 0], a[..., 1])
        o, d = rays_ops.rays_for_coords(coords_xy, pose, camera)
    else:
        if camera.focal is None:
            raise ValueError("camera-to-world poses need the camera's focal length")
        o, d = rays_ops.rays_from_c2w(coords_xy, pose_data[view_idx], camera.height,
                                      camera.width, camera.focal)
    return rays_ops.maybe_ndc(o, d, camera)


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
    """Multiview images and poses resident on ``device``.

    Args:
      images: (N, H, W, 3|4) uint8, or float in [0, 1].
      camera: intrinsics (with ``c2w``, ``focal`` must be set).
      angles: (N, 2) yaw/pitch per view, or
      c2w: (N, 4, 4) camera-to-world matrices (Blender convention);
        exactly one of the two.
      white_background: composite gold RGBA onto white.
      multiscale_levels: > 1 keeps the 1/2 .. 1/2^(L-1) box pyramid on the
        device beside the store, and ``sample_batch`` draws from every level.
    """

    def __init__(self, images, camera: CameraConfig, angles=None, c2w=None,
                 white_background: bool = False, device=None, multiscale_levels: int = 1):
        if (angles is None) == (c2w is None):
            raise ValueError("give exactly one of angles and c2w")
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
        self.mode = "angles" if angles is not None else "c2w"
        self.pose_data = torch.as_tensor(angles if angles is not None else c2w,
                                         dtype=torch.float32, device=images.device)
        self.multiscale_levels = multiscale_levels
        self.ms_images = None
        if multiscale_levels > 1:
            pyr = build_pyramid(self.images.cpu().numpy(), multiscale_levels, white_background)
            self.ms_images = (self.images,) + tuple(
                torch.from_numpy(p).to(self.images.device) for p in pyr[1:])

    def view_block(self, index: int, count: int) -> "DeviceDataset":
        """The dataset of the ``index``-th of ``count`` equal contiguous
        blocks of views (a rank's share of the sharded pixel store, JAX's
        store sharded on its view axis); ``num_views`` must divide."""
        if self.num_views % count:
            raise ValueError(f"{self.num_views} views do not split over {count} ranks")
        k = self.num_views // count
        views = slice(index * k, (index + 1) * k)
        poses = {"angles" if self.mode == "angles" else "c2w": self.pose_data[views]}
        return DeviceDataset(self.images[views].clone(), self.camera,
                             white_background=self.white_background,
                             multiscale_levels=self.multiscale_levels, **poses)

    @property
    def host_images(self) -> np.ndarray:
        """The pixel store on the host (the host pipeline's input)."""
        return self.images.cpu().numpy()

    @property
    def host_poses(self) -> np.ndarray:
        return self.pose_data.cpu().numpy()

    def level_counts(self, num_rays: int) -> List[int]:
        """Rays per pyramid level of a multiscale batch: equal blocks, the
        remainder on level 0."""
        L = self.multiscale_levels
        counts = [num_rays // L] * L
        counts[0] += num_rays - sum(counts)
        return counts

    def _draw(self, generator: torch.Generator, n: int, high: int) -> torch.Tensor:
        return torch.randint(0, high, (n,), generator=generator, device=self.images.device)

    def sample_batch(self, generator: torch.Generator, num_rays: int) -> Batch:
        """``per_ray`` sampling: every ray draws (view, x, y) iid on the
        device, from ``generator`` (which must live on the store's
        device). With a pyramid, level l's block of ``level_counts`` draws
        them on the 1/2^l store, in level order (``batch_from_draws``)."""
        if self.ms_images is not None:
            draws = []
            for lvl, n_l in enumerate(self.level_counts(num_rays)):
                draws.append((self._draw(generator, n_l, self.num_views),
                              self._draw(generator, n_l, self.width >> lvl),
                              self._draw(generator, n_l, self.height >> lvl)))
            return self.batch_from_draws(draws)
        view_idx = self._draw(generator, num_rays, self.num_views)
        xi = self._draw(generator, num_rays, self.width)
        yi = self._draw(generator, num_rays, self.height)
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
            o, d = make_rays(self.pose_data, self.mode, coords, view_idx, cam_l)
            gold = _gather_gold(self.ms_images[lvl], view_idx, xi, yi, self.white_background)
            radii = torch.full((xi.shape[0],), pixel_radius(cam_l), device=o.device)
            idx = (view_idx * self.height + (yi << lvl)) * self.width + (xi << lvl)
            parts.append(Batch(o, d, gold, idx=idx, radii=radii))
        return Batch(*(torch.cat(xs) for xs in zip(*parts)))

    def sample_multiview_batch(self, generator: torch.Generator, num_rays: int,
                               views_per_batch: int) -> Batch:
        """The reference's batches (``multiview``): ``views_per_batch``
        views drawn with replacement, the rays split evenly over them (so
        ``num_rays`` must divide evenly), each ray's (x, y) drawn iid."""
        if num_rays % views_per_batch:
            raise ValueError(f"num_rays {num_rays} must be divisible by views_per_batch "
                             f"{views_per_batch}")
        views = self._draw(generator, views_per_batch, self.num_views)
        return self.multiview_from_draws(views, self._draw(generator, num_rays, self.width),
                                         self._draw(generator, num_rays, self.height))

    def multiview_from_draws(self, views: torch.Tensor, xi: torch.Tensor,
                             yi: torch.Tensor) -> Batch:
        """The multiview batch of given draws: ray i is view
        ``views[i // (num_rays / len(views))]``'s pixel (xi[i], yi[i])."""
        view_idx = torch.repeat_interleave(views, xi.shape[0] // views.shape[0])
        return self._batch(view_idx, xi, yi, (view_idx * self.height + yi) * self.width + xi)

    def batch_from_idx(self, idx: torch.Tensor) -> Batch:
        """The batch a flat pixel-index vector denotes."""
        view_idx = idx // (self.height * self.width)
        rem = idx % (self.height * self.width)
        return self._batch(view_idx, rem % self.width, rem // self.width, idx)

    def _batch(self, view_idx, xi, yi, idx) -> Batch:
        coords = torch.stack([xi, yi], dim=-1).float()
        o, d = make_rays(self.pose_data, self.mode, coords, view_idx, self.camera)
        gold = _gather_gold(self.images, view_idx, xi, yi, self.white_background)
        return Batch(origins=o, dirs=d, gold=gold, idx=idx)

    # -- highest-error resampling --------------------------------------------

    def init_error_store(self, initial: float = 1.0) -> torch.Tensor:
        """The flat (views * H * W,) per-pixel error store; an optimistic
        start keeps pixels not yet seen likely to be drawn."""
        return torch.full((self.num_views * self.height * self.width,), initial,
                          dtype=torch.float32, device=self.images.device)

    def sample_batch_error_weighted(self, generator: torch.Generator, num_rays: int,
                                    err_store: torch.Tensor,
                                    error_frac: float = 0.5) -> Batch:
        """``int(num_rays * error_frac)`` rays drawn from the error store's
        distribution, the rest uniform over every pixel; ``Batch.idx``
        carries the pixel ids for ``update_error_store``."""
        num_err = int(num_rays * error_frac)
        dev = self.images.device
        u = torch.rand((num_err,), generator=generator, device=dev)
        idx_uni = self._draw(generator, num_rays - num_err,
                             self.num_views * self.height * self.width)
        return self.error_weighted_from_draws(err_store, u, idx_uni)

    def error_weighted_from_draws(self, err_store: torch.Tensor, u: torch.Tensor,
                                  idx_uni: torch.Tensor) -> Batch:
        """The error-weighted batch of given draws, the counterpart of
        ``_sample_error_weighted``: each uniform ``u`` in [0, 1) scaled to
        the store's total picks the first pixel whose running sum of
        (error + 1e-8) reaches it (the inverse CDF, the JAX function's
        searchsorted), then the uniform pixel ids ``idx_uni`` follow. The
        running sum is ``fixed_order_cumsum``'s, so one store and one ``u``
        give the same pixels on every call."""
        cdf = fixed_order_cumsum(err_store + 1e-8)
        idx_err = torch.searchsorted(cdf, (u * cdf[-1]).contiguous())
        idx_err = idx_err.clamp(0, err_store.shape[0] - 1)
        return self.batch_from_idx(torch.cat([idx_err, idx_uni.to(idx_err.dtype)]))

    # -- eval / render helpers -------------------------------------------------

    def view_rays(self, view: int, scale: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-frame (H/scale, W/scale, 3) origins and directions of one
        view, through the centers of ``scale``-wide pixel blocks."""
        camera = self.camera if scale == 1 else scaled_camera(self.camera, scale)
        if self.mode == "angles":
            a = self.pose_data[view]
            o, d = rays_ops.ray_grid(rays_ops.pose_from_yaw_pitch(a[0], a[1]), camera)
        else:
            o, d = rays_ops.ray_grid_c2w(self.pose_data[view], camera.height, camera.width,
                                         camera.focal)
        return rays_ops.maybe_ndc(o, d, camera)

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


SCAN_WIDTH = 1024  # elements a row of fixed_order_cumsum's blocks


def fixed_order_cumsum(x: torch.Tensor) -> torch.Tensor:
    """The inclusive running sum of a 1-D tensor, its additions grouped by
    the tensor's length alone: the same bits on every call. ``x`` is cut
    into rows of SCAN_WIDTH (zero-padded), each row is scanned on its own,
    the rows' totals are scanned, and each row adds the totals before it.

    A 1-D ``torch.cumsum`` on the card is a single-pass scan with decoupled
    look-back, in which each tile adds whichever of its predecessors' sums
    are ready when it looks: the grouping of float sums, and so the last
    bits of a long running sum, change from launch to launch. A scan along
    the last dim of a tensor with two or more rows takes each row in a
    fixed order on either device, so both scans here run on at least two
    rows (the totals beside a row of zeros)."""
    n = x.shape[0]
    rows = max(2, -(-n // SCAN_WIDTH))
    blocks = torch.cat([x, x.new_zeros(rows * SCAN_WIDTH - n)]).reshape(rows, SCAN_WIDTH)
    blocks = torch.cumsum(blocks, dim=1)
    totals = torch.stack([blocks[:, -1], torch.zeros_like(blocks[:, -1])])
    before = torch.cumsum(totals, dim=1)[0, :-1]
    blocks[1:] += before[:, None]
    return blocks.reshape(-1)[:n]


def update_error_store(err_store: torch.Tensor, idx: torch.Tensor, ray_err: torch.Tensor,
                       ema: float = 0.5) -> torch.Tensor:
    """EMA of each ray's error into its pixel of the error store, in place
    (returns the store): store[i] = (1 - ema) store[i] + ema err. A pixel
    drawn more than once in a batch takes the update of its last draw (in
    batch order, found through a stable sort of the ids); the JAX
    function's scatter leaves that winner undefined."""
    ids, order = torch.sort(idx, stable=True)
    last = torch.ones_like(ids, dtype=torch.bool)
    last[:-1] = ids[1:] != ids[:-1]
    pick = order[last]
    keep = idx[pick]
    err_store[keep] = (1.0 - ema) * err_store[keep] + ema * ray_err[pick].to(err_store.dtype)
    return err_store
