"""Camera-ray generation, the counterpart of ``nerf_rs_tpu/ops/rays.py``.

Conventions are the JAX package's: yaw is a rotation about +Y, pitch
about +X, and the camera pose is R = Rx(pitch) @ Ry(yaw); rays are
rotated once and samples taken later as o + t*d.

Geometry is full f32. Every 3x3 product here is written as elementwise
multiplies and sums, so no matmul (and so no TF32 tensor-core path) is
involved: ``torch.backends.cuda.matmul.allow_tf32`` cannot degrade it.
The entry points still set that flag to False (``cli.main``), because
the kernel's plain reference needs full-f32 matmuls.

Scenes with camera-to-world poses (Blender, LLFF) take ``rays_from_c2w``
and ``ray_grid_c2w`` (Blender's convention: the camera looks down -z with
+y up, and a c2w's columns are its right, up and back axes and its
centre); forward-facing captures warp their rays into normalised device
coordinates (``ndc_rays``) when the camera asks for it (``maybe_ndc``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..config import CameraConfig


def _as_f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _matmul33(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as elementwise products."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _matvec3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) as elementwise products."""
    return (m * v[..., None, :]).sum(dim=-1)


def rotation_yaw(angle, device=None) -> torch.Tensor:
    """Rotation about +Y, batched: (...,) -> (..., 3, 3)."""
    angle = _as_f32(angle, device)
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, z, s], dim=-1),
            torch.stack([z, o, z], dim=-1),
            torch.stack([-s, z, c], dim=-1),
        ],
        dim=-2,
    )


def rotation_pitch(angle, device=None) -> torch.Tensor:
    """Rotation about +X, batched: (...,) -> (..., 3, 3)."""
    angle = _as_f32(angle, device)
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([o, z, z], dim=-1),
            torch.stack([z, c, -s], dim=-1),
            torch.stack([z, s, c], dim=-1),
        ],
        dim=-2,
    )


def pose_from_yaw_pitch(yaw, pitch, device=None) -> torch.Tensor:
    """World-from-canonical rotation Rx(pitch) @ Ry(yaw), batched."""
    return _matmul33(rotation_pitch(pitch, device), rotation_yaw(yaw, device))


def view_angle_grid(num_views: int, device=None) -> torch.Tensor:
    """Hemisphere (yaw, pitch) grid: 2*num_views yaw steps x
    num_views+1 pitch steps of pi/num_views, yaw-major ->
    (2*num_views*(num_views+1), 2)."""
    step = math.pi / num_views
    yaw = torch.arange(2 * num_views, device=device) * step
    pitch = torch.arange(num_views + 1, device=device) * step
    yy, pp = torch.meshgrid(yaw, pitch, indexing="ij")
    return torch.stack([yy.reshape(-1), pp.reshape(-1)], dim=-1)


def spherical_render_path(
    num_frames: int = 40, pitch: float = math.pi / 6, device=None
) -> torch.Tensor:
    """``num_frames`` yaw steps around the full circle at a fixed pitch
    -> (num_frames, 2) (yaw, pitch) pairs."""
    yaw = torch.arange(num_frames, dtype=torch.float32, device=device) * (
        2.0 * math.pi / num_frames)
    return torch.stack([yaw, torch.full_like(yaw, pitch)], dim=-1)


def _canonical_frame(camera: CameraConfig, device=None):
    """origin and the view / left / up unit vectors of the canonical
    camera."""
    origin = _as_f32(camera.origin, device)
    at = _as_f32(camera.at, device)
    up = _as_f32(camera.up, device)
    view = at - origin
    view = view / torch.linalg.norm(view)
    left = torch.linalg.cross(view, up)
    left = left / torch.linalg.norm(left)
    return origin, view, left, up


def pixel_directions(coords_xy, camera: CameraConfig, device=None) -> torch.Tensor:
    """Canonical unit ray directions for (..., 2) pixel coords (x, y):
    a point on the near plane offset by the half-FOV extent,
    normalized."""
    coords_xy = _as_f32(coords_xy, device)
    _, view, left, up = _canonical_frame(camera, coords_xy.device)
    off = math.tan(camera.fov / 2.0) * camera.near
    x = coords_xy[..., 0]
    y = coords_xy[..., 1]
    offset_left = off - 2.0 * off * x / camera.width
    offset_up = off - 2.0 * off * y / camera.height
    to = (
        camera.near * view
        + offset_left[..., None] * left
        + offset_up[..., None] * up
    )
    return to / torch.linalg.norm(to, dim=-1, keepdim=True)


def rays_for_coords(
    coords_xy, pose: Optional[torch.Tensor], camera: CameraConfig, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays for (..., 2) pixel coords under a (3, 3) or broadcastable
    (..., 3, 3) pose rotation (None = canonical). Returns origins and
    unit directions, both (..., 3)."""
    dirs = pixel_directions(coords_xy, camera, device)
    origin = _as_f32(camera.origin, dirs.device)
    if pose is None:
        return origin.expand(dirs.shape), dirs
    pose = _as_f32(pose, dirs.device)
    dirs = _matvec3(pose, dirs)
    origins = _matvec3(pose, origin).expand(dirs.shape)
    return origins, dirs


def ray_grid(
    pose: Optional[torch.Tensor], camera: CameraConfig, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-frame rays: (H, W, 3) origins and directions for one pose."""
    if device is None and pose is not None:
        device = torch.as_tensor(pose).device
    x = torch.arange(camera.width, dtype=torch.float32, device=device)
    y = torch.arange(camera.height, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    coords = torch.stack([xx, yy], dim=-1)  # (H, W, 2)
    return rays_for_coords(coords, pose, camera)


def rays_from_c2w(coords_xy, c2w, height: int, width: int,
                  focal: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays under the Blender / NeRF ``transforms.json`` convention: pixel
    (x, y) looks along the camera-space direction [(x - W/2) / f,
    -(y - H/2) / f, -1], rotated by c2w[:3, :3], from the origin
    c2w[:3, 3]. ``c2w`` is (..., 3|4, 4), broadcastable to the coords'
    leading shape. The directions are not normalised (the JAX package's)."""
    coords_xy = _as_f32(coords_xy)
    c2w = _as_f32(c2w, coords_xy.device)
    x, y = coords_xy[..., 0], coords_xy[..., 1]
    dirs = torch.stack([(x - width * 0.5) / focal, -(y - height * 0.5) / focal,
                        -torch.ones_like(x)], dim=-1)
    world = _matvec3(c2w[..., :3, :3], dirs)
    return c2w[..., :3, 3].expand(world.shape), world


def ray_grid_c2w(c2w, height: int, width: int,
                 focal: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-frame Blender-convention rays, (H, W, 3) each, for one 3x4 or
    4x4 pose."""
    c2w = _as_f32(c2w)
    x = torch.arange(width, dtype=torch.float32, device=c2w.device)
    y = torch.arange(height, dtype=torch.float32, device=c2w.device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return rays_from_c2w(torch.stack([xx, yy], dim=-1), c2w, height, width, focal)


def ndc_rays(origins: torch.Tensor, dirs: torch.Tensor,
             camera: CameraConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """World rays into normalised device coordinates (NeRF appendix C, eqs.
    25-26; the forward-facing / LLFF mode): the cameras sit near the
    origin looking down -z, the content beyond the ``camera.ndc_near``
    plane. Each origin first slides along its ray to z = -ndc_near; then
    o' + s d' for s in [0, 1] sweeps the ray from that plane to z = -inf,
    linear in disparity. The radiance head takes the NDC direction, as in
    the JAX package."""
    focal = camera.focal
    if focal is None:
        focal = 0.5 * camera.width / math.tan(0.5 * camera.fov)
    near = camera.ndc_near
    t = -(near + origins[..., 2]) / dirs[..., 2]
    o = origins + t[..., None] * dirs
    sx = -focal / (0.5 * camera.width)
    sy = -focal / (0.5 * camera.height)
    o_ndc = torch.stack([sx * o[..., 0] / o[..., 2], sy * o[..., 1] / o[..., 2],
                         1.0 + 2.0 * near / o[..., 2]], dim=-1)
    d_ndc = torch.stack([sx * (dirs[..., 0] / dirs[..., 2] - o[..., 0] / o[..., 2]),
                         sy * (dirs[..., 1] / dirs[..., 2] - o[..., 1] / o[..., 2]),
                         -2.0 * near / o[..., 2]], dim=-1)
    return o_ndc, d_ndc


def maybe_ndc(origins: torch.Tensor, dirs: torch.Tensor,
              camera: CameraConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ndc_rays`` when the camera asks for it (``camera.ndc``): the one
    hook every ray producer (the samplers, ``view_rays``, the render
    sweep) goes through."""
    if camera.ndc:
        return ndc_rays(origins, dirs, camera)
    return origins, dirs
