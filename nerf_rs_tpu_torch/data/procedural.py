"""Procedural Blender-format scenes, the counterpart of
``nerf_rs_tpu/data/procedural.py``: analytic SDF geometry with
high-frequency texture, integrated into gold frames and written in the
``transforms_{split}.json`` layout, so the quality runs need no download.

The fields (``FIELDS``): ``lego``, a studded slab, torus, twisted box and
sphere at the lego scene's scale; ``helix``, another geometry family and
texture spectrum; ``facing``, the lego field before a forward-facing rig
(LLFF / NDC convention); ``lego360`` and ``deep360``, unbounded
surroundings out to 60 and 2,500 units. Each gives (sigma, rgb) at world
points, sigma = 60 sigmoid(-sdf sharpness). The camera rigs:
``hemisphere_poses`` (the lego camera distance, upper hemisphere),
``forward_facing_poses`` and ``look_at_c2w``. ``render_gold`` integrates a
field along a frame's rays at bin midpoints (the compositing of
``ops/render.composite``), on the device in chunks of rays;
``make_blender_scene`` writes a whole scene.

The scene is defined by this integral, so a trained field's test PSNR
measures its fit, not a renderer's mismatch.
"""

from __future__ import annotations

import json
import math
import os
from typing import Tuple

import numpy as np
import torch

# lego-like camera geometry (NeRF synthetic: radius ~4.03, fov ~0.69)
CAMERA_RADIUS = 4.0311
CAMERA_ANGLE_X = 0.6911
FACING_DEPTH = 4.0
# rays x samples of one render_gold chunk: (chunk, S, 3) f32 points and
# the fields' per-sample temporaries stay near a gigabyte on the card
GOLD_CHUNK_POINTS = 1 << 23


def _v(c, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(c, dtype=like.dtype, device=like.device)


def _sd_sphere(p, c, r):
    return torch.linalg.norm(p - _v(c, p), dim=-1) - r


def _sd_box(p, c, half):
    q = torch.abs(p - _v(c, p)) - _v(half, p)
    return (torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
            + torch.clamp(q.amax(dim=-1), max=0.0))


def _sd_torus(p, c, R, r):
    q = p - _v(c, p)
    ring = torch.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2) - R
    return torch.sqrt(ring ** 2 + q[..., 2] ** 2) - r


def _twist(p, k):
    """Rotate xy by k z: the twisted box's high-frequency geometry."""
    cz, sz = torch.cos(k * p[..., 2]), torch.sin(k * p[..., 2])
    x = cz * p[..., 0] - sz * p[..., 1]
    y = sz * p[..., 0] + cz * p[..., 1]
    return torch.stack([x, y, p[..., 2]], dim=-1)


def _pick(sdfs, palette, p):
    """The union's sdf, its nearest primitive (on a tie the first, as
    jnp.argmin) and that primitive's colour."""
    prim = torch.argmin(sdfs, dim=-1)
    return sdfs.amin(dim=-1), prim, _v(palette, p)[prim]


def field(points: torch.Tensor, sharpness: float = 250.0
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Analytic (sigma, rgb) at world ``points`` (..., 3); z is up. Colours:
    a palette per primitive, modulated by a 3-D sinusoid (~12 rad/unit) and
    an 8x checker on the slab."""
    p = points
    slab = _sd_box(p, (0.0, 0.0, -0.15), (1.1, 1.1, 0.1))
    torus = _sd_torus(p, (0.0, 0.0, 0.35), 0.62, 0.16)
    ball = _sd_sphere(p, (0.0, 0.0, 0.78), 0.26)
    tbox = _sd_box(_twist(p - _v((0.55, -0.5, 0.0), p), 5.0), (0.0, 0.0, 0.3),
                   (0.16, 0.16, 0.34))
    # 4x4 stud grid on the slab
    gx = (torch.round((p[..., 0] + 0.75) / 0.5) * 0.5 - 0.75).clamp(-0.75, 0.75)
    gy = (torch.round((p[..., 1] + 0.75) / 0.5) * 0.5 - 0.75).clamp(-0.75, 0.75)
    studs = torch.linalg.norm(torch.stack([p[..., 0] - gx, p[..., 1] - gy,
                                           (p[..., 2] - 0.06) * 1.4], dim=-1), dim=-1) - 0.09
    sdf, prim, base = _pick(torch.stack([slab, torus, ball, tbox, studs], dim=-1), [
        [0.85, 0.78, 0.25],  # slab: lego yellow
        [0.80, 0.15, 0.12],  # torus: red
        [0.15, 0.35, 0.85],  # ball: blue
        [0.15, 0.75, 0.30],  # twisted box: green
        [0.85, 0.45, 0.10],  # studs: orange
    ], p)
    sigma = 60.0 * torch.sigmoid(-sdf * sharpness)
    tex = 0.5 + 0.5 * (torch.sin(12.0 * p[..., 0]) * torch.sin(12.0 * p[..., 1])
                       * torch.sin(12.0 * p[..., 2]))
    checker = 0.5 + 0.5 * torch.remainder(
        torch.floor(4.0 * p[..., 0]) + torch.floor(4.0 * p[..., 1]), 2.0)
    mod = torch.where(prim == 0, 0.35 + 0.65 * checker, 0.55 + 0.45 * tex)
    # colours stay view-independent, so any radiance model fits them
    return sigma, torch.clamp(base * mod[..., None], 0.0, 1.0)


def _sd_cylinder(p, c, r, h):
    """Capped vertical cylinder: radius r, half-height h."""
    q = p - _v(c, p)
    d = torch.stack([torch.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2) - r,
                     torch.abs(q[..., 2]) - h], dim=-1)
    return (torch.linalg.norm(torch.clamp(d, min=0.0), dim=-1)
            + torch.clamp(d.amax(dim=-1), max=0.0))


def _sd_helix(p, c, R, pitch, r, z_half):
    """Tube of radius r along a vertical helix of radius R and the given
    pitch, clipped to |z - cz| <= z_half (exact near the surface)."""
    q = p - _v(c, p)
    phase = torch.atan2(q[..., 1], q[..., 0])
    ring = torch.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2) - R
    dz = torch.remainder(q[..., 2] - pitch * phase / (2.0 * math.pi) + 0.5 * pitch,
                         pitch) - 0.5 * pitch
    return torch.maximum(torch.sqrt(ring ** 2 + dz ** 2) - r, torch.abs(q[..., 2]) - z_half)


def _sd_cone(p, c, r_base, z_height):
    """Upright cone, base radius r_base at z = cz, apex at cz + z_height."""
    q = p - _v(c, p)
    t = torch.clamp(q[..., 2] / z_height, 0.0, 1.0)
    d_rad = torch.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2) - r_base * (1.0 - t)
    return torch.maximum(d_rad, torch.maximum(-q[..., 2], q[..., 2] - z_height))


def _sd_octahedron(p, c, s):
    q = torch.abs(p - _v(c, p))
    return (q[..., 0] + q[..., 1] + q[..., 2] - s) * 0.57735027


def field_helix(points: torch.Tensor, sharpness: float = 250.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second record scene ("prochelix"): a helical tube round a
    post, a perforated plate, a cone and an octahedron, with azimuthal
    stripes and ~20 rad/unit rings; the lego field's density law."""
    p = points
    plate = _sd_box(p, (0.0, 0.0, -0.18), (1.05, 1.05, 0.07))
    gx = (torch.round((p[..., 0] + 0.8) / 0.4) * 0.4 - 0.8).clamp(-0.8, 0.8)
    gy = (torch.round((p[..., 1] + 0.8) / 0.4) * 0.4 - 0.8).clamp(-0.8, 0.8)
    hole = torch.sqrt((p[..., 0] - gx) ** 2 + (p[..., 1] - gy) ** 2) - 0.07
    plate = torch.maximum(plate, -hole)  # boolean subtraction
    post = _sd_cylinder(p, (0.0, 0.0, 0.35), 0.13, 0.55)
    helix = _sd_helix(p, (0.0, 0.0, 0.35), R=0.38, pitch=0.42, r=0.07, z_half=0.52)
    cone = _sd_cone(p, (-0.62, 0.55, -0.11), 0.30, 0.85)
    octa = _sd_octahedron(p, (0.0, 0.0, 1.10), 0.30)
    sdf, prim, base = _pick(torch.stack([plate, post, helix, cone, octa], dim=-1), [
        [0.20, 0.65, 0.65],  # plate: teal
        [0.82, 0.20, 0.62],  # post: magenta
        [0.88, 0.72, 0.20],  # helix: gold
        [0.45, 0.25, 0.75],  # cone: purple
        [0.80, 0.25, 0.20],  # octahedron: crimson
    ], p)
    sigma = 60.0 * torch.sigmoid(-sdf * sharpness)
    az = torch.atan2(p[..., 1], p[..., 0])
    stripes = 0.5 + 0.5 * torch.sin(10.0 * az + 20.0 * p[..., 2])
    rings = 0.5 + 0.5 * torch.sin(20.0 * torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2))
    mod = torch.where(prim == 0, 0.35 + 0.65 * rings, 0.50 + 0.50 * stripes)
    return sigma, torch.clamp(base * mod[..., None], 0.0, 1.0)


def field_facing(points: torch.Tensor, sharpness: float = 250.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lego field centred at world (0, 0, -FACING_DEPTH), seen by
    cameras near the origin looking down -z (the LLFF / NDC convention):
    camera depth goes onto the field's z-up axis, so the slab faces them."""
    p = points
    return field(torch.stack([p[..., 0], p[..., 1], -(p[..., 2] + FACING_DEPTH) * 1.4],
                             dim=-1), sharpness)


def field_360(points: torch.Tensor, sharpness: float = 50.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unbounded 360-degree scene ("proc360"): the lego object, a
    textured ground disc to radius 40, a ring of 8 pillars at radius 9 and
    three large spheres at 18-26 units, the far primitives sized several
    disparity samples wide at their range; softer sharpness (50)."""
    p = points
    sigma_c, rgb_c = field(p, sharpness=sharpness * 3.0)
    rad = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    ground = torch.maximum(torch.abs(p[..., 2] + 0.55) - 0.30, rad - 40.0)
    az = torch.atan2(p[..., 1], p[..., 0])
    spoke = torch.round(az / (math.pi / 4.0)) * (math.pi / 4.0)
    cx, cy = 9.0 * torch.cos(spoke), 9.0 * torch.sin(spoke)
    d_rad = torch.sqrt((p[..., 0] - cx) ** 2 + (p[..., 1] - cy) ** 2) - 1.2
    pillars = torch.maximum(d_rad, torch.abs(p[..., 2] - 2.2) - 2.8)
    far_s = torch.minimum(torch.minimum(_sd_sphere(p, (18.0, 6.0, 4.0), 5.0),
                                        _sd_sphere(p, (-14.0, -17.0, 6.0), 6.0)),
                          _sd_sphere(p, (-4.0, 24.0, 9.0), 7.0))
    sdf, prim, base = _pick(torch.stack([ground, pillars, far_s], dim=-1), [
        [0.45, 0.42, 0.38],  # ground: warm grey
        [0.70, 0.30, 0.20],  # pillars: brick
        [0.25, 0.45, 0.75],  # far spheres: blue
    ], p)
    sigma_b = 60.0 * torch.sigmoid(-sdf * sharpness)
    rings = 0.5 + 0.5 * torch.sin(3.0 * rad)
    stripes = 0.5 + 0.5 * torch.sin(12.0 * az + 1.5 * p[..., 2])
    mod = torch.where(prim == 0, 0.4 + 0.6 * rings, 0.45 + 0.55 * stripes)
    rgb_b = torch.clamp(base * mod[..., None], 0.0, 1.0)
    # the union: densities add, colour is the density-weighted mix
    sigma = sigma_c + sigma_b
    w = sigma_c / torch.clamp(sigma, min=1e-6)
    return sigma, w[..., None] * rgb_c + (1.0 - w[..., None]) * rgb_b


def field_deep(points: torch.Tensor, sharpness: float = 50.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deep unbounded scene ("deep360"): content over t in [~3, 2500]:
    field_360's near layers, landmark spheres at radius 100-160, a torus
    ring at 350 and a sky shell between radii 1300 and 2500, every far
    layer angularly textured, with scale-matched sharpness."""
    p = points
    sigma_near, rgb_near = field_360(p, sharpness=sharpness)
    R = torch.sqrt(torch.sum(p * p, dim=-1))
    az = torch.atan2(p[..., 1], p[..., 0])
    el = torch.atan2(p[..., 2], torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2))
    landmarks = torch.minimum(torch.minimum(_sd_sphere(p, (110.0, 40.0, 30.0), 24.0),
                                            _sd_sphere(p, (-80.0, -120.0, 50.0), 30.0)),
                              _sd_sphere(p, (-30.0, 150.0, 70.0), 34.0))
    ring = _sd_torus(p, (0.0, 0.0, 40.0), 350.0, 60.0)
    sky = torch.maximum(1300.0 - R, R - 2500.0)
    sdf, prim, base = _pick(torch.stack([landmarks, ring, sky], dim=-1), [
        [0.85, 0.55, 0.20],  # landmark spheres: amber
        [0.30, 0.65, 0.35],  # ring: green
        [0.40, 0.45, 0.80],  # sky shell: blue
    ], p)
    far_sharp = torch.where(prim == 2, 0.02, 0.15)
    sigma_far = 60.0 * torch.sigmoid(-sdf * far_sharp)
    stripes = 0.5 + 0.5 * torch.sin(6.0 * az) * torch.sin(8.0 * el + 1.0)
    rgb_far = torch.clamp(base * (0.45 + 0.55 * stripes)[..., None], 0.0, 1.0)
    sigma = sigma_near + sigma_far
    w = sigma_near / torch.clamp(sigma, min=1e-6)
    return sigma, w[..., None] * rgb_near + (1.0 - w[..., None]) * rgb_far


FIELDS = {"lego": field, "helix": field_helix, "facing": field_facing,
          "lego360": field_360, "deep360": field_deep}


def look_at_c2w(eye, target=(0.0, 0.0, 0.15), up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Blender-convention c2w (camera -z forward, +y up in view), float64."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    u = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, u, -fwd, eye
    return c2w


def forward_facing_poses(n: int, seed: int) -> np.ndarray:
    """n cameras jittered on a small plane near the origin, each looking at
    a point of the content plane z = -FACING_DEPTH (an LLFF-style rig)."""
    rng = np.random.default_rng(seed)
    eyes = np.stack([rng.uniform(-0.45, 0.45, n), rng.uniform(-0.45, 0.45, n),
                     rng.uniform(-0.15, 0.15, n)], axis=-1)
    targets = np.stack([rng.uniform(-0.2, 0.2, n), rng.uniform(-0.2, 0.2, n),
                        np.full(n, -FACING_DEPTH)], axis=-1)
    return np.stack([look_at_c2w(e, target=t, up=(0.0, 1.0, 0.0))
                     for e, t in zip(eyes, targets)]).astype(np.float32)


def hemisphere_poses(n: int, seed: int, radius: float = CAMERA_RADIUS) -> np.ndarray:
    """n cameras on the upper hemisphere (0.15-1.25 rad above the horizon),
    deterministic in seed; the splits use different seeds."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, 2.0 * math.pi, n)
    elev = rng.uniform(0.15, 1.25, n)
    return np.stack([look_at_c2w(radius * np.asarray([
        math.cos(t) * math.cos(e), math.sin(t) * math.cos(e), math.sin(e)]))
        for t, e in zip(theta, elev)]).astype(np.float32)


def render_gold(c2w, height: int, width: int, focal: float, near: float = 2.0,
                far: float = 6.0, num_samples: int = 512, chunk: int = 0, field_fn=field,
                space: str = "linear", device=None) -> np.ndarray:
    """Integrate the analytic field to an (H, W, 4) float frame
    (unpremultiplied rgb, alpha = acc) at ``num_samples`` bin midpoints a
    ray, even in t or (``space="disparity"``) in 1/t, on ``device`` in
    chunks of ``chunk`` rays (0: as many as GOLD_CHUNK_POINTS points
    allow)."""
    from ..ops import rays as rays_ops
    from ..ops.render import composite
    from ..ops.sampling import deltas_from_ts

    dev = torch.device(device) if device is not None else torch.device("cpu")
    o, d = rays_ops.ray_grid_c2w(torch.as_tensor(c2w, dtype=torch.float32, device=dev),
                                 height, width, focal)
    flat_o, flat_d = o.reshape(-1, 3), d.reshape(-1, 3)
    if space == "disparity":
        ts = 1.0 / torch.linspace(1.0 / near, 1.0 / far, num_samples + 1, device=dev)
    else:
        ts = torch.linspace(near, far, num_samples + 1, device=dev)
    ts = 0.5 * (ts[:-1] + ts[1:])  # bin midpoints
    chunk = chunk or max(1, GOLD_CHUNK_POINTS // num_samples)
    rgbs, accs = [], []
    with torch.no_grad():
        for i in range(0, flat_o.shape[0], chunk):
            oc, dc = flat_o[i:i + chunk], flat_d[i:i + chunk]
            pts = oc[:, None, :] + ts[None, :, None] * dc[:, None, :]
            sigma, rgb = field_fn(pts)
            tsb = ts.expand(sigma.shape)
            out = composite(sigma, rgb, deltas_from_ts(tsb, far), ts=tsb)
            rgbs.append(out.rgb)
            accs.append(out.acc)
    rgb = torch.cat(rgbs).reshape(height, width, 3).cpu().numpy()
    acc = torch.cat(accs).reshape(height, width, 1).cpu().numpy()
    un = rgb / np.maximum(acc, 1e-6)  # the PNG stores unpremultiplied rgb
    return np.clip(np.concatenate([un, acc], axis=-1), 0.0, 1.0)


def make_blender_scene(out_dir: str, size: int = 800, n_train: int = 100, n_val: int = 10,
                       n_test: int = 25, num_samples: int = 512, seed: int = 0,
                       verbose: bool = True, scene: str = "lego", device=None) -> None:
    """Write a complete Blender-format scene directory of the named field
    (``FIELDS``): PNGs and ``transforms_{train,val,test}.json``. The
    ``facing`` scene takes the forward-facing rig over [1.5, 7.5]; the
    unbounded ones integrate evenly in disparity over [0.3, 60] (lego360,
    at least 1,024 samples) or [1, 2500] (deep360, at least 3,072)."""
    from .images import save_png

    field_fn = FIELDS[scene]
    pose_fn = forward_facing_poses if scene == "facing" else hemisphere_poses
    near, far = (1.5, 7.5) if scene == "facing" else (2.0, 6.0)
    space = "linear"
    if scene == "lego360":
        near, far, space = 0.3, 60.0, "disparity"
        num_samples = max(num_samples, 1024)
    elif scene == "deep360":
        near, far, space = 1.0, 2500.0, "disparity"
        num_samples = max(num_samples, 3072)
    focal = 0.5 * size / math.tan(0.5 * CAMERA_ANGLE_X)
    for split, n, s in (("train", n_train, seed + 1), ("val", n_val, seed + 2),
                        ("test", n_test, seed + 3)):
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        poses = pose_fn(n, s)
        frames = []
        for i in range(n):
            img = render_gold(poses[i], size, size, focal, near=near, far=far,
                              num_samples=num_samples, field_fn=field_fn, space=space,
                              device=device)
            save_png(os.path.join(out_dir, split, f"r_{i}.png"), img)
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": poses[i].tolist()})
            if verbose and (i + 1) % 10 == 0:
                print(f"{split}: {i + 1}/{n} frames", flush=True)
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)
    if verbose:
        print(f"scene written to {out_dir}")
