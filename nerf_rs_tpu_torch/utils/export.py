"""Exports of a trained field, the counterpart of
``nerf_rs_tpu/utils/export.py``: sigma and RGB sampled at the centres of a
res^3 grid over [-aabb, aabb]^3 (``sample_density_grid``, x-slabs of the
eager field on the field's device), the grid as ``.npz``, and the centres of
the cells above a density threshold as a coloured ASCII PLY point cloud.
The colour is the radiance seen along +z: sigma does not depend on the
view, and the export is for inspection.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig

from ..models.mlp import apply_nerf


def cell_centres(res: int, aabb: float) -> np.ndarray:
    """The res cell centres of one axis over [-aabb, aabb], f32."""
    cell = 2.0 * aabb / res
    return np.linspace(-aabb + cell / 2.0, aabb - cell / 2.0, res, dtype=np.float32)


@torch.no_grad()
def sample_density_grid(params, model_cfg: ModelConfig, res: int = 128, aabb: float = 1.6,
                        dtype=torch.bfloat16, slab: int = 16):
    """sigma (res, res, res) and rgb (res, res, res, 3), f32 numpy arrays
    on the host, at the cell centres (axes x, y, z), through the eager
    field at ``dtype`` in slabs of ``slab`` x-planes, each slab's points as
    (slab * res, res, 3) with the view direction +z.

    A compat field is refused before anything is sampled: its radiance
    head gives RGBA, where the grid keeps RGB; the JAX function's reshape
    of those four channels into three fails on it the same way, so the JAX
    CLI's export of a compat run writes nothing either."""
    if model_cfg.compat:
        raise ValueError("export of a --compat field: its radiance head gives 4 channels "
                         "(RGBA), the grid keeps 3, as the JAX export's reshape requires")
    dev = next(params.parameters()).device
    c1d = cell_centres(res, aabb)
    grid1d = torch.from_numpy(c1d).to(dev)
    sig_out = np.empty((res, res, res), np.float32)
    rgb_out = np.empty((res, res, res, 3), np.float32)
    for x0 in range(0, res, slab):
        xs = grid1d[x0:x0 + slab]
        gx, gy, gz = torch.meshgrid(xs, grid1d, grid1d, indexing="ij")
        pts = torch.stack([gx, gy, gz], dim=-1).reshape(xs.shape[0] * res, res, 3)
        vd = torch.zeros_like(pts)
        vd[..., 2] = 1.0
        sigma, rgb = apply_nerf(params, pts, vd, model_cfg, dtype)
        b = xs.shape[0]
        sig_out[x0:x0 + b] = sigma.reshape(b, res, res).float().cpu().numpy()
        rgb_out[x0:x0 + b] = rgb.reshape(b, res, res, 3).float().cpu().numpy()
    return sig_out, rgb_out


def save_npz(path: str, sigma: np.ndarray, rgb: np.ndarray, aabb: float) -> None:
    np.savez_compressed(path, sigma=sigma, rgb=rgb, aabb=np.float32(aabb))


def occupied_points(sigma: np.ndarray, rgb: np.ndarray, aabb: float, threshold: float):
    """The centres and colours of the cells with sigma > threshold:
    (xyz (N, 3) f32, rgb8 (N, 3) uint8)."""
    c1d = cell_centres(sigma.shape[0], aabb)
    ii, jj, kk = np.nonzero(sigma > threshold)
    xyz = np.stack([c1d[ii], c1d[jj], c1d[kk]], axis=-1)
    rgb8 = np.clip(rgb[ii, jj, kk] * 255.0, 0, 255).astype(np.uint8)
    return xyz, rgb8


def save_ply(path: str, xyz: np.ndarray, rgb8: np.ndarray) -> None:
    """An ASCII PLY point cloud: float x, y, z and uchar red, green, blue."""
    if xyz.shape[0] != rgb8.shape[0]:
        raise ValueError(f"{xyz.shape[0]} points but {rgb8.shape[0]} colours")
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {xyz.shape[0]}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for (x, y, z), (r, g, b) in zip(xyz, rgb8):
            f.write(f"{x:.5f} {y:.5f} {z:.5f} {r} {g} {b}\n")
