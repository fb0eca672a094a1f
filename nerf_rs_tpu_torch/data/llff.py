"""LLFF forward-facing captures (``poses_bounds.npy`` and an images
directory), the counterpart of ``nerf_rs_tpu/data/llff.py``.

The format: an (N, 17) array, each row a flattened 3x5 matrix [R | t |
hwf] and the view's [near, far] bounds; the images in ``images/`` (or
``images_{factor}/``), sorted by name, one per row. LLFF's pose columns are
[down, right, back]; ``rays_from_c2w`` takes Blender's [right, up, back],
so the columns become [right, -down, back]. The poses are then recentred
(the average pose becomes the identity) and rescaled so the nearest bound
sits at ``1 / scale_near``, just beyond the NDC warp's ndc_near = 1 plane.
The images are PNGs (``images.load_image``): the card has no JPEG
decoder, and a ``.jpg`` capture raises, naming the file.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np

from .images import box_downsample, load_image

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".JPG", ".PNG")


class LLFFScene(NamedTuple):
    images: np.ndarray  # (N, H, W, C) uint8
    c2w: np.ndarray  # (N, 4, 4) float32, Blender convention [r, u, back]
    height: int
    width: int
    focal: float  # scaled to the loaded image resolution
    near: float  # scene bounds AFTER rescaling (min/max over views)
    far: float


def _avg_pose(c2w: np.ndarray) -> np.ndarray:
    """Average camera: mean position, mean viewing direction, mean up —
    re-orthogonalized. (3, 4)."""
    center = c2w[:, :3, 3].mean(0)
    back = _normalize(c2w[:, :3, 2].sum(0))  # +z column = back
    up = c2w[:, :3, 1].sum(0)
    right = _normalize(np.cross(up, back))
    up = _normalize(np.cross(back, right))
    return np.stack([right, up, back, center], axis=-1)


def _normalize(v):
    n = np.linalg.norm(v)
    if n < 1e-8:
        raise ValueError(
            "degenerate capture: average camera direction/up cancels "
            "to zero (e.g. a symmetric inward-facing rig) — disable "
            "recentering or fix the poses"
        )
    return v / n


def _pad4(m: np.ndarray) -> np.ndarray:
    out = np.tile(np.eye(4, dtype=np.float32), m.shape[:-2] + (1, 1))
    out[..., :3, :4] = m[..., :3, :4]
    return out


def recenter_poses(c2w: np.ndarray) -> np.ndarray:
    """World frame <- average-camera frame: after this the mean pose is
    the identity (camera cluster at the origin looking down -z), which
    is exactly the frustum the NDC warp covers."""
    avg = _pad4(_avg_pose(c2w)[None])[0]
    return (np.linalg.inv(avg) @ _pad4(c2w)).astype(np.float32)


def load_poses_bounds(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse poses_bounds.npy -> (c2w (N,4,4) Blender-convention,
    hwf (N, 3), bounds (N, 2)). Pure format decoding, no normalization."""
    arr = np.load(path)
    if arr.ndim != 2 or arr.shape[1] != 17:
        raise ValueError(
            f"{path}: expected (N, 17) poses_bounds, got {arr.shape}"
        )
    mats = arr[:, :15].reshape(-1, 3, 5)
    bounds = arr[:, 15:17]
    hwf = mats[:, :, 4]
    pose = mats[:, :, :4]  # columns [down, right, back | t]
    c2w34 = np.concatenate(
        [pose[:, :, 1:2], -pose[:, :, 0:1], pose[:, :, 2:4]], axis=2
    )  # -> [right, up, back | t]
    return _pad4(c2w34), hwf.astype(np.float64), bounds.astype(np.float64)


def load_llff(
    scene_dir: str,
    split: str = "train",
    factor: int = 1,
    holdout: int = 8,
    recenter: bool = True,
    rescale: bool = True,
    scale_near: float = 0.75,
    max_frames: Optional[int] = None,
) -> LLFFScene:
    """Load an LLFF capture directory.

    ``factor``: load from ``images_{factor}/`` when present, else
    decimate ``images/`` by the integer factor (focal scales with it).
    ``holdout``: the community split — every ``holdout``-th view is
    test, the rest train ("llffhold=8"); 0 = everything in both splits.
    ``rescale``: scale translations + bounds by 1/(scale_near *
    min(near bound)) so the nearest scene content sits at
    1/scale_near, just beyond t=1 — the ndc_near=1 world plane.
    ``split``: "train" | "test" | "all".
    """
    c2w, hwf, bounds = load_poses_bounds(
        os.path.join(scene_dir, "poses_bounds.npy")
    )
    n = c2w.shape[0]

    img_dir = os.path.join(scene_dir, "images")
    decimate = max(factor, 1)
    if factor > 1 and os.path.isdir(
        os.path.join(scene_dir, f"images_{factor}")
    ):
        img_dir = os.path.join(scene_dir, f"images_{factor}")
        decimate = 1
    names = sorted(
        f for f in os.listdir(img_dir) if f.endswith(_IMG_EXTS)
    )
    if len(names) != n:
        raise ValueError(
            f"{img_dir}: {len(names)} images but poses_bounds has {n} rows"
        )

    if rescale:
        # Canonical LLFF normalization: sc = 1/(bd_factor * min(near)).
        # min(near) * sc = 1/scale_near = 1.333 — just BEYOND the
        # ndc_near=1 world plane that ndc_rays shifts origins to, so the
        # nearest content is never clipped. (scale_near/min(near) — the
        # inverted form — would land it at 0.75, INSIDE the near plane.)
        sc = 1.0 / (scale_near * float(bounds[:, 0].min()))
        c2w = c2w.copy()
        c2w[:, :3, 3] *= sc
        bounds = bounds * sc
    if recenter:
        c2w = recenter_poses(c2w)

    idx = np.arange(n)
    if holdout > 0:
        test = idx[::holdout]
        if split == "test":
            idx = test
        elif split == "train":
            idx = np.asarray([i for i in idx if i % holdout != 0])
        elif split != "all":
            raise ValueError(f"unknown split: {split}")
    if max_frames is not None:
        idx = idx[:max_frames]

    imgs = []
    for i in idx:
        img = load_image(os.path.join(img_dir, names[i]))
        if decimate > 1:
            img = box_downsample(img, decimate)
        imgs.append(img)
    images = np.stack(imgs, axis=0)
    h, w = images.shape[1:3]
    # hwf is per-view; LLFF captures share intrinsics by construction
    # (one camera, COLMAP SIMPLE_RADIAL). Real captures sometimes carry
    # slightly refined per-view values, so a spread within 2% gets a
    # warning and the per-view average; only a gross mismatch (different
    # cameras, a corrupted file) is an error.
    if not np.allclose(hwf, hwf[0:1], rtol=0.02):
        raise ValueError(
            "per-view intrinsics differ grossly across poses_bounds "
            f"rows (hwf range {hwf.min(0)}..{hwf.max(0)}); this loader "
            "assumes a shared-intrinsics capture"
        )
    if not np.allclose(hwf, hwf[0:1], rtol=1e-3):
        warnings.warn(
            "per-view intrinsics differ slightly across poses_bounds "
            f"rows (hwf range {hwf.min(0)}..{hwf.max(0)}); averaging",
            stacklevel=2,
        )
    hwf_mean = hwf.mean(axis=0)
    focal = float(hwf_mean[2]) * (w / float(hwf_mean[1]))
    return LLFFScene(
        images=images,
        c2w=c2w[idx].astype(np.float32),
        height=h,
        width=w,
        focal=focal,
        near=float(bounds[:, 0].min()),
        far=float(bounds[:, 1].max()),
    )
