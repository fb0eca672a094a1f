"""Blender synthetic scenes (``transforms_{split}.json``), the counterpart
of ``nerf_rs_tpu/data/blender.py``: ``camera_angle_x`` and each frame's
4x4 camera-to-world ``transform_matrix``, the frames decoded by the port's
own PNG reader (``images.load_image``).
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional

import numpy as np

from .images import box_downsample, load_image


class BlenderScene(NamedTuple):
    images: np.ndarray  # (N, H, W, 4) uint8
    c2w: np.ndarray  # (N, 4, 4) float32 camera-to-world
    height: int
    width: int
    focal: float


def load_blender(scene_dir: str, split: str = "train", downscale: int = 1,
                 max_frames: Optional[int] = None) -> BlenderScene:
    """Load ``{scene_dir}/transforms_{split}.json`` and its frames (a
    ``file_path`` without an extension is a PNG). ``downscale``
    box-averages the frames by that integer factor, and the focal length
    follows; ``max_frames`` keeps the first frames only."""
    with open(os.path.join(scene_dir, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    frames = meta["frames"]
    if max_frames is not None:
        frames = frames[:max_frames]
    imgs, poses = [], []
    for fr in frames:
        fp = fr["file_path"]
        if not os.path.splitext(fp)[1]:
            fp = fp + ".png"
        img = load_image(os.path.join(scene_dir, fp))
        if downscale > 1:
            img = box_downsample(img, downscale)
        imgs.append(img)
        poses.append(np.asarray(fr["transform_matrix"], dtype=np.float32))
    images = np.stack(imgs, axis=0)
    h, w = images.shape[1:3]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    return BlenderScene(images=images, c2w=np.stack(poses, axis=0), height=h, width=w,
                        focal=focal)
