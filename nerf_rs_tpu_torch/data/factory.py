"""Dataset factory: Config -> DeviceDataset, the counterpart of
``nerf_rs_tpu/data/factory.py``: the file-free sphere scene, the
reference's multiview PNG layout on the hemisphere angle grid, LLFF
captures and Blender scenes (``split`` picks the Blender
``transforms_{split}.json`` or the LLFF holdout split). A Blender or LLFF
dataset carries its own camera (the frames' size and focal length); the
callers adopt it (``effective_config``). A host process of a
multi-host run keeps views ``[index::count]`` (``process_shard``), padded up
to ``local_multiple`` views a share by cyclic repetition (the sharded pixel
store splits them over the host's ranks), never dropped: the JAX
factory's ``_slice``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import Config

from ..ops import rays as rays_ops
from . import blender, images, synthetic
from .dataset import DeviceDataset


def effective_config(cfg: Config, dataset: DeviceDataset) -> Config:
    """``cfg`` with the dataset's camera (Blender and LLFF scenes carry
    their own intrinsics), the JAX loop's ``_effective_config``."""
    if dataset.camera != cfg.camera:
        return dataclasses.replace(cfg, camera=dataset.camera)
    return cfg


def _scene_camera(cam, scene, near, far):
    return dataclasses.replace(
        cam, width=scene.width, height=scene.height,
        fov=2.0 * math.atan(0.5 * scene.width / scene.focal), near=near, far=far,
        focal=float(scene.focal))


def _slice(process_shard, local_multiple: int, *arrays):
    """Views ``[index::count]`` of ``arrays`` (numpy or torch, views
    leading) for ``process_shard`` = (index, count), every process padded
    to the same ceil(n / count) views, then to a multiple of
    ``local_multiple``, by cyclic repetition of its own views: no view is
    dropped (a repeated view carries at most twice its peers' sampling
    weight). None: all views, padded to the multiple."""
    n = arrays[0].shape[0]
    if process_shard is None:
        locals_, idx, count, per = arrays, 0, 1, n
    else:
        idx, count = process_shard
        if not 0 <= idx < count:
            raise ValueError(f"process shard {idx} of {count}")
        locals_ = tuple(a[idx::count] for a in arrays)
        per = -(-n // count)
    m = max(local_multiple, 1)
    per = -(-per // m) * m
    k = locals_[0].shape[0]
    if k == 0:
        raise ValueError(f"process {idx}/{count} got no views")
    if per == k:
        return locals_
    reps = np.arange(per) % k
    return tuple(a[torch.as_tensor(reps, device=a.device)] if isinstance(a, torch.Tensor)
                 else a[reps] for a in locals_)


def make_dataset(cfg: Config, device=None, split: str = "train", process_shard=None,
                 local_multiple: int = 1) -> DeviceDataset:
    """The on-device dataset of ``cfg`` on ``device``; of a process's share
    of the views with ``process_shard`` or ``local_multiple`` (``_slice``)."""
    d = cfg.data
    kw = dict(white_background=cfg.render.white_background, device=device,
              multiscale_levels=d.multiscale_levels)
    n = d.num_views_per_hemisphere

    def views(*arrays):
        return _slice(process_shard, local_multiple, *arrays)

    if d.dataset in ("sphere", "flat_sphere"):
        imgs, angles = views(synthetic.sphere_scene_images(cfg.camera, 2 * n * (n + 1), device),
                             rays_ops.view_angle_grid(n, device))
        return DeviceDataset(imgs, cfg.camera, angles=angles, **kw)
    if d.dataset == "multiview_png":
        imgs, h, w = images.load_multiview_dir(d.img_dir, d.view_start, d.view_end,
                                               d.view_step)
        if (h, w) != (cfg.camera.height, cfg.camera.width):
            raise ValueError(f"images are {h}x{w} but the camera is "
                             f"{cfg.camera.height}x{cfg.camera.width}")
        angles = rays_ops.view_angle_grid(n)[d.view_start:d.view_end:d.view_step]
        if angles.shape[0] != imgs.shape[0]:
            raise ValueError(f"{imgs.shape[0]} views but {angles.shape[0]} grid angles "
                             f"(--num_views_per_hemisphere {n})")
        imgs, angles = views(imgs, angles)
        return DeviceDataset(imgs, cfg.camera, angles=angles, **kw)
    if d.dataset == "llff":
        from . import llff

        scene = llff.load_llff(d.img_dir, split=split, factor=d.llff_factor,
                               holdout=d.llff_holdout)
        cam = cfg.camera
        # NDC keeps the configured [0, 1]; metric mode takes the capture's
        # bounds unless near / far were set: on the command line
        # (near_explicit / far_explicit) or, by a library caller, by moving
        # the value off the dataclass default
        defaults = {f.name: f.default for f in dataclasses.fields(cam)}
        if cam.ndc:
            near, far = cam.near, cam.far
        else:
            near = (cam.near if d.near_explicit or cam.near != defaults["near"]
                    else scene.near)
            far = cam.far if d.far_explicit or cam.far != defaults["far"] else scene.far
        imgs, c2w = views(scene.images, scene.c2w)
        return DeviceDataset(imgs, _scene_camera(cam, scene, near, far), c2w=c2w, **kw)
    if d.dataset == "blender":
        scene = blender.load_blender(d.img_dir, split=split)
        imgs, c2w = views(scene.images, np.asarray(scene.c2w))
        return DeviceDataset(imgs,
                             _scene_camera(cfg.camera, scene, cfg.camera.near, cfg.camera.far),
                             c2w=c2w, **kw)
    raise ValueError(f"unknown dataset: {d.dataset}")
