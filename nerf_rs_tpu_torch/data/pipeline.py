"""The async host batch pipeline (``--batch_mode host``), the counterpart of
``nerf_rs_tpu/data/pipeline.py``: worker threads draw (view, x, y) index
batches from the host copy of the pixel store and gather their gold pixels
(in numpy, or in the C++ assembler, ``native_loader``), ahead of the
consumer; the rays are made on the device from the indices.

On the card each worker stages its batch in pinned host memory and copies
it to the device with ``non_blocking=True`` on a side stream of its own,
then waits for that copy before it hands the batch over, so a batch in the
queue is on the device and its pinned buffers are free; the consumer marks
the tensors as used on its own stream (``record_stream``), so their memory
is not reused while the step still reads it. Host sampling of the next
batches and their copies overlap the device's work on this one.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import CameraConfig

from ..train.step import Batch
from .dataset import make_rays


class HostSampler:
    """(view_idx, xi, yi, gold) batches from a host pixel array, drawn from
    numpy's generator of ``seed``: the JAX package's draws for the same
    seed, batch for batch."""

    def __init__(self, images: np.ndarray, white_background: bool, seed, gather_fn=None):
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError(f"a (V, H, W, 4) uint8 store, got {images.dtype} {images.shape}")
        self.images = images
        self.white_background = white_background
        self.rng = np.random.default_rng(seed)
        self.num_views, self.height, self.width = images.shape[:3]
        self._gather = gather_fn  # the native (C++) gather, or None for numpy

    def sample(self, num_rays: int):
        view_idx = self.rng.integers(0, self.num_views, num_rays, dtype=np.int32)
        xi = self.rng.integers(0, self.width, num_rays, dtype=np.int32)
        yi = self.rng.integers(0, self.height, num_rays, dtype=np.int32)
        if self._gather is not None:
            gold = self._gather(self.images, view_idx, xi, yi, self.white_background)
        else:
            px = self.images[view_idx, yi, xi].astype(np.float32) / 255.0
            rgb, alpha = px[:, :3], px[:, 3:4]
            gold = rgb * alpha + (1.0 - alpha) if self.white_background else rgb
        return view_idx, xi, yi, gold


class PrefetchPipeline:
    """Background batch producer: an iterator of device Batches.

    ``num_workers`` threads each draw from their own numpy stream (seed,
    worker), so each worker's sequence of batches is fixed; the order in
    which the workers' batches interleave is the scheduler's (the batches
    are iid per ray). ``depth`` batches wait in the queue at most.
    ``use_native`` gathers with the C++ assembler, which is built at first
    use and raises if it cannot be. Close the pipeline (``close`` or a
    ``with`` block) to stop its threads."""

    def __init__(self, images: np.ndarray, camera: CameraConfig,
                 angles: Optional[np.ndarray] = None, c2w: Optional[np.ndarray] = None,
                 num_rays: int = 4096, white_background: bool = False, depth: int = 2,
                 seed: int = 0, gather_fn=None, use_native: bool = False,
                 num_workers: int = 1, device=None):
        if (angles is None) == (c2w is None):
            raise ValueError("give exactly one of angles and c2w")
        if num_workers < 1:
            raise ValueError(f"num_workers must be at least 1, got {num_workers}")
        if use_native and gather_fn is None:
            from . import native_loader

            native_loader.load()  # build now: a failure raises here, not in a worker
            gather_fn = native_loader.gather_gold
        if images.dtype != np.uint8:
            images = np.clip(images * 255.0, 0, 255).astype(np.uint8)
        if images.shape[-1] == 3:
            images = np.concatenate(
                [images, np.full(images.shape[:-1] + (1,), 255, np.uint8)], axis=-1)
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.camera = camera
        self.num_rays = num_rays
        self.mode = "angles" if angles is not None else "c2w"
        self.pose_data = torch.as_tensor(np.asarray(angles if angles is not None else c2w,
                                                    np.float32), device=self.device)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, num_workers))
        self._stop = threading.Event()
        self._error: list = []
        self._samplers = [HostSampler(images, white_background, [seed, w], gather_fn)
                          for w in range(num_workers)]
        self._threads = [threading.Thread(target=self._produce, args=(s,), daemon=True)
                         for s in self._samplers]
        for t in self._threads:
            t.start()

    def _stage(self, item, stream):
        """The batch's arrays as device tensors; on the card through pinned
        buffers and a side-stream copy that has finished on return."""
        arrays = [np.ascontiguousarray(a) for a in item]
        if self.device.type != "cuda":
            return tuple(torch.from_numpy(a) for a in arrays)
        pinned = [torch.from_numpy(a).pin_memory() for a in arrays]
        with torch.cuda.stream(stream):
            out = tuple(p.to(self.device, non_blocking=True) for p in pinned)
        stream.synchronize()  # the copy is done: the pinned buffers may go
        return out

    def _produce(self, sampler: HostSampler):
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        try:
            while not self._stop.is_set():
                item = self._stage(sampler.sample(self.num_rays), stream)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # handed to the consumer, which raises it
            self._error.append(e)
            self._stop.set()

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        while True:
            if self._error:
                raise RuntimeError("a host pipeline worker failed") from self._error[0]
            try:
                view_idx, xi, yi, gold = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                continue
        if self.device.type == "cuda":
            for t in (view_idx, xi, yi, gold):
                t.record_stream(torch.cuda.current_stream(self.device))
        view_idx, xi, yi = (t.long() for t in (view_idx, xi, yi))
        coords = torch.stack([xi, yi], dim=-1).float()
        o, d = make_rays(self.pose_data, self.mode, coords, view_idx, self.camera)
        h, w = self._samplers[0].height, self._samplers[0].width
        return Batch(origins=o, dirs=d, gold=gold, idx=(view_idx * h + yi) * w + xi)

    def close(self) -> None:
        self._stop.set()
        try:  # drain, so blocked producers see the stop flag
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
