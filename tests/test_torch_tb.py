"""The port's TensorBoard events (``utils/tb.py``), the training loop's
diagnostics, hooks and profiler window on the CPU, against the JAX
package's (``nerf_rs_tpu/utils/tb.py`` writing through ``tensorboardX``,
``train/loop._log_diagnostics``): both event files read back through
``tensorboard``'s ``EventAccumulator`` with the same tags, steps and
values (images decoded to the same pixels); each array the diagnostics
log, on the same batch, samples and weights; the run directory of a
``cli train`` (``config.json``, the events of every hook, the
``--log_densities_only`` switch, the ``--profile_steps`` trace).
"""

import io
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.data import factory as jfactory
from nerf_rs_tpu.models import mlp as jmlp
from nerf_rs_tpu.train import loop as jloop
from nerf_rs_tpu.utils import tb as jtb
from nerf_rs_tpu_torch import cli
from nerf_rs_tpu_torch.config import CameraConfig, Config, DataConfig, ModelConfig, RenderConfig
from nerf_rs_tpu_torch.convert import params_from_numpy
from nerf_rs_tpu_torch.data.factory import make_dataset
from nerf_rs_tpu_torch.models.mlp import NerfMLP
from nerf_rs_tpu_torch.ops import sampling
from nerf_rs_tpu_torch.train.loop import log_diagnostics
from nerf_rs_tpu_torch.utils import tb

torch.set_num_threads(2)

_GUIDE = {"scalars": 0, "histograms": 0, "images": 0}


def _read(run_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(run_dir), size_guidance=_GUIDE)
    acc.Reload()
    return acc


def _png(event):
    return np.asarray(Image.open(io.BytesIO(event.encoded_image_string)))


def _same_events(mine, theirs, scalar_rtol=0.0):
    """The two runs' tags, steps and values: scalars (f32 simple values),
    histograms (every field), images (size and decoded pixels)."""
    assert mine.Tags()["scalars"] == theirs.Tags()["scalars"]
    assert mine.Tags()["histograms"] == theirs.Tags()["histograms"]
    assert mine.Tags()["images"] == theirs.Tags()["images"]
    for tag in theirs.Tags()["scalars"]:
        a, b = mine.Scalars(tag), theirs.Scalars(tag)
        assert [e.step for e in a] == [e.step for e in b], tag
        np.testing.assert_allclose([e.value for e in a], [e.value for e in b], rtol=scalar_rtol,
                                   err_msg=tag)
    for tag in theirs.Tags()["histograms"]:
        for a, b in zip(mine.Histograms(tag), theirs.Histograms(tag)):
            assert a.step == b.step and a.histogram_value == b.histogram_value, tag
    for tag in theirs.Tags()["images"]:
        for a, b in zip(mine.Images(tag), theirs.Images(tag)):
            assert (a.step, a.width, a.height) == (b.step, b.width, b.height), tag
            np.testing.assert_array_equal(_png(a), _png(b), err_msg=tag)


def test_crc32c_and_the_record_framing():
    """CRC-32C's check value, the masked form TFRecord stores, and a record
    that ``tensorboard``'s reader takes back (the next test)."""
    assert tb.crc32c(b"123456789") == 0xE3069283
    assert tb.crc32c(b"") == 0
    rec = tb.tfrecord(b"abc")
    assert len(rec) == 8 + 4 + 3 + 4 and rec[12:15] == b"abc"
    assert int.from_bytes(rec[15:], "little") == tb.masked_crc32c(b"abc")


def test_event_files_match_tensorboardx(tmp_path):
    """The same calls on both loggers (hparams, scalars over steps, a
    histogram, RGB and grey images, point maps): the same events."""
    rng = np.random.default_rng(0)
    vals = rng.normal(size=2000).astype(np.float32)
    rgb = rng.uniform(-0.1, 1.1, size=(10, 12, 3)).astype(np.float32)
    grey = rng.uniform(size=(7, 5)).astype(np.float32)
    pts = rng.uniform(-1.5, 1.5, size=(400, 3)).astype(np.float32)
    w = rng.uniform(size=400).astype(np.float32)
    for mod, name in ((tb, "port"), (jtb, "jax")):
        log = mod.TBLogger(str(tmp_path), name)
        log.hparams({"train/lr": 5e-4, "model/width": 256, "flag": True})
        for i in range(3):
            log.scalars({"loss": 0.1 / (i + 1), "psnr_eval": 20.0 + i}, i * 7)
        log.histogram("density", vals, 4)
        log.screen_coords(np.stack([np.arange(50) % 8, np.arange(50) // 8], -1), 5)
        log.ray_ts(np.linspace(0.05, 2.0, 64, dtype=np.float32), 5)
        log.image("prediction", rgb, 6)
        log.image("intersections", grey, 6)
        log.point_maps(pts, 8, prefix="world")
        log.point_maps(pts, 8, weights=w, prefix="density")
        log.flush()
        log.close()
    mine = _read(tmp_path / "port")
    assert os.path.basename(tb.TBLogger(str(tmp_path), "x").path).startswith(
        "events.out.tfevents.")
    assert "hparams/train/lr" in mine.Tags()["scalars"] and "world_yz" in mine.Tags()["images"]
    _same_events(mine, _read(tmp_path / "jax"))


class _Recorder:
    """Keeps what each logger method the diagnostics call was given."""

    def __init__(self):
        self.calls = []

    def screen_coords(self, c, step):
        self.calls.append(("screen_coords", None, np.asarray(c), step))

    def ray_ts(self, ts, step):
        self.calls.append(("ray_ts", None, np.asarray(ts), step))

    def point_maps(self, p, step, weights=None, res=100, prefix="world"):
        self.calls.append(("point_maps", prefix, np.asarray(p), step))
        if weights is not None:
            self.calls.append(("point_weights", prefix, np.asarray(weights), step))

    def image(self, tag, img, step):
        self.calls.append(("image", tag, np.asarray(img), step))

    def histogram(self, tag, v, step, bins=100):
        self.calls.append(("histogram", tag, np.asarray(v), step))


def test_diagnostics_log_the_jax_arrays(tmp_path, monkeypatch):
    """``log_diagnostics`` against the JAX loop's ``_log_diagnostics`` on
    the same batch (its flat pixel indices), the same samples (JAX's draw,
    handed to the port) and converted weights: every array each logger
    method is given, in the same order and at the same step: the screen
    coordinates exactly, the points within 1e-6, the intersection map and
    the world maps exactly, the densities within 1e-4 (f32 fields). Then
    the same arrays through both event writers give the same events."""
    mcfg = ModelConfig(net_depth=2, net_width=16, skip_layer=9, feature_width=16,
                       view_head_width=16, pos_enc_levels=3, dir_enc_levels=1)
    cfg = Config(camera=CameraConfig(width=16, height=16), model=mcfg,
                 render=RenderConfig(num_samples=8), data=DataConfig(dataset="sphere"))
    jcfg = jconfig.Config.from_dict(cfg.to_dict())
    params = jmlp.init_nerf_params(jax.random.PRNGKey(2), jcfg.model)
    model = NerfMLP(mcfg)
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    jds, ds = jfactory.make_dataset(jcfg), make_dataset(cfg)
    idx = np.random.default_rng(5).integers(0, ds.num_views * 256, size=300)
    jrec, rec = _Recorder(), _Recorder()
    jloop._log_diagnostics(jrec, jds, jcfg, 202, jax.random.PRNGKey(0),
                           batch=jds.batch_from_idx(jnp.asarray(idx, jnp.int32)),
                           state=types.SimpleNamespace(params=params))
    ts = torch.from_numpy(np.array(next(c[2] for c in jrec.calls if c[0] == "ray_ts")))
    monkeypatch.setattr(sampling, "stratified_ts", lambda *a, **kw: ts)
    log_diagnostics(rec, ds, cfg, 202, batch=ds.batch_from_idx(torch.from_numpy(idx)),
                    state=types.SimpleNamespace(params=model))
    assert [c[:2] for c in rec.calls] == [c[:2] for c in jrec.calls]
    assert [c[0] for c in rec.calls][:3] == ["screen_coords", "ray_ts", "point_maps"]
    for (kind, tag, got, step), (_, _, want, jstep) in zip(rec.calls, jrec.calls):
        assert step == jstep == 202 and got.shape == want.shape, (kind, tag)
        tol = {"point_maps": 1e-6, "histogram": 1e-4, "point_weights": 1e-4}.get(kind, 0.0)
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=f"{kind} {tag}")
    for mod, sink, name in ((tb, rec, "port"), (jtb, jrec, "jax")):
        log = mod.TBLogger(str(tmp_path), name)
        for kind, tag, arr, step in sink.calls:
            if kind == "screen_coords":
                log.screen_coords(arr, step)
            elif kind == "ray_ts":
                log.ray_ts(arr, step)
            elif kind == "image":
                log.image(tag, arr, step)
            elif kind == "point_maps" and tag == "world":
                log.point_maps(arr, step, prefix=tag)
        log.close()
    _same_events(_read(tmp_path / "port"), _read(tmp_path / "jax"))


def _train(tmp_path, *extra):
    logs = tmp_path / "logs"
    argv = ["train", "--dataset", "sphere", "--width", "8", "--height", "8", "--num_samples",
            "8", "--num_rays", "32", "--num_iter", "13", "--eval_steps", "6", "--logging_steps",
            "4", "--save_dir", str(tmp_path / "ck"), "--log_dir", str(logs),
            "--run_name", "run", "--device", "cpu", *extra]
    assert cli.main(argv) == 0
    return logs / "run"


def test_cli_train_writes_the_run_directory(tmp_path, capsys):
    """A 13-step ``cli train``: ``config.json`` (the run's config, as the
    JAX loop writes it), the hparams at step 0, the loss at every step, at
    the logging steps 4, 8, 12 the throughput, ``psnr_train`` and the
    diagnostics, at the eval steps 6 and 12 the eval scalars and the
    prediction and depth images; a ``--profile_steps 2`` window over steps
    10 and 11 as a Chrome trace in the run directory that names the train
    step's operators."""
    run = _train(tmp_path, "--profile_steps", "2")
    out = capsys.readouterr().out
    cfg = json.load(open(run / "config.json"))
    assert cfg["train"]["num_iter"] == 13 and cfg["train"]["profile_steps"] == 2
    acc = _read(run)
    tags = acc.Tags()
    assert {"loss", "psnr_train", "step_time_ms", "rays_per_sec", "psnr_eval", "mse_eval",
            "ssim_eval", "hparams/train/learning_rate"} <= set(tags["scalars"])
    assert [e.step for e in acc.Scalars("loss")] == list(range(13))
    assert [e.step for e in acc.Scalars("psnr_train")] == [4, 8, 12]
    assert [e.step for e in acc.Scalars("psnr_eval")] == [6, 12]
    assert {"screen_x", "screen_y", "t", "density"} <= set(tags["histograms"])
    assert {"prediction", "depth", "intersections", "world_yx", "world_zx", "world_yz",
            "density_yx", "density_zx", "density_yz"} <= set(tags["images"])
    assert [e.step for e in acc.Images("prediction")] == [6, 12]
    assert _png(acc.Images("prediction")[0]).shape == (8, 8, 3)
    traces = [f for f in os.listdir(run) if f.startswith("trace-") and f.endswith(".json")]
    assert len(traces) == 1 and f"profiler trace written to {run / traces[0]}" in out
    events = json.load(open(run / traces[0]))["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_log_densities_only_drops_the_eval_images(tmp_path):
    acc = _read(_train(tmp_path, "--log_densities_only", "true"))
    assert "prediction" not in acc.Tags()["images"] and "depth" not in acc.Tags()["images"]
    assert "density" in acc.Tags()["histograms"] and "psnr_eval" in acc.Tags()["scalars"]
