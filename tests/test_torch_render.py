"""The PyTorch port's render slice as a whole on the CPU: full-frame
rendering of the full-width paper field against the JAX package's
``train.loop.render_frame`` on converted weights, the eager field path,
compositing and metrics, the sphere dataset, checkpoints, PNG output,
and the port's ``cli render``.
"""

import dataclasses
import os
import struct
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.data import factory as jfactory
from nerf_rs_tpu.models import mlp as jmlp
from nerf_rs_tpu.ops import rays as jrays
from nerf_rs_tpu.ops import render as jrender
from nerf_rs_tpu.parallel import dp as jdp
from nerf_rs_tpu.parallel import mesh as jmesh
from nerf_rs_tpu.train import loop as jloop
from nerf_rs_tpu_torch import cli
from nerf_rs_tpu_torch.config import CameraConfig, Config, DataConfig, ModelConfig, RenderConfig
from nerf_rs_tpu_torch.convert import params_from_numpy
from nerf_rs_tpu_torch.data.factory import make_dataset
from nerf_rs_tpu_torch.data.images import save_png
from nerf_rs_tpu_torch.kernels.fused_ray import fused_ray_render
from nerf_rs_tpu_torch.models.mlp import NerfMLP, init_nerf_params
from nerf_rs_tpu_torch.ops import rays
from nerf_rs_tpu_torch.ops import render as render_ops
from nerf_rs_tpu_torch.render import default_render_chunk, make_render, render_frame
from nerf_rs_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(2)


def _sphere_cfg(white: bool, size: int = 16, samples: int = 16) -> Config:
    return Config(camera=CameraConfig(width=size, height=size),
                  render=RenderConfig(num_samples=samples, white_background=white),
                  data=dataclasses.replace(Config().data, dataset="sphere"))


def _j(cfg):
    """The JAX package's config (or sub-config) with the port's values."""
    if isinstance(cfg, Config):
        return jconfig.Config.from_dict(cfg.to_dict())
    return getattr(jconfig, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _converted(cfg: ModelConfig, seed=0):
    params = jmlp.init_nerf_params(jax.random.PRNGKey(seed), _j(cfg))
    model = NerfMLP(cfg)
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    return params, model


def _read_png(path):
    """(H, W, C) uint8 of an 8-bit, filter-0 PNG (what save_png writes)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(kind + body)
        if kind == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert depth == 8
            c = {2: 3, 6: 4}[ctype]
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    assert not raw[:, 0].any()
    return raw[:, 1:].reshape(h, w, c)


@pytest.mark.parametrize("white", [False, True])
def test_render_frame_matches_jax(white):
    """Full-width 8x256 field, 16x16 sphere view, S=16, through the JAX
    render path (fused kernel, interpret mode) and the port's (the
    kernel's plain version on the CPU). Bars: the JAX package's
    kernel-vs-XLA bars, since both are bf16 fields with f32 sums and
    JAX's interpret-mode bf16 dot sums slightly off f32 (see
    test_torch_fused_ray.py)."""
    cfg = _sphere_cfg(white)
    params, model = _converted(cfg.model)
    jds = jfactory.make_dataset(_j(cfg))
    o_j, d_j = jds.view_rays(5)
    state = types.SimpleNamespace(params=params, fine_params=None, grid=None)
    want = jloop.render_frame(_j(cfg), state, o_j, d_j, jmesh.make_mesh(1))
    ds = make_dataset(cfg)
    o, d = ds.view_rays(5)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), atol=1e-6)
    got = render_frame(cfg, model, o, d)
    for name, g, w, tol in zip(("rgb", "depth", "acc"), got, want, (3e-3, 5e-3, 3e-3)):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, err_msg=name)
    np.testing.assert_allclose(ds.view_gold(5).numpy(), np.asarray(jds.view_gold(5)), atol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_eager_render_rays_matches_jax(dtype):
    """The non-kernel path: apply_nerf + composite. f32: summation order
    only (atol 1e-4). bf16 ("mixed"): every layer rounded to bf16 on both
    sides, so one-ulp flips propagate (atol 1e-2 on composited rgb)."""
    mcfg = ModelConfig(net_depth=4, net_width=64, skip_layer=2, feature_width=64,
                       view_head_width=32)
    rcfg = RenderConfig(num_samples=16, white_background=True)
    cam = CameraConfig(width=8, height=8)
    params, model = _converted(mcfg)
    pose = np.eye(3, dtype=np.float32)
    o_j, d_j = jrays.ray_grid(jnp.asarray(pose), _j(cam))
    o, d = rays.ray_grid(torch.from_numpy(pose), cam)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (None, None)
    want, _ = jrender.render_rays(params, o_j, d_j, jax.random.PRNGKey(0), _j(mcfg), _j(rcfg),
                                  _j(cam), randomized=False, dtype=jd)
    with torch.no_grad():
        got, fine = render_ops.render_rays(model, o, d, mcfg, rcfg, cam,
                                           randomized=False, dtype=td)
    assert fine is None
    tol = 1e-2 if dtype == "bf16" else 1e-4
    for name in ("rgb", "weights", "sigma", "depth", "acc", "ts"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=tol, err_msg=name)


def test_composite_and_psnr_match_jax():
    rng = np.random.default_rng(0)
    sigma = rng.uniform(0, 3, (6, 10)).astype(np.float32)
    colors = rng.uniform(0, 1, (6, 10, 3)).astype(np.float32)
    deltas = rng.uniform(0, 0.3, (6, 10)).astype(np.float32)
    ts = np.cumsum(deltas, -1)
    for white in (False, True):
        got = render_ops.composite(*map(torch.from_numpy, (sigma, colors, deltas)),
                                   white_background=white, ts=torch.from_numpy(ts))
        want = jrender.composite(*map(jnp.asarray, (sigma, colors, deltas)),
                                 white_background=white, ts=jnp.asarray(ts))
        for name in ("rgb", "weights", "depth", "acc"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)), atol=1e-6)
    a, b = colors[..., 0], colors[..., 1]
    np.testing.assert_allclose(
        float(render_ops.psnr(torch.from_numpy(a), torch.from_numpy(b))),
        float(jrender.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


def test_default_render_chunk_matches_jax():
    for mc in (ModelConfig(), ModelConfig(arch="factored")):
        for rc in (RenderConfig(), RenderConfig(num_samples=16), RenderConfig(num_samples=128),
                   RenderConfig(num_samples=192), RenderConfig(num_fine_samples=128)):
            for fused in (False, True):
                assert default_render_chunk(rc, fused, mc) == jdp.default_render_chunk(
                    _j(rc), fused, _j(mc))
    assert default_render_chunk(RenderConfig(), fused=True) == 262144
    # the factored field renders on the eager path: 32,768 rays of 128
    # samples, 20 chunks per 800x800 frame
    fac = default_render_chunk(RenderConfig(num_samples=128), False, ModelConfig(arch="factored"))
    assert fac == 32768 and -(-800 * 800 // fac) == 20


def test_make_render_packs_once_and_chunks_without_padding(monkeypatch):
    """Ragged chunking gives the same frame as one call; weights are
    packed once per frame, outside the chunk loop."""
    from nerf_rs_tpu_torch.kernels import fused_render

    cfg = _sphere_cfg(False, size=8, samples=8)
    model = init_nerf_params(cfg.model, 0)
    ds = make_dataset(cfg)
    o, d = (a.reshape(-1, 3) for a in ds.view_rays(0))
    packs = []
    real = fused_render.pack_weights
    monkeypatch.setattr(fused_render, "pack_weights", lambda *a: packs.append(1) or real(*a))
    whole = make_render(cfg)(model, o, d)
    chunked = make_render(cfg, chunk=23)(model, o, d)  # 64 rays -> 23 + 23 + 18
    assert len(packs) == 2
    for a, b in zip(whole, chunked):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_checkpoint_round_trip_and_latest(tmp_path):
    cfg = ModelConfig(net_depth=2, net_width=16, skip_layer=1, feature_width=16,
                      view_head_width=16)
    a = init_nerf_params(cfg, 0)
    b = init_nerf_params(cfg, 1)
    p1 = ckpt.save(a, str(tmp_path), step=7, ts=100)
    p2 = ckpt.save(b, str(tmp_path), step=9, ts=100)
    ckpt.save(a, str(tmp_path), step=3, ts=99)
    assert os.path.basename(p1) == "checkpoint-100-7.pt"
    assert ckpt.latest_checkpoint(str(tmp_path)) == p2
    assert ckpt.latest_checkpoint(str(tmp_path / "missing")) is None
    c = init_nerf_params(cfg, 2)
    assert ckpt.restore_weights(p1, c) == 7
    for k, v in a.state_dict().items():
        assert torch.equal(v, c.state_dict()[k]), k


def test_save_png_writes_what_it_is_given(tmp_path):
    rng = np.random.default_rng(0)
    for c in (3, 4):
        img = rng.uniform(-0.1, 1.1, (5, 7, c)).astype(np.float32)
        path = str(tmp_path / f"img{c}.png")
        save_png(path, torch.from_numpy(img))
        want = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(_read_png(path), want)


def test_cli_render_view_and_sweep(tmp_path, capsys):
    cfg = _sphere_cfg(False, size=16, samples=16)
    model = init_nerf_params(cfg.model, 3)
    path = ckpt.save(model, str(tmp_path / "ckpt"), step=5)
    common = ["--dataset", "sphere", "--width", "16", "--height", "16",
              "--num_samples", "16", "--load_path", path]
    assert cli.main(["render", *common, "--view", "0", "--out_dir", str(tmp_path / "v"),
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"loaded {path} (step 5)" in out
    ds = make_dataset(cfg)
    rgb, _, _ = render_frame(cfg, model, *ds.view_rays(0))
    psnr = float(render_ops.psnr(rgb, ds.view_gold(0)))
    assert f"psnr={psnr:.2f}" in out
    want = np.clip(rgb.numpy() * 255.0, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(_read_png(str(tmp_path / "v" / "view-0.png")), want)

    before = fused_ray_render.launches
    assert cli.main(["render", *common, "--frames", "2", "--out_dir", str(tmp_path / "s"),
                     "--device", "cpu"]) == 0
    assert fused_ray_render.launches == before  # CPU: the plain version, no launch
    assert sorted(os.listdir(tmp_path / "s")) == ["frame-000.png", "frame-001.png"]
    assert "rendered 2 frames of 16x16" in capsys.readouterr().out


# --occ_res, --multiscale_levels and the image datasets are ported
# (tests/test_torch_occupancy.py, tests/test_torch_multiscale.py,
# tests/test_torch_data.py); the EMA and the sharded pixel store are not
@pytest.mark.parametrize("argv", [
    ["render", "--dataset", "sphere", "--ema_decay", "0.9"],
    ["render", "--dataset", "sphere", "--shard_pixel_store", "true"],
    ["render", "--dataset", "sphere", "--compat", "true"],
])
def test_cli_refuses_unported_flags(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    assert "not ported" in capsys.readouterr().err


# train and eval are ported; what they refuse is what later slices bring
# (--preset record and eval --scales are ported since slices 3 and 4, and
# --preset pod since slice 6)
_UNPORTED = {"train": ["--accumulation_steps", "2"], "eval": ["--scenes", "a,b"],
             "export": []}


@pytest.mark.parametrize("cmd", ["train", "eval", "export"])
def test_cli_refuses_unported_commands(cmd, capsys):
    try:
        rc = cli.main([cmd, "--dataset", "sphere", *_UNPORTED[cmd]])
    except SystemExit as e:  # a later slice's flag: the parser refuses it
        rc = e.code
    assert rc == 2
    assert "not ported" in capsys.readouterr().err


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(tmp_path, capsys):
    """--device cuda (the default) without a card raises, and never falls
    back to the CPU; --device cpu runs."""
    argv = ["render", "--dataset", "sphere", "--width", "8", "--height", "8",
            "--num_samples", "8", "--view", "0", "--out_dir", str(tmp_path),
            "--save_dir", str(tmp_path / "none")]
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is available")
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv + extra)
    assert not os.listdir(tmp_path)  # nothing rendered
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert "view-0.png" in capsys.readouterr().out


def test_unported_dataset_and_render_options_raise(tmp_path):
    # the multiview PNG layout loads since slice 6: image-{i}.png views of
    # the camera's size on the hemisphere grid
    rng = np.random.default_rng(0)
    for i in range(3):
        save_png(str(tmp_path / f"image-{i}.png"), rng.uniform(size=(8, 6, 4)))
    ds = make_dataset(Config(camera=CameraConfig(width=6, height=8),
                             data=DataConfig(img_dir=str(tmp_path), view_end=3)))
    assert ds.images.shape == (3, 8, 6, 4) and ds.mode == "angles"
    for rc in (RenderConfig(compat_density_color=True), RenderConfig(compat_sampling=True)):
        with pytest.raises(NotImplementedError, match="slice"):
            make_render(Config(render=rc))
    # ported since slices 2 and 4: an occupancy grid guides the render's
    # samples, and the shared-network fast fine pass (one field, union,
    # point samples, eager) composites the union of 4 + 8 samples
    small = ModelConfig(net_depth=2, net_width=16, skip_layer=1, feature_width=16,
                        view_head_width=16)
    model = init_nerf_params(small, 0)
    o, d = torch.zeros(3, 3), torch.ones(3, 3)
    rgb, _, _ = make_render(Config(model=small, render=RenderConfig(num_samples=4, occ_res=8)))(
        model, o, d, grid=torch.ones(8, 8, 8))
    assert rgb.shape == (3, 3) and bool(torch.isfinite(rgb).all())
    _, fine = render_ops.render_rays(model, o, d, small,
                                     RenderConfig(num_samples=4, num_fine_samples=8,
                                                  share_network=True),
                                     CameraConfig(), randomized=False)
    assert fine.weights.shape == (3, 12) and bool(torch.isfinite(fine.rgb).all())
    with pytest.raises(NotImplementedError, match="slice 7"):
        render_ops.render_rays(None, torch.zeros(1, 3), torch.ones(1, 3), ModelConfig(),
                               RenderConfig(raw_noise_std=1.0), CameraConfig(),
                               randomized=True)
