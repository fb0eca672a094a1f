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
    # compat rendering is ported since slice 10 (tests/test_torch_compat.py):
    # each compat option on the paper field renders, and the grey composite
    # of the density is the same colour in every channel
    for rc in (RenderConfig(num_samples=4, compat_density_color=True),
               RenderConfig(num_samples=4, compat_sampling=True)):
        rgb, _, _ = make_render(Config(model=small, render=rc))(model, o, d)
        assert rgb.shape == (3, 3) and bool(torch.isfinite(rgb).all())
        if rc.compat_density_color:
            assert torch.equal(rgb[:, 0], rgb[:, 1]) and torch.equal(rgb[:, 0], rgb[:, 2])


# --- slice 7: sigma noise and render --depth / --gif ---

NOISE_MODEL = ModelConfig(net_depth=2, net_width=16, skip_layer=1, feature_width=16,
                          view_head_width=16, pos_enc_levels=2, dir_enc_levels=1)


@pytest.mark.parametrize("sigma_act", ["relu", "softplus"])
def test_apply_nerf_sigma_noise_matches_jax(sigma_act):
    """The paper's sigma noise on the raw density: the port's field fed
    JAX's own draw (``jax.random.normal`` of the noise key) against the JAX
    field with that key, f32 (test_apply_nerf_f32_matches_jax's 1e-4:
    summation order only; the noise adds one f32 product on each side)."""
    mcfg = dataclasses.replace(NOISE_MODEL, sigma_activation=sigma_act)
    params, model = _converted(mcfg, seed=4)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (6, 5, 3)).astype(np.float32)
    vd = rng.normal(size=(6, 1, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(9)
    s_j, c_j = jmlp.apply_nerf(params, jnp.asarray(pts), jnp.asarray(vd), _j(mcfg),
                               noise_std=0.7, noise_key=key)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (6, 5), jnp.float32)))
    with torch.no_grad():
        s_p, c_p = model.forward(torch.from_numpy(pts), torch.from_numpy(vd))
        s_n, c_n = render_ops.apply_nerf(model, torch.from_numpy(pts), torch.from_numpy(vd),
                                         mcfg, noise_std=0.7, noise=eps)
    np.testing.assert_allclose(s_n.numpy(), np.asarray(s_j), atol=1e-4)
    np.testing.assert_allclose(c_n.numpy(), np.asarray(c_j), atol=1e-4)
    assert not torch.allclose(s_n, s_p) and torch.equal(c_n, c_p)  # noise moves sigma only


@pytest.mark.parametrize("fine_mode,shared", [("union", False), ("standalone", False),
                                              ("union", True)])
def test_render_rays_sigma_noise_matches_jax(fine_mode, shared, monkeypatch):
    """A randomized hierarchical render with raw_noise_std 1: both packages
    on JAX's draws (the coarse jitter from its coarse key, the fine draws
    from its fine key on its coarse weights, handed to the port through
    its samplers) and JAX's noise, one draw a pass (fold_in(key, 1) of each
    pass's key), the separate fine field, the standalone pass and the
    shared-network fast pass: every output within 1e-4 (f32 eager fields,
    summation order only)."""
    from nerf_rs_tpu.ops import sampling as jsamp
    from nerf_rs_tpu_torch.ops import sampling

    rcfg = RenderConfig(num_samples=8, num_fine_samples=8, fine_mode=fine_mode,
                        share_network=shared, raw_noise_std=1.0)
    cam = CameraConfig(width=4, height=3)
    params, model = _converted(NOISE_MODEL, seed=5)
    fparams, fmodel = (None, None) if shared else _converted(NOISE_MODEL, seed=6)
    o_j, d_j = jrays.ray_grid(jnp.asarray(np.eye(3, dtype=np.float32)), _j(cam))
    key = jax.random.PRNGKey(3)
    want_c, want_f = jrender.render_rays(params, o_j, d_j, key, _j(NOISE_MODEL), _j(rcfg),
                                         _j(cam), fine_params=fparams, randomized=True)
    n = 12
    k_coarse, k_fine = jax.random.split(key)
    ts = np.array(jsamp.stratified_ts(k_coarse, n, 8, cam.near, cam.far, True))
    w = np.asarray(want_c.weights).reshape(n, 8)
    bins = np.concatenate([ts[:, :1], 0.5 * (ts[:, 1:] + ts[:, :-1]), ts[:, -1:]], -1)
    fine_ts = np.array(jsamp.sample_pdf(k_fine, jnp.asarray(bins), jnp.asarray(w), 8, True))
    fine_n = 8 if (fine_mode == "standalone" or shared) else 16
    noise = [np.array(jax.random.normal(jax.random.fold_in(k, 1), (n, s)))
             for k, s in ((k_coarse, 8), (k_fine, fine_n))]
    monkeypatch.setattr(sampling, "stratified_ts", lambda *a, **kw: torch.from_numpy(ts))
    monkeypatch.setattr(sampling, "sample_pdf", lambda *a, **kw: torch.from_numpy(fine_ts))
    draws = [torch.from_numpy(x) for x in noise]
    monkeypatch.setattr(render_ops, "standard_normal",
                        lambda shape, *a: draws.pop(0).reshape(shape))
    o, d = rays.ray_grid(torch.eye(3), cam)
    with torch.no_grad():
        got_c, got_f = render_ops.render_rays(model, o, d, NOISE_MODEL, rcfg, cam,
                                              randomized=True, fine_params=fmodel)
    assert not draws  # one draw a pass, each taken
    for got, want in ((got_c, want_c), (got_f, want_f)):
        for name in ("rgb", "sigma", "weights", "depth", "acc", "ts"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)), atol=1e-4,
                                       err_msg=name)
    assert float(got_c.sigma.max()) > 0.0


def test_sigma_noise_is_a_draw_per_pass_and_leaves_the_kernels(monkeypatch):
    """Drawn from the generator, the coarse and fine passes' noise are
    independent draws (the JAX package's test_sigma_noise_coarse_fine_keys
    _differ: a zero sigma head makes sigma relu(noise) exactly); a render
    that asks for the kernel takes the eager field under noise, and the
    train step autograd (whole_ray_supported is off), as in the JAX
    package; without randomized passes no noise is drawn."""
    from nerf_rs_tpu_torch.kernels import fused_ray
    from nerf_rs_tpu_torch.train import step

    model = init_nerf_params(NOISE_MODEL, 0)
    with torch.no_grad():
        model.sigma.w.zero_()
        model.sigma.b.zero_()
    rcfg = RenderConfig(num_samples=8, num_fine_samples=8, raw_noise_std=5.0)
    o = torch.zeros(4, 3)
    o[:, 2] = -1.0
    d = torch.zeros(4, 3)
    d[:, 2] = 1.0
    calls = []
    real = fused_ray.fused_ray_render
    monkeypatch.setattr(fused_ray, "fused_ray_render",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with torch.no_grad():
        coarse, fine = render_ops.render_rays(model, o, d, NOISE_MODEL, rcfg, CameraConfig(),
                                              randomized=True, use_fused=True,
                                              generator=torch.Generator().manual_seed(0),
                                              fine_params=model)
        assert calls == []  # the eager field under noise
        assert float(coarse.sigma.max()) > 0.0 and float(fine.sigma.max()) > 0.0
        assert not np.allclose(np.sort(coarse.sigma.numpy(), -1),
                               np.sort(fine.sigma.numpy(), -1)[:, -8:])
        quiet, _ = render_ops.render_rays(model, o, d, NOISE_MODEL, rcfg, CameraConfig(),
                                          randomized=False, use_fused=True, fine_params=model)
        assert calls and float(quiet.sigma.max()) == 0.0  # no noise: the kernel route
    cfg = Config(model=NOISE_MODEL, render=rcfg, use_whole_ray_train=True)
    assert not step.whole_ray_supported(cfg)
    assert step.whole_ray_supported(dataclasses.replace(cfg, render=RenderConfig()))


def test_cli_render_depth_and_gif(tmp_path, capsys):
    """``render --depth --gif``: beside each sweep frame (and the --view
    frame) a ``-depth.png`` (depth / far, clipped, truncated to 8 bits, as
    the JAX CLI writes it) and an ``-acc.png`` of the rendered frame's
    values, and ``sweep.gif``: PIL reads its frames, each within one
    palette step (51) of the frame (its nearest level, <= 25.5, plus the
    PNG's truncation), looping, 100 ms a frame."""
    from PIL import Image

    cfg = _sphere_cfg(False, size=16, samples=16)
    model = init_nerf_params(cfg.model, 3)
    path = ckpt.save(model, str(tmp_path / "ckpt"), step=5)
    common = ["--dataset", "sphere", "--width", "16", "--height", "16", "--num_samples", "16",
              "--load_path", path, "--device", "cpu", "--depth", "true"]
    out = tmp_path / "s"
    assert cli.main(["render", *common, "--frames", "3", "--gif", "true",
                     "--out_dir", str(out)]) == 0
    assert f"wrote {out / 'sweep.gif'}" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == sorted(
        [f"frame-{i:03d}{s}.png" for i in range(3) for s in ("", "-depth", "-acc")]
        + ["sweep.gif"])
    angles = rays.spherical_render_path(3, np.pi / 6)
    poses = rays.pose_from_yaw_pitch(angles[:, 0], angles[:, 1])
    gif = Image.open(out / "sweep.gif")
    assert gif.n_frames == 3 and gif.info["loop"] == 0 and gif.info["duration"] == 100
    for i in range(3):
        rgb, depth, acc = render_frame(cfg, model, *rays.ray_grid(poses[i], cfg.camera))
        png = _read_png(str(out / f"frame-{i:03d}.png")).astype(int)
        for name, v in (("depth", torch.clamp(depth / cfg.camera.far, 0, 1)),
                        ("acc", torch.clamp(acc, 0, 1))):
            want = np.clip(v.numpy() * 255.0, 0, 255).astype(np.uint8)
            got = _read_png(str(out / f"frame-{i:03d}-{name}.png"))
            assert (np.abs(got.astype(int) - want[..., None]) <= 1).all(), name
        gif.seek(i)
        frame = np.asarray(gif.convert("RGB")).astype(int)
        assert np.abs(frame - rgb.numpy() * 255.0).max() <= 25.5 + 1e-3
        assert np.abs(frame - png).max() <= 51
    assert cli.main(["render", *common, "--view", "0", "--out_dir", str(tmp_path / "v")]) == 0
    assert sorted(os.listdir(tmp_path / "v")) == ["view-0-acc.png", "view-0-depth.png",
                                                  "view-0.png"]


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 64, 48), (2, 5, 300)])
def test_save_gif_round_trips_through_pil(shape, tmp_path):
    """The port's GIF89a: PIL decodes every frame to the palette colour of
    each pixel's nearest level, exactly (random frames fill the LZW table
    past 4,095 codes, so the coder's clear-and-restart runs too); the
    port's header walk reads the screen and frame sizes; a frame of
    another size is refused."""
    from PIL import Image

    from nerf_rs_tpu_torch.data import images

    n, h, w = shape
    frames = np.random.default_rng(h * w).uniform(-0.2, 1.2, (n, h, w, 3)).astype(np.float32)
    path = tmp_path / "a.gif"
    images.save_gif(str(path), torch.from_numpy(frames), fps=20)
    assert images.gif_frames(path.read_bytes()) == ((w, h), [(w, h)] * n)
    gif = Image.open(path)
    assert gif.n_frames == n and gif.info["duration"] == 50
    pal = images.gif_palette()
    for i in range(n):
        gif.seek(i)
        np.testing.assert_array_equal(np.asarray(gif.convert("RGB")),
                                      pal[images.gif_indices(frames[i])])
    with pytest.raises(ValueError, match="differ in size"):
        images.save_gif(str(path), [frames[0], frames[0][:, :-1]])
