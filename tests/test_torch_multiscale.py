"""The PyTorch port's multiscale training on the CPU (ROADMAP slice 3,
item 39; mip-NeRF arXiv 2103.13415 section 4), mirroring
tests/test_multiscale.py: the box pyramid bit for bit against the JAX
package's ``build_pyramid`` in both background modes, the level-partitioned
sampler's rays, gold, radii and indices on the draws the JAX sampler made,
the scaled views' rays and gold, per-ray radii through ``render_rays`` and
through ``whole_ray_grads`` on the plain route (against the JAX functions
on converted weights), the config's refusals and the CLI (``--multiscale_levels``
and ``eval --scales``).

Small widths (depth 2, width 32), a few rays, inputs from numpy seeds.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.data import device_dataset as jdd
from nerf_rs_tpu.models import mlp as jmlp
from nerf_rs_tpu.ops import render as jrender
from nerf_rs_tpu.train import step as jstep
from nerf_rs_tpu_torch import cli
from nerf_rs_tpu_torch.config import (CameraConfig, Config, DataConfig, ModelConfig,
                                      RenderConfig, TrainConfig)
from nerf_rs_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_rs_tpu_torch.data.dataset import DeviceDataset, build_pyramid
from nerf_rs_tpu_torch.models.mlp import NerfMLP
from nerf_rs_tpu_torch.ops import render as render_ops
from nerf_rs_tpu_torch.ops import sampling
from nerf_rs_tpu_torch.train import step

torch.set_num_threads(2)

MODEL = ModelConfig(net_depth=2, net_width=32, skip_layer=1, feature_width=32,
                    view_head_width=16, pos_enc_levels=6, dir_enc_levels=2, ipe=True,
                    sigma_activation="softplus")


def _imgs(v=3, h=16, w=16, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (v, h, w, 4), dtype=np.uint8)


def _angles(v, seed=1):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (v, 2)).astype(np.float32)


def _datasets(imgs, levels, white_bg=False):
    """The JAX package's DeviceDataset and the port's on the same store,
    camera and view angles."""
    cam = CameraConfig(width=imgs.shape[2], height=imgs.shape[1])
    angles = _angles(imgs.shape[0])
    jds = jdd.DeviceDataset(imgs, jconfig.CameraConfig(width=cam.width, height=cam.height),
                            angles=angles, white_background=white_bg,
                            multiscale_levels=levels)
    ds = DeviceDataset(torch.from_numpy(imgs), cam, torch.from_numpy(angles),
                       white_background=white_bg, multiscale_levels=levels)
    return jds, ds


@pytest.mark.parametrize("white_bg", [False, True])
def test_pyramid_matches_jax_bit_for_bit(white_bg):
    """``build_pyramid`` (device_dataset.py:120-145) is numpy on both
    sides: the same bytes at every level, and the dataset keeps them on
    its device beside the level-0 store."""
    imgs = _imgs(h=32, w=32)
    mine = build_pyramid(imgs, 4, white_bg)
    want = jdd.build_pyramid(imgs, 4, white_bg)
    assert len(mine) == len(want) == 4
    for m, w in zip(mine, want):
        assert m.dtype == np.uint8 and m.shape == w.shape
        np.testing.assert_array_equal(m, w)
    _, ds = _datasets(imgs, 4, white_bg)
    for lvl in range(4):
        np.testing.assert_array_equal(ds.ms_images[lvl].numpy(), want[lvl])


@pytest.mark.parametrize("white_bg", [False, True])
def test_scaled_views_match_jax(white_bg):
    """``view_rays(v, scale)`` and ``view_gold(v, scale)``
    (device_dataset.py:365-398): rays through the centres of scale-wide
    blocks, and the gold composited before its box average; within 1e-6
    (f32 on both sides)."""
    jds, ds = _datasets(_imgs(h=32, w=32), 3, white_bg)
    for scale in (1, 2, 4):
        o, d = ds.view_rays(1, scale)
        jo, jd = jds.view_rays(1, scale=scale)
        assert o.shape == (32 // scale, 32 // scale, 3)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
        np.testing.assert_allclose(ds.view_gold(1, scale).numpy(),
                                   np.asarray(jds.view_gold(1, scale=scale)), atol=1e-6)


def _jax_draws(jbatch, counts, h, w):
    """The (view, x, y) each level's block of a JAX multiscale batch drew,
    read back from its level-0 corner indices."""
    idx = np.asarray(jbatch.idx)
    draws, start = [], 0
    for lvl, n_l in enumerate(counts):
        i = idx[start:start + n_l]
        v, rem = np.divmod(i, h * w)
        y, x = np.divmod(rem, w)
        draws.append(tuple(torch.from_numpy(a.astype(np.int64)) for a in (v, x >> lvl, y >> lvl)))
        start += n_l
    return draws


@pytest.mark.parametrize("n", [96, 101])
def test_sampler_matches_jax_on_its_draws(n):
    """``_sample_per_ray_ms`` (device_dataset.py:82-117) on the draws the
    JAX sampler made: equal level blocks with the remainder on level 0,
    each level's rays from a camera of focal / 2^l (atol 1e-6), gold from
    its level's store (to an ulp), radii pixel_radius(cam_l) (2^l r0), and
    indices in the level-0 namespace (exact). The port's own
    ``sample_batch`` gives a batch of the same layout."""
    imgs = _imgs(v=4, h=32, w=32)
    jds, ds = _datasets(imgs, 3)
    jbatch = jdd._sample_per_ray_ms(jds.ms_images, jds.pose_data, jax.random.PRNGKey(5), n,
                                    jds.mode, False, jds.camera, 32, 32, jds.num_views)
    counts = ds.level_counts(n)
    assert counts == [n // 3 + n % 3, n // 3, n // 3]
    batch = ds.batch_from_draws(_jax_draws(jbatch, counts, 32, 32))
    np.testing.assert_allclose(batch.origins.numpy(), np.asarray(jbatch.origins), atol=1e-6)
    np.testing.assert_allclose(batch.dirs.numpy(), np.asarray(jbatch.dirs), atol=1e-6)
    # XLA divides by 255 as a product with its reciprocal: an ulp apart
    np.testing.assert_allclose(batch.gold.numpy(), np.asarray(jbatch.gold), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(batch.idx.numpy(), np.asarray(jbatch.idx))
    np.testing.assert_allclose(batch.radii.numpy(), np.asarray(jbatch.radii), rtol=1e-6)
    r0 = sampling.pixel_radius(ds.camera)
    start = 0
    for lvl, n_l in enumerate(counts):
        np.testing.assert_allclose(batch.radii[start:start + n_l].numpy(), r0 * 2 ** lvl,
                                   rtol=1e-6)
        start += n_l
    own = ds.sample_batch(step.step_generator(0, 0, "cpu"), n)
    assert own.origins.shape == (n, 3) and own.radii.shape == (n,)
    np.testing.assert_allclose(own.radii.numpy(), batch.radii.numpy(), rtol=1e-6)
    assert bool(((own.gold >= 0) & (own.gold <= 1)).all())


def _model(cfg, seed=0):
    params = jmlp.init_nerf_params(jax.random.PRNGKey(seed), cfg)
    params["sigma"]["b"] = params["sigma"]["b"] + 0.3
    model = NerfMLP(cfg)
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    return params, model


def _rays(n, seed=3):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.1 + [0.0, 0.0, -1.0]).astype(np.float32)
    d = (rng.normal(size=(n, 3)) * 0.2 + [0.0, 0.0, 1.0]).astype(np.float32)
    radii = rng.uniform(0.005, 0.08, n).astype(np.float32)
    gold = rng.uniform(size=(n, 3)).astype(np.float32)
    return o, d, radii, gold


@pytest.mark.parametrize("fused", [False, True])
def test_radii_flow_through_render_rays_as_in_jax(fused):
    """Per-ray radii through ``render_rays`` (ops/render.py:207-242), on
    the eager field and through the render kernel's plain version, against
    the JAX function (tests/test_fused_ray.py's bars: rgb and acc 3e-3):
    the camera's radius given per ray changes nothing, wide cones change
    the IPE render, and a point-sampled model ignores the radii."""
    jcfg_m = jconfig.ModelConfig(**dataclasses.asdict(MODEL))
    rcfg = RenderConfig(num_samples=8, num_fine_samples=8, share_network=True,
                        fine_mode="standalone")
    cam = CameraConfig(width=16, height=16)
    jcfg_r = jconfig.RenderConfig(**dataclasses.asdict(rcfg))
    jcam = jconfig.CameraConfig(**dataclasses.asdict(cam))
    params, model = _model(MODEL)
    o, d, radii, _ = _rays(12)
    kw = dict(randomized=False, use_fused=fused)

    def run(r, m=MODEL, jm=jcfg_m):
        _, got = render_ops.render_rays(model, torch.from_numpy(o), torch.from_numpy(d), m,
                                        rcfg, cam, radii=None if r is None else
                                        torch.from_numpy(r), **kw)
        return got

    with torch.no_grad():
        got = run(radii)
        base = run(None)
        same = run(np.full(12, sampling.pixel_radius(cam), np.float32))
    _, want = jrender.render_rays(params, jnp.asarray(o), jnp.asarray(d), jax.random.PRNGKey(0),
                                  jcfg_m, jcfg_r, jcam, radii=jnp.asarray(radii), **kw)
    for name in ("rgb", "acc"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=3e-3, err_msg=name)
    np.testing.assert_allclose(same.rgb.numpy(), base.rgb.numpy(), atol=1e-6)
    assert float((got.rgb - base.rgb).abs().max()) > 1e-4
    pt = dataclasses.replace(MODEL, ipe=False)
    with torch.no_grad():
        np.testing.assert_array_equal(run(np.full(12, 7.0, np.float32), pt).rgb.numpy(),
                                      run(None, pt).rgb.numpy())


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_whole_ray_grads_take_the_batch_radii_as_jax():
    """``whole_ray_grads`` on the plain route with a multiscale batch's
    radii (Batch.radii, train/step.py:56-60) against the JAX function on
    converted weights, midpoint samples: losses within 4e-3 and every
    leaf within 5e-2 of its largest entry (tests/test_fused_train.py's
    bars); the radii move the gradients."""
    cfg = Config(camera=CameraConfig(width=16, height=16), model=MODEL,
                 render=RenderConfig(num_samples=8, num_fine_samples=8, share_network=True,
                                     fine_mode="standalone", white_background=True,
                                     randomized=False),
                 train=TrainConfig(num_rays=12, whole_ray_block=4),
                 data=DataConfig(dataset="sphere", multiscale_levels=2),
                 use_whole_ray_train=True)
    jcfg = jconfig.Config.from_dict(cfg.to_dict())
    params, model = _model(MODEL, seed=2)
    o, d, radii, gold = _rays(12, seed=4)
    grads_j, aux_j = jstep.whole_ray_grads(
        params, jstep.Batch(*map(jnp.asarray, (o, d, gold)), radii=jnp.asarray(radii)),
        jax.random.PRNGKey(0), jcfg)
    batch = step.Batch(*map(torch.from_numpy, (o, d, gold)), radii=torch.from_numpy(radii))
    grads, aux = step.whole_ray_grads(model, batch, None, cfg)
    for key in ("loss", "loss_coarse", "loss_fine"):
        assert abs(float(aux[key]) - float(aux_j[key])) < 4e-3, key
    for g, w in zip(_leaves(params_to_numpy(grads)), _leaves(jax.tree.map(np.asarray, grads_j))):
        np.testing.assert_allclose(g, w, atol=5e-2 * max(np.abs(w).max(), 1e-6))
    plain, _ = step.whole_ray_grads(model, batch._replace(radii=None), None, cfg)
    assert max(float((grads[k] - plain[k]).abs().max()) for k in grads) > 0


def test_multiscale_config_refusals():
    """The three checks of nerf_rs_tpu/config.py:412-425, with its
    messages."""
    assert Config(data=DataConfig(multiscale_levels=4)).data.multiscale_levels == 4
    for kw, words in ((dict(data=DataConfig(multiscale_levels=2, batch_mode="host")), "per_ray"),
                      (dict(data=DataConfig(multiscale_levels=2),
                            train=TrainConfig(error_resample_frac=0.5)), "error resampling"),
                      (dict(data=DataConfig(multiscale_levels=2, shard_pixel_store=True)),
                       "shard_pixel_store")):
        with pytest.raises(ValueError, match=words) as mine:
            Config(**kw)
        with pytest.raises(ValueError) as theirs:
            jconfig.Config.from_dict(Config().to_dict() | {
                k: dataclasses.asdict(v) for k, v in kw.items()})
        assert str(mine.value) == str(theirs.value)


def test_cli_multiscale_train_and_eval_at_scales(tmp_path, capsys):
    """``--multiscale_levels`` resolves as the JAX CLI resolves it and
    trains (a pyramid store, per-ray radii); ``eval --scales 1,2`` reports
    each scale's per-view and mean PSNR and SSIM, the multiscale mean, and
    writes ``-s{scale}`` PNGs (nerf_rs_tpu/cli.py:769-808), at the PSNR the
    port's own render of the scaled view gives."""
    from nerf_rs_tpu import cli as jcli

    argv = ["train", "--preset", "mipnerf", "--dataset", "sphere", "--multiscale_levels", "4"]
    mine = cli.config_from_args(_parsed(cli, argv))
    theirs = jcli.config_from_args(_parsed(jcli, argv))
    assert mine.data.multiscale_levels == theirs.data.multiscale_levels == 4
    assert mine.model.ipe and mine.render == RenderConfig(**{
        k: v for k, v in dataclasses.asdict(theirs.render).items()
        if k in {f.name for f in dataclasses.fields(RenderConfig)}})
    small = ["--dataset", "sphere", "--width", "16", "--height", "16", "--num_samples", "4",
             "--num_fine_samples", "4", "--ipe", "true", "--share_network", "true",
             "--device", "cpu", "--save_dir", str(tmp_path / "ck")]
    assert cli.main(["train", *small, "--multiscale_levels", "2", "--num_rays", "32",
                     "--num_iter", "2", "--eval_steps", "100", "--log_dir",
                     str(tmp_path / "lg")]) == 0
    capsys.readouterr()
    assert cli.main(["eval", *small, "--max_views", "2", "--scales", "1,2",
                     "--out_dir", str(tmp_path / "ev")]) == 0
    out = capsys.readouterr().out
    for scale in (1, 2):
        assert len(re.findall(rf"view +\d+ 1/{scale}: psnr \S+  ssim", out)) == 2
        assert f"mean psnr over 2 test views at 1/{scale}:" in out
    assert "multiscale mean psnr:" in out
    assert sorted(p.name for p in (tmp_path / "ev").iterdir()) == [
        "eval-000-s1.png", "eval-000-s2.png", "eval-001-s1.png", "eval-001-s2.png"]


def _parsed(mod, argv):
    args = mod.build_parser().parse_args(argv)
    args._explicit = mod.explicit_dests(argv)
    return args
