"""The port's procedural scenes on the CPU (ROADMAP item 18): every analytic
field against the JAX package's on the same points, the camera rigs, the
gold integral ``render_gold`` and whole scenes written by both packages'
``make_blender_scene`` (PNGs and ``transforms_*.json``), and the port's
make-scene entry. Small frames (16 x 16, 64 samples); every tolerance is
stated where it is used.
"""

import glob
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerf_rs_tpu.data import procedural as jproc
from nerf_rs_tpu_torch.data import blender, procedural
from nerf_rs_tpu_torch.tools import make_scene

torch.set_num_threads(2)

# where each field's content lives: points drawn over it
_SPAN = {"lego": (1.5, 0.0), "helix": (1.5, 0.0), "facing": (2.0, -4.0),
         "lego360": (30.0, 0.0), "deep360": (2000.0, 0.0)}


@pytest.mark.parametrize("name", sorted(procedural.FIELDS))
def test_fields_match_jax(name):
    """sigma and rgb of each field at 4,000 points against the JAX field:
    rgb within 1e-5; sigma = 60 sigmoid(-sdf s) within 2e-4 (the sdf's f32
    rounding times the sigmoid's slope: up to 15 s = 3,750 per unit of sdf
    at the bounded scenes' sharpness 250; 1.05e-4 was the largest gap)."""
    scale, dz = _SPAN[name]
    rng = np.random.default_rng(len(name))
    x = (rng.uniform(-1, 1, (4000, 3)) * scale).astype(np.float32)
    x[:, 2] += dz
    sigma, rgb = procedural.FIELDS[name](torch.from_numpy(x))
    jsigma, jrgb = jproc.FIELDS[name](jnp.asarray(x))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=1e-5, rtol=0)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), atol=2e-4, rtol=0)
    assert float(sigma.max()) > 1.0  # the points reach the content


def test_camera_rigs_are_the_jax_rigs():
    """hemisphere_poses, forward_facing_poses and look_at_c2w: the same
    numpy draws and arithmetic, bit for bit."""
    for seed in (1, 2, 7):
        np.testing.assert_array_equal(procedural.hemisphere_poses(5, seed),
                                      jproc.hemisphere_poses(5, seed))
        np.testing.assert_array_equal(procedural.forward_facing_poses(5, seed),
                                      jproc.forward_facing_poses(5, seed))
    np.testing.assert_array_equal(procedural.look_at_c2w((1.0, 2.0, 3.0)),
                                  jproc.look_at_c2w((1.0, 2.0, 3.0)))


# the gold frames' gap: a ray's 64-sample compositing sum in f32, in
# another order and fusion on each side (6.5e-6 was the largest)
GOLD_TOL = 1e-5


@pytest.mark.parametrize("scene,space", [("lego", "linear"), ("lego360", "disparity")])
def test_render_gold_matches_jax(scene, space):
    """Two 16 x 16 views, 64 midpoint samples, in the linear and disparity
    spacings, against the JAX integral within GOLD_TOL, in one chunk and
    in chunks of 100 rays (the chunking moves no bit)."""
    c2w = procedural.hemisphere_poses(2, 1)
    focal = 0.5 * 16 / math.tan(0.5 * procedural.CAMERA_ANGLE_X)
    near, far = (2.0, 6.0) if space == "linear" else (0.3, 60.0)
    kw = dict(near=near, far=far, num_samples=64, field_fn=procedural.FIELDS[scene],
              space=space)
    for i in range(2):
        got = procedural.render_gold(c2w[i], 16, 16, focal, **kw)
        want = jproc.render_gold(c2w[i], 16, 16, focal, near=near, far=far, num_samples=64,
                                 field_fn=jproc.FIELDS[scene], space=space)
        assert got.shape == (16, 16, 4)
        np.testing.assert_allclose(got, want, atol=GOLD_TOL, rtol=0)
        np.testing.assert_array_equal(
            procedural.render_gold(c2w[i], 16, 16, focal, chunk=100, **kw), got)
        assert 0.05 < got[..., 3].mean() < 0.95  # the object fills part of the frame


# a pixel whose alpha byte is 0 shows no colour: both writers truncate
# acc x 255, so its coverage is under one 8-bit step (0.0037 was the
# largest), and its colour bytes are unpremultiplied rgb / max(acc, 1e-6),
# which turns a one-ulp gap in acc (2^-24 against 0) into tens of colour steps
INVISIBLE_ACC = 1.0 / 255
# the premultiplied frames' gap: GOLD_TOL on the lego (6.9e-6 was the
# largest); on the forward-facing scene one sample's sigma gap, up to 2e-4
# (test_fields_match_jax's bar), times its delta of 6 / 64 moves acc by up
# to 1.9e-5, and two such samples by 3.8e-5 (2.26e-5 was the largest)
PREMULT_TOL = {"lego": GOLD_TOL, "facing": 4e-5}


def _gold_pair(scene: str, c2w, size: int, num_samples: int):
    """(port, JAX) ``render_gold`` of one view of ``scene`` at the writer's
    camera, as (size, size, 4) [unpremultiplied rgb, acc] arrays."""
    focal = 0.5 * size / math.tan(0.5 * procedural.CAMERA_ANGLE_X)
    near, far = (1.5, 7.5) if scene == "facing" else (2.0, 6.0)
    c2w = np.asarray(c2w, np.float32)
    mine = procedural.render_gold(c2w, size, size, focal, near=near, far=far,
                                  num_samples=num_samples, field_fn=procedural.FIELDS[scene])
    theirs = jproc.render_gold(c2w, size, size, focal, near=near, far=far,
                               num_samples=num_samples, field_fn=jproc.FIELDS[scene])
    return mine, np.asarray(theirs)


@pytest.mark.parametrize("scene", ["lego", "facing"])
def test_scene_writer_matches_the_jax_writer(scene, tmp_path):
    """A 16 x 16 scene (2 train views, 1 val, 1 test, 64 samples) from
    each package: the same transforms_*.json. Where the alpha byte is 0 in
    both frames no colour shows, and the colour bytes are not compared;
    both frames' acc there stands below INVISIBLE_ACC, which only restates
    the alpha byte (both writers store trunc(acc x 255)) and so checks no
    more than that ``_gold_pair`` recomputes the frames written: the bar on
    those pixels is test_render_gold_premultiplied_matches_jax. Every other byte
    within 1 LSB of the JAX writer's, alpha compared everywhere, at least
    80% of the pixels equal in all four channels (84-99% here), and each
    byte that differs one whose JAX frame value x 255 lies within 255
    GOLD_TOL of an integer, where the frames' gap can carry the truncation
    across (most are alpha at a coverage of 1 - 1e-6: 254 against 255)."""
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    kw = dict(size=16, n_train=2, n_val=1, n_test=1, num_samples=64, verbose=False,
              scene=scene)
    procedural.make_blender_scene(str(mine), **kw)
    jproc.make_blender_scene(str(theirs), **kw)
    for split in ("train", "val", "test"):
        meta = json.load(open(mine / f"transforms_{split}.json"))
        assert meta == json.load(open(theirs / f"transforms_{split}.json"))
        for frame in meta["frames"]:
            name = frame["file_path"] + ".png"
            a = np.asarray(Image.open(mine / name)).astype(int)
            b = np.asarray(Image.open(theirs / name)).astype(int)
            g_mine, g_jax = _gold_pair(scene, frame["transform_matrix"], 16, 64)
            invisible = (a[..., 3] == 0) & (b[..., 3] == 0)
            assert (g_mine[..., 3][invisible] < INVISIBLE_ACC).all(), name
            assert (g_jax[..., 3][invisible] < INVISIBLE_ACC).all(), name
            diff = np.abs(a - b)
            diff[..., :3][invisible] = 0  # colour that neither file shows
            assert diff.max() <= 1 and (diff.max(-1) == 0).mean() >= 0.8, name
            f = g_jax * 255.0
            edge = np.abs(f - np.round(f))[diff > 0]
            assert (edge <= 255 * GOLD_TOL).all(), (name, float(edge.max()))


@pytest.mark.parametrize("scene", ["lego", "facing"])
def test_render_gold_premultiplied_matches_jax(scene):
    """The writer test's frames through each package's ``render_gold``, in
    the well-conditioned form: premultiplied colour rgb * acc and the
    coverage acc within PREMULT_TOL at every pixel (no division by acc)."""
    pose_fn = (procedural.forward_facing_poses if scene == "facing"
               else procedural.hemisphere_poses)
    # the writer's splits at seed 0: train 2 views (seed 1), val 1 (2), test 1 (3)
    c2w = np.concatenate([pose_fn(2, 1), pose_fn(1, 2), pose_fn(1, 3)])
    for i in range(c2w.shape[0]):
        g_mine, g_jax = _gold_pair(scene, c2w[i], 16, 64)
        for g in (g_mine, g_jax):
            assert g.shape == (16, 16, 4)
        tol = PREMULT_TOL[scene]
        np.testing.assert_allclose(g_mine[..., 3], g_jax[..., 3], atol=tol, rtol=0)
        np.testing.assert_allclose(g_mine[..., :3] * g_mine[..., 3:],
                                   g_jax[..., :3] * g_jax[..., 3:], atol=tol, rtol=0)


def test_make_scene_entry_writes_a_scene_the_loader_reads(tmp_path):
    """``python -m nerf_rs_tpu_torch.tools.make_scene`` on the CPU: a
    Blender scene of the requested size and splits that load_blender reads
    (white-on-transparent frames: some pixels clear, some opaque); without
    a card, --device cuda raises instead of running on the CPU."""
    out = tmp_path / "lego"
    assert make_scene.main(["--out", str(out), "--size", "12", "--n_train", "3", "--n_val",
                            "1", "--n_test", "2", "--num_samples", "32", "--device",
                            "cpu"]) == 0
    assert sorted(os.path.basename(p) for p in glob.glob(str(out / "*.json"))) == [
        "transforms_test.json", "transforms_train.json", "transforms_val.json"]
    scene = blender.load_blender(str(out), "test")
    assert scene.images.shape == (2, 12, 12, 4)
    assert scene.focal == pytest.approx(0.5 * 12 / math.tan(0.5 * procedural.CAMERA_ANGLE_X))
    alpha = scene.images[..., 3]
    assert (alpha == 0).any() and (alpha > 200).any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_scene.main(["--out", str(tmp_path / "x"), "--size", "4", "--n_train", "1",
                             "--n_val", "1", "--n_test", "1"])
