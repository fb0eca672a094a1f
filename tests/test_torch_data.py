"""The PyTorch port's datasets and host pipeline on the CPU (ROADMAP slice
6): the standard-library PNG decoder against PIL (bit for bit, on the
fixtures and on PNGs written here in every colour type, bit depth and
filter), the c2w and NDC rays, the Blender and LLFF loaders on the
fixtures in ``tests/data``, the dataset factory's branches, the multiview
and error-weighted batches and the error store's update on the JAX
sampler's own draws, the host pipeline (numpy and the port's C++ gather),
the ``.err.npy`` sidecar, one train step of ``--preset full`` and of
``--preset record`` on ``blender_mini`` against the JAX step on converted
weights, and the CLI on every dataset and batch mode.

Small widths and scenes; every tolerance is stated where it is used.
"""

import dataclasses
import io
import os
import shutil
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerf_rs_tpu import cli as jcli
from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.data import blender as jblender
from nerf_rs_tpu.data import device_dataset as jdd
from nerf_rs_tpu.data import factory as jfactory
from nerf_rs_tpu.data import images as jimages
from nerf_rs_tpu.data import llff as jllff
from nerf_rs_tpu.data import pipeline as jpipeline
from nerf_rs_tpu.ops import rays as jrays
from nerf_rs_tpu.train import step as jstep
from nerf_rs_tpu_torch import cli
from nerf_rs_tpu_torch.config import CameraConfig, Config, DataConfig, ModelConfig
from nerf_rs_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_rs_tpu_torch.data import blender, images, llff, native_loader
from nerf_rs_tpu_torch.data.dataset import (SCAN_WIDTH, DeviceDataset, fixed_order_cumsum,
                                           update_error_store)
from nerf_rs_tpu_torch.data.factory import effective_config, make_dataset
from nerf_rs_tpu_torch.data.pipeline import HostSampler, PrefetchPipeline
from nerf_rs_tpu_torch.ops import rays
from nerf_rs_tpu_torch.train import checkpoint as ckpt
from nerf_rs_tpu_torch.train import step

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
BLENDER = os.path.join(DATA, "blender_mini")
LLFF = os.path.join(DATA, "llff_mini")
FIXTURES = sorted(os.path.join(r, f) for r, _, fs in os.walk(DATA) for f in fs
                  if f.endswith(".png"))
SMALL = ModelConfig(net_depth=3, net_width=32, skip_layer=2, feature_width=32,
                    view_head_width=16, pos_enc_levels=3, dir_enc_levels=1)


# -- the PNG decoder -----------------------------------------------------------

def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filter(rows, ftypes, bpp):
    """The PNG encoder's scanline filters of (H, rowbytes) bytes, each row
    its own type (an independent writer: the decoder's inverse)."""
    h, n = rows.shape
    x = rows.astype(np.int32)
    a = np.concatenate([np.zeros((h, bpp), np.int32), x[:, :-bpp]], 1)
    b = np.concatenate([np.zeros((1, n), np.int32), x[:-1]], 0)
    c = np.concatenate([np.zeros((h, bpp), np.int32), b[:, :-bpp]], 1)
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [0 * x, a, b, (a + b) >> 1, paeth]
    return np.stack([(x[i] - preds[f][i]) & 255 for i, f in enumerate(ftypes)]).astype(np.uint8)


def _png(samples, ctype, depth, ftypes, plte=None, trns=None, interlace=0):
    h, w, ch = samples.shape
    if depth == 16:
        s = samples.astype(">u2").view(np.uint8).reshape(h, w * ch * 2)
    elif depth == 8:
        s = samples.astype(np.uint8).reshape(h, w * ch)
    else:
        bits = ((samples[..., 0, None] >> np.arange(depth - 1, -1, -1)) & 1)
        s = np.packbits(bits.reshape(h, w * depth).astype(np.uint8), axis=1)
    raw = np.concatenate([np.asarray(ftypes, np.uint8)[:, None],
                          _filter(s, ftypes, max(1, ch * depth // 8))], 1)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                             0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    data = zlib.compress(raw.tobytes())  # two IDAT chunks: they concatenate
    return (out + _chunk(b"IDAT", data[:len(data) // 2]) + _chunk(b"IDAT", data[len(data) // 2:])
            + _chunk(b"IEND", b""))


def _pil(png: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGBA"))


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: os.path.relpath(p, DATA))
def test_png_decoder_is_pil_on_the_fixtures(path):
    """Every fixture PNG decodes bit-equal to PIL's convert("RGBA") (they
    are PIL-written, adaptively filtered RGBA)."""
    np.testing.assert_array_equal(images.load_image(path), _pil(open(path, "rb").read()))


_CASES = [(c, d) for c, ds in images._DEPTHS.items() for d in ds]


@pytest.mark.parametrize("ctype,depth", _CASES, ids=[f"type{c}-{d}bit" for c, d in _CASES])
def test_png_decoder_is_pil_in_every_colour_type_and_depth(ctype, depth):
    """PNGs written here in each colour type and bit depth, every row
    cycling through the five filters (Paeth included), with and (types 0,
    2 and 3) without a tRNS chunk whose colour is in the image: bit-equal
    to PIL (16-bit samples reduced as PIL reduces them)."""
    ch = images._CHANNELS[ctype]
    for seed in range(3):
        rng = np.random.default_rng(seed)
        h, w = 7 + seed, 9 + 2 * seed
        s = rng.integers(0, 1 << depth, (h, w, ch)).astype(np.uint16 if depth == 16
                                                               else np.uint8)
        if depth == 16 and ctype == 0:
            s[0, :3, 0] = [5, 200, 300]  # below, at and above 255: PIL clips
        plte = rng.integers(0, 256, (min(1 << depth, 256), 3)) if ctype == 3 else None
        for with_trns in (False, True):
            trns = None
            if with_trns and ctype == 3:
                trns = bytes(rng.integers(0, 256, len(plte) // 2).astype(np.uint8))
            elif with_trns and ctype in (0, 2):
                trns = struct.pack(f">{ch}H", *map(int, s[1, 2, :ch]))
            elif with_trns:
                continue
            png = _png(s, ctype, depth, [i % 5 for i in range(h)], plte, trns)
            np.testing.assert_array_equal(images.decode_png(png), _pil(png),
                                          err_msg=f"seed {seed}, tRNS {with_trns}")


@pytest.mark.parametrize("ftype", range(5))
def test_png_decoder_undoes_each_filter_in_uint8_wraparound(ftype):
    """One filter on every row of an RGBA image of extreme bytes (0, 255 and
    near them, where the filter sums wrap modulo 256) decodes to the
    image, as PIL does."""
    rng = np.random.default_rng(ftype)
    img = rng.choice(np.array([0, 1, 127, 128, 254, 255], np.uint8), size=(6, 11, 4))
    png = _png(img, 6, 8, [ftype] * 6)
    np.testing.assert_array_equal(images.decode_png(png), img)
    np.testing.assert_array_equal(_pil(png), img)


def test_png_decoder_names_what_it_does_not_read(tmp_path):
    """An interlaced PNG, a JPEG and a chunk with a wrong CRC each raise an
    error that names the case; ``save_png`` round-trips."""
    img = np.random.default_rng(0).integers(0, 256, (4, 5, 4)).astype(np.uint8)
    with pytest.raises(ValueError, match="interlaced"):
        images.decode_png(_png(img, 6, 8, [0] * 4, interlace=1))
    jpg = tmp_path / "x.jpg"
    Image.fromarray(img[..., :3]).save(jpg)
    with pytest.raises(ValueError, match="JPEG"):
        images.load_image(str(jpg))
    png = bytearray(_png(img, 6, 8, [0] * 4))
    png[40] ^= 1  # inside IDAT
    with pytest.raises(ValueError, match="CRC"):
        images.decode_png(bytes(png))
    images.save_png(str(tmp_path / "y.png"), img / 255.0)
    np.testing.assert_array_equal(images.load_image(str(tmp_path / "y.png")), img)


def test_box_downsample_and_multiview_layout_match_jax(tmp_path):
    """box_downsample bit-equal to the JAX function (uint8 and float);
    load_multiview_dir reads the reference's image-{i}.png layout as the JAX
    loader does."""
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, (13, 10, 4)).astype(np.uint8)
    for f in (2, 3):
        np.testing.assert_array_equal(images.box_downsample(u8, f), jimages.box_downsample(u8, f))
        f32 = u8.astype(np.float32) / 255.0
        np.testing.assert_array_equal(images.box_downsample(f32, f),
                                      jimages.box_downsample(f32, f))
    for i in range(4):
        images.save_png(str(tmp_path / f"image-{i}.png"), rng.uniform(size=(6, 5, 4)))
    got = images.load_multiview_dir(str(tmp_path), 1, 4, 1)
    want = jimages.load_multiview_dir(str(tmp_path), 1, 4, 1)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] == (6, 5)
    with pytest.raises(ValueError, match="divisible"):
        images.get_image_paths(str(tmp_path), 0, 3, 2)


# -- rays --------------------------------------------------------------------

def _c2w(n, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    m = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    m[:, :3, :3], m[:, :3, 3] = q, rng.normal(size=(n, 3))
    return m.astype(np.float32)


def test_c2w_rays_match_jax():
    """rays_from_c2w (a pose per ray) and ray_grid_c2w against the JAX
    functions at 1e-6 (the three-term rotation in f32 both sides)."""
    c2w = _c2w(5, 0)
    rng = np.random.default_rng(1)
    coords = (rng.uniform(size=(5, 2)) * [31, 23]).astype(np.float32)
    got = rays.rays_from_c2w(torch.from_numpy(coords), torch.from_numpy(c2w), 24, 32, 27.5)
    want = jrays.rays_from_c2w(jnp.asarray(coords), jnp.asarray(c2w), 24, 32, 27.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    got = rays.ray_grid_c2w(torch.from_numpy(c2w[2]), 6, 8, 7.0)
    want = jrays.ray_grid_c2w(jnp.asarray(c2w[2]), 6, 8, 7.0)
    for g, w in zip(got, want):
        assert g.shape == (6, 8, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


@pytest.mark.parametrize("focal", [None, 9.0])
def test_ndc_rays_match_jax(focal):
    """ndc_rays and maybe_ndc (on and off) against the JAX functions at
    1e-6 relative, on forward-facing rays (cameras near the origin looking
    down -z) with the warp's near plane at 1 and at 0.6; an explicit focal
    and one from the field of view."""
    rng = np.random.default_rng(2)
    o = (rng.normal(size=(40, 3)) * 0.2).astype(np.float32)
    d = np.concatenate([rng.normal(size=(40, 2)) * 0.3, -np.ones((40, 1))], -1)
    d = d.astype(np.float32)
    for ndc_near in (1.0, 0.6):
        cam = CameraConfig(width=12, height=10, near=0.0, far=1.0, focal=focal, ndc=True,
                           ndc_near=ndc_near)
        jcam = jconfig.CameraConfig(**dataclasses.asdict(cam))
        got = rays.ndc_rays(torch.from_numpy(o), torch.from_numpy(d), cam)
        want = jrays.ndc_rays(jnp.asarray(o), jnp.asarray(d), jcam)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
        on = rays.maybe_ndc(torch.from_numpy(o), torch.from_numpy(d), cam)
        assert all(torch.equal(a, b) for a, b in zip(on, got))
    off = rays.maybe_ndc(torch.from_numpy(o), torch.from_numpy(d), CameraConfig())
    assert torch.equal(off[0], torch.from_numpy(o))


# -- loaders -------------------------------------------------------------------

@pytest.mark.parametrize("split,downscale,max_frames", [("train", 1, None), ("test", 1, None),
                                                        ("train", 2, 3)])
def test_load_blender_matches_jax_and_the_truth(split, downscale, max_frames):
    """The same uint8 store as the JAX loader's, c2w within 1e-6 of it and
    of c2w_truth.npy (the generator's poses), the same focal."""
    got = blender.load_blender(BLENDER, split, downscale, max_frames)
    want = jblender.load_blender(BLENDER, split, downscale, max_frames)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_allclose(got.c2w, want.c2w, atol=1e-6, rtol=0)
    assert (got.height, got.width, got.focal) == (want.height, want.width, want.focal)
    if max_frames is None:  # the truth holds the train views, then the test ones
        truth = np.load(os.path.join(BLENDER, "c2w_truth.npy"))
        truth = truth[:4] if split == "train" else truth[4:]
        np.testing.assert_allclose(got.c2w, truth, atol=1e-6, rtol=0)


@pytest.mark.parametrize("split,factor,holdout", [("train", 1, 8), ("test", 1, 8),
                                                  ("all", 2, 0), ("train", 1, 3)])
def test_load_llff_matches_jax_and_the_truth(split, factor, holdout):
    """The same uint8 store as the JAX loader's (the factor-2 decimation
    included), c2w within 1e-6 of it, the same focal and bounds; with
    recentering off and no rescale the poses are c2w_truth.npy's (the
    fixture's generator)."""
    got = llff.load_llff(LLFF, split, factor, holdout)
    want = jllff.load_llff(LLFF, split, factor, holdout)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_allclose(got.c2w, want.c2w, atol=1e-6, rtol=0)
    assert (got.height, got.width) == (want.height, want.width)
    assert (got.focal, got.near, got.far) == (want.focal, want.near, want.far)
    raw = llff.load_llff(LLFF, "all", recenter=False, rescale=False)
    np.testing.assert_allclose(raw.c2w, np.load(os.path.join(LLFF, "c2w_truth.npy")),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(llff.recenter_poses(raw.c2w), jllff.recenter_poses(raw.c2w),
                               atol=1e-6, rtol=0)


def test_load_llff_refuses_a_jpeg_capture(tmp_path):
    """JPEG is a divergence from the JAX loader (which reads it with PIL):
    the card has no JPEG decoder, so a .jpg capture raises, naming it."""
    scene = tmp_path / "cap"
    shutil.copytree(LLFF, scene)
    first = sorted(os.listdir(scene / "images"))[0]
    Image.open(scene / "images" / first).convert("RGB").save(scene / "images" / "IMG_3999.jpg")
    os.remove(scene / "images" / first)
    with pytest.raises(ValueError, match="JPEG"):
        llff.load_llff(str(scene), "all")


# -- the factory ---------------------------------------------------------------

def _datasets(argv, split="train"):
    """The port's and the JAX package's dataset for the same CLI flags."""
    args = cli.build_parser().parse_args(["train", *argv])
    args._explicit = cli.explicit_dests(["train", *argv])
    jargs = jcli.build_parser().parse_args(["train", *argv])
    jargs._explicit = jcli.explicit_dests(["train", *argv])
    cfg, jcfg = cli.config_from_args(args), jcli.config_from_args(jargs)
    return make_dataset(cfg, split=split), jfactory.make_dataset(jcfg, split=split), cfg


def _same_dataset(ds, jds):
    np.testing.assert_array_equal(ds.images.numpy(), np.asarray(jds.images))
    np.testing.assert_allclose(ds.pose_data.numpy(), np.asarray(jds.pose_data), atol=1e-6)
    assert ds.mode == jds.mode
    assert dataclasses.asdict(ds.camera) == dataclasses.asdict(jds.camera)


@pytest.mark.parametrize("argv,split", [
    (["--dataset", "blender", "--img_dir", BLENDER], "train"),
    (["--dataset", "blender", "--img_dir", BLENDER, "--white_background", "true"], "test"),
    (["--dataset", "llff", "--img_dir", LLFF, "--ndc", "true"], "train"),
    (["--dataset", "llff", "--img_dir", LLFF], "test"),
    (["--dataset", "llff", "--img_dir", LLFF, "--near", "0.5"], "train"),
    (["--dataset", "llff", "--img_dir", LLFF, "--llff_holdout", "0"], "all"),
    (["--dataset", "sphere", "--width", "8", "--height", "8"], "train"),
], ids=["blender", "blender-test-white", "llff-ndc", "llff-metric-test", "llff-near",
        "llff-all", "sphere"])
def test_factory_branches_match_jax(argv, split):
    """Each branch of make_dataset gives the JAX factory's store, poses
    and camera (the scene's size and focal; LLFF's NDC range, the
    capture's bounds in metric mode, an explicit near kept)."""
    ds, jds, cfg = _datasets(argv, split)
    _same_dataset(ds, jds)
    assert effective_config(cfg, ds).camera == ds.camera


def test_factory_reads_the_multiview_png_layout(tmp_path):
    """--dataset multiview_png: image-{i}.png on the hemisphere grid's
    angles, as the JAX factory reads them; a size unlike the camera's
    raises."""
    rng = np.random.default_rng(3)
    for i in range(6):
        images.save_png(str(tmp_path / f"image-{i}.png"), rng.uniform(size=(8, 8, 3)))
    argv = ["--img_dir", str(tmp_path), "--view_start", "1", "--view_end", "6", "--view_step",
            "1", "--num_views_per_hemisphere", "2", "--width", "8", "--height", "8"]
    ds, jds, _ = _datasets(argv)
    _same_dataset(ds, jds)
    with pytest.raises(ValueError, match="camera"):
        _datasets(argv[:-4] + ["--width", "4", "--height", "8"])


# -- batches on shared draws ------------------------------------------------

def _blender_pair(white=False, ndc=False):
    argv = ["--dataset", "blender", "--img_dir", BLENDER, "--white_background", str(white)]
    ds, jds, _ = _datasets(argv)
    if ndc:  # the c2w rays through the warp too
        cam = dataclasses.replace(ds.camera, near=0.0, far=1.0, ndc=True)
        ds = DeviceDataset(ds.images, cam, c2w=ds.pose_data, white_background=white)
        jds = jdd.DeviceDataset(np.asarray(jds.images),
                                jconfig.CameraConfig(**dataclasses.asdict(cam)),
                                c2w=np.asarray(jds.pose_data), white_background=white)
    return ds, jds


def _same_batch(got, want, with_idx=True):
    """Rays at 1e-6; gold within 1 ulp (XLA turns the division by 255 into
    a product with its reciprocal, which rounds a few values the other
    way)."""
    np.testing.assert_allclose(got.origins.numpy(), np.asarray(want.origins), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(got.dirs.numpy(), np.asarray(want.dirs), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_max_ulp(got.gold.numpy(), np.asarray(want.gold), maxulp=1)
    if with_idx:
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))


@pytest.mark.parametrize("white,ndc", [(False, False), (True, False), (False, True)])
def test_per_ray_and_multiview_batches_match_jax_on_its_draws(white, ndc):
    """The JAX sampler's per-ray and multiview batches on a Blender scene
    (c2w poses; and through the NDC warp), rebuilt by the port from the
    draws read back from their pixel ids: the same rays at 1e-6 and the
    same gold. A multiview batch's views come in equal blocks."""
    ds, jds = _blender_pair(white, ndc)
    want = jds.sample_batch(jax.random.PRNGKey(4), 48)
    _same_batch(ds.batch_from_idx(torch.from_numpy(np.array(want.idx)).long()), want)
    want = jds.sample_multiview_batch(jax.random.PRNGKey(5), 48, 4)
    idx = np.asarray(want.idx)
    view = idx // (ds.height * ds.width)
    assert (view.reshape(4, 12) == view.reshape(4, 12)[:, :1]).all()
    rem = idx % (ds.height * ds.width)
    got = ds.multiview_from_draws(torch.from_numpy(view[::12]).long(),
                                  torch.from_numpy(rem % ds.width).long(),
                                  torch.from_numpy(rem // ds.width).long())
    _same_batch(got, want)
    drawn = ds.sample_multiview_batch(torch.Generator().manual_seed(0), 48, 4)
    v = drawn.idx // (ds.height * ds.width)
    assert bool((v.reshape(4, 12) == v.reshape(4, 12)[:, :1]).all())
    with pytest.raises(ValueError, match="divisible"):
        ds.sample_multiview_batch(torch.Generator(), 50, 4)


def test_error_weighted_batch_matches_jax_on_its_draws():
    """``_sample_error_weighted``'s draws (its key split into the error
    draw and the uniform one, as the JAX function splits it) fed to the
    port: the same pixel ids, rays and gold, on a store of uneven errors
    (a few pixels carry most of the mass)."""
    ds, jds = _blender_pair()
    rng = np.random.default_rng(6)
    err = rng.uniform(0.0, 0.01, ds.num_views * ds.height * ds.width).astype(np.float32)
    err[rng.integers(0, err.size, 20)] = 5.0
    key, n, frac = jax.random.PRNGKey(7), 64, 0.5
    want = jds.sample_batch_error_weighted(key, n, jnp.asarray(err), frac)
    kc, ku, _ = jax.random.split(key, 3)
    num_err = int(n * frac)
    u = np.asarray(jax.random.uniform(kc, (num_err,)))
    idx_uni = np.asarray(jax.random.randint(ku, (n - num_err,), 0, err.size))
    got = ds.error_weighted_from_draws(torch.from_numpy(err), torch.from_numpy(u),
                                       torch.from_numpy(idx_uni).long())
    _same_batch(got, want)
    assert np.isin(np.asarray(want.idx)[:num_err], np.flatnonzero(err == 5.0)).mean() > 0.5
    drawn = ds.sample_batch_error_weighted(torch.Generator().manual_seed(1), n,
                                           torch.from_numpy(err), frac)
    assert drawn.idx.shape == (n,) and int(drawn.idx.max()) < err.size


def test_fixed_order_cumsum_repeats_and_draws_the_jax_pixels():
    """Fault 11's repair on the CPU: the error store's running sum in rows of
    SCAN_WIDTH gives the same bits on every call, stays within f32 rounding
    of the float64 running sum (at lengths around a row's), and its inverse
    CDF draws the pixels the JAX function draws from the same uniforms (the
    store and draws of test_error_weighted_batch_matches_jax_on_its_draws:
    4,096 pixels, four rows)."""
    rng = np.random.default_rng(9)
    for n in (1, 5, SCAN_WIDTH - 1, SCAN_WIDTH + 1, 3 * SCAN_WIDTH):
        x = torch.from_numpy(rng.uniform(size=n).astype(np.float32))
        exact = np.cumsum(x.numpy().astype(np.float64))
        np.testing.assert_allclose(fixed_order_cumsum(x).numpy(), exact, rtol=0,
                                   atol=1e-6 * exact[-1])
    ds, jds = _blender_pair()
    rng = np.random.default_rng(6)
    err = rng.uniform(0.0, 0.01, ds.num_views * ds.height * ds.width).astype(np.float32)
    err[rng.integers(0, err.size, 20)] = 5.0
    assert err.size == 4 * SCAN_WIDTH
    key, n, frac = jax.random.PRNGKey(7), 64, 0.5
    want = np.asarray(jds.sample_batch_error_weighted(key, n, jnp.asarray(err), frac).idx)
    u = torch.from_numpy(np.asarray(jax.random.uniform(jax.random.split(key, 3)[0],
                                                       (int(n * frac),))))
    x = torch.from_numpy(err) + 1e-8
    cdf = fixed_order_cumsum(x)
    assert all(torch.equal(cdf, fixed_order_cumsum(x)) for _ in range(3))
    exact = np.cumsum(x.numpy().astype(np.float64))
    np.testing.assert_allclose(cdf.numpy(), exact, rtol=0, atol=1e-6 * exact[-1])
    idx = torch.searchsorted(cdf, (u * cdf[-1]).contiguous()).clamp(0, err.size - 1)
    np.testing.assert_array_equal(idx.numpy(), want[:u.shape[0]])


def test_update_error_store_matches_jax_and_takes_the_last_draw():
    """Distinct pixel ids: the JAX function's update within 1 ulp (XLA
    contracts the EMA's product and sum into one fused multiply-add, which
    rounds once where torch rounds twice). Repeated ids (the JAX scatter
    leaves the winner undefined): the port's rule, the EMA of the last draw
    in batch order, each pixel once, bit for bit."""
    rng = np.random.default_rng(8)
    store = rng.uniform(size=200).astype(np.float32)
    idx = rng.permutation(200)[:50]
    err = rng.uniform(size=50).astype(np.float32)
    want = np.asarray(jdd.update_error_store(jnp.asarray(store), jnp.asarray(idx),
                                             jnp.asarray(err), 0.3))
    got = update_error_store(torch.from_numpy(store.copy()), torch.from_numpy(idx),
                             torch.from_numpy(err), 0.3)
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
    untouched = np.setdiff1d(np.arange(200), idx)
    np.testing.assert_array_equal(got.numpy()[untouched], store[untouched])
    idx = np.array([5, 9, 5, 7, 9, 5])
    err = np.arange(1, 7, dtype=np.float32)
    got = update_error_store(torch.from_numpy(store.copy()), torch.from_numpy(idx),
                             torch.from_numpy(err), 0.5).numpy()
    expect = store.copy()
    for i, pixel in ((5, 5), (4, 9), (3, 7)):  # the last draw of each pixel
        expect[pixel] = np.float32(0.5) * store[pixel] + np.float32(0.5) * err[i]
    np.testing.assert_array_equal(got, expect)


# -- the host pipeline ---------------------------------------------------------

def test_host_sampler_draws_the_jax_samplers_batches():
    """The same numpy stream for a seed: the JAX HostSampler's indices
    and gold, batch for batch; the port's C++ gather (its own copy of the
    assembler) gives the numpy gather's gold within 1 ulp (it multiplies
    by 1/255 where numpy divides)."""
    ds, _ = _blender_pair(white=True)
    store = ds.host_images
    mine, theirs = HostSampler(store, True, [3, 0]), jpipeline.HostSampler(store, True, [3, 0])
    native = HostSampler(store, True, [3, 0], gather_fn=native_loader.gather_gold)
    for _ in range(3):
        got, want, fast = mine.sample(40), theirs.sample(40), native.sample(40)
        for g, w, f in zip(got, want, fast):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_allclose(f, w, rtol=1.2e-7, atol=0)


@pytest.mark.parametrize("native", [False, True])
def test_prefetch_pipeline_yields_the_jax_pipelines_batches(native):
    """One worker: the JAX PrefetchPipeline's batches in order (its numpy
    gather; the port through numpy or its C++ gather): rays at 1e-6, gold
    exact through numpy and within 1 ulp through C++; then the pipeline
    closes its threads."""
    ds, jds = _blender_pair()
    kw = dict(c2w=ds.host_poses, num_rays=32, seed=2, depth=2)
    pipe = PrefetchPipeline(ds.host_images, ds.camera, use_native=native, **kw)
    jpipe = jpipeline.PrefetchPipeline(np.asarray(jds.images), jds.camera, use_native=False,
                                       **kw)
    try:
        for _ in range(3):
            got, want = next(pipe), next(jpipe)
            np.testing.assert_allclose(got.origins.numpy(), np.asarray(want.origins), atol=1e-6)
            np.testing.assert_allclose(got.dirs.numpy(), np.asarray(want.dirs), atol=1e-6)
            np.testing.assert_allclose(got.gold.numpy(), np.asarray(want.gold),
                                       rtol=1.2e-7 if native else 0, atol=0)
            if not native:  # the batch's pixel ids denote its gold
                np.testing.assert_array_equal(ds.batch_from_idx(got.idx).gold.numpy(),
                                              got.gold.numpy())
    finally:
        pipe.close()
        jpipe.close()
    assert not any(t.is_alive() for t in pipe._threads)


def test_native_loader_raises_when_it_cannot_build(monkeypatch, tmp_path):
    """--use_native_loader true with no compiler: an error, never a quiet
    numpy fallback."""
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    native_loader.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            native_loader.load()
        ds, _ = _blender_pair()
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            PrefetchPipeline(ds.host_images, ds.camera, c2w=ds.host_poses, use_native=True)
    finally:
        native_loader.load.cache_clear()


# -- checkpoints ---------------------------------------------------------------

def test_error_store_rides_beside_the_checkpoint(tmp_path):
    """save(..., err_store=) writes checkpoint-*.err.npy (the JAX
    package's sidecar name and format); load_err_store reads it, and a
    checkpoint without one gives None."""
    cfg = Config(model=SMALL, data=DataConfig(dataset="sphere"))
    state = step.init_state(cfg)
    store = torch.rand(300)
    path = ckpt.save(state, str(tmp_path), ts=5, err_store=store)
    assert os.path.basename(ckpt.err_store_path(path)) == "checkpoint-5-0.err.npy"
    np.testing.assert_array_equal(ckpt.load_err_store(path), store.numpy())
    assert ckpt.load_err_store(ckpt.save(state, str(tmp_path / "b"), ts=6)) is None


# -- one train step on blender_mini ------------------------------------------

def _preset_cfgs(preset):
    argv = ["train", "--preset", preset, "--dataset", "blender", "--img_dir", BLENDER,
            "--num_rays", "16", "--num_samples", "8", "--learning_rate", "1e-3"]
    if preset == "record":
        argv += ["--num_fine_samples", "8", "--occ_res", "8"]
    args = cli.build_parser().parse_args(argv)
    args._explicit = cli.explicit_dests(argv)
    cfg = cli.config_from_args(args)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, **{k: getattr(SMALL, k) for k in ("net_depth", "net_width", "skip_layer",
                                                     "feature_width", "view_head_width",
                                                     "pos_enc_levels", "dir_enc_levels")}),
        render=dataclasses.replace(cfg.render, randomized=False),
        train=dataclasses.replace(cfg.train, whole_ray_block=8))
    return cfg


@pytest.mark.parametrize("preset", ["full", "record"])
def test_one_step_on_blender_mini_matches_jax(preset):
    """One train step of the preset (the full flagship settings; record's
    IPE, one shared field, union fine pass, occupancy grid and white
    background; narrow widths) on a batch of blender_mini's c2w rays (the
    same pixel ids through both datasets), from converted weights at
    midpoint samples, through the train kernel's plain version against the
    JAX kernel in interpret mode: tests/test_torch_train.py's sphere bars
    (losses and PSNR within 1e-4 relative, per-ray errors within 1e-5, the
    new weights within 0.1 lr)."""
    cfg = _preset_cfgs(preset)
    ds = make_dataset(cfg)
    cfg = effective_config(cfg, ds)
    jcfg = jconfig.Config.from_dict(cfg.to_dict())
    jds = jfactory.make_dataset(jcfg)
    assert step.whole_ray_supported(cfg) and ds.mode == "c2w"
    idx = np.random.default_rng(9).integers(0, ds.num_views * ds.height * ds.width, 16)
    batch = ds.batch_from_idx(torch.from_numpy(idx))
    jbatch = jds.batch_from_idx(jnp.asarray(idx, jnp.int32))
    _same_batch(batch, jbatch)
    jstate = jstep.init_state(jax.random.PRNGKey(3), jcfg)
    state = step.init_state(cfg)
    state.params.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, jstate.params)))
    if preset == "record":  # a grid that guides: the centre of the scene occupied
        c = np.linspace(-1.6, 1.6, 8, endpoint=False) + 0.2
        gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
        g = (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) < 1.0).astype(np.float32)
        jstate = jstate._replace(grid=jnp.asarray(g))
        state.grid = torch.from_numpy(g)
    new_j, aux_j = jstep.train_step(jstate, jstep.Batch(jbatch.origins, jbatch.dirs,
                                                        jbatch.gold),
                                    jax.random.PRNGKey(0), jcfg)
    state, aux = step.train_step(state, step.Batch(batch.origins, batch.dirs, batch.gold),
                                 None, cfg)
    for key in ("loss", "loss_coarse", "psnr"):
        np.testing.assert_allclose(float(aux[key]), float(aux_j[key]), rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(aux["ray_err"].numpy(), np.asarray(aux_j["ray_err"]), atol=1e-5)
    for g, w in zip(jax.tree_util.tree_leaves(params_to_numpy(state.params)),
                    jax.tree_util.tree_leaves(jax.tree.map(np.asarray, new_j.params))):
        np.testing.assert_allclose(g, w, atol=0.1 * cfg.train.learning_rate)


# -- the CLI -------------------------------------------------------------------

def _run(argv, capsys):
    assert cli.main([*argv, "--device", "cpu"]) == 0
    return capsys.readouterr().out


def test_cli_trains_evaluates_and_renders_on_blender(tmp_path, capsys):
    """train (its eval hook on the held-out test split), eval --split test
    and --split train, render --view 0 and a sweep, on blender_mini."""
    common = ["--dataset", "blender", "--img_dir", BLENDER, "--num_samples", "8",
              "--save_dir", str(tmp_path / "ck")]
    out = _run(["train", *common, "--num_rays", "32", "--num_iter", "3", "--eval_steps", "2",
                "--log_dir", str(tmp_path / "logs")], capsys)
    assert "eval psnr" in out and "done at step 3" in out
    assert "over 2 test views" in _run(["eval", *common, "--split", "test"], capsys)
    assert "over 4 train views" in _run(["eval", *common, "--split", "train"], capsys)
    assert "view-0.png" in _run(["render", *common, "--view", "0", "--out_dir",
                                 str(tmp_path / "r")], capsys)
    assert "rendered 2 frames of 32x32" in _run(["render", *common, "--frames", "2",
                                                  "--out_dir", str(tmp_path / "r")], capsys)


def test_cli_runs_llff_with_ndc_and_the_batch_modes(tmp_path, capsys):
    """LLFF with --ndc (near 0, far 1 set for the user), multiview batches,
    the host pipeline through the C++ gather, then eval and render."""
    common = ["--dataset", "llff", "--img_dir", LLFF, "--ndc", "true", "--num_samples", "8",
              "--save_dir", str(tmp_path / "ck")]
    train = ["train", *common, "--num_rays", "32", "--eval_steps", "100",
             "--log_dir", str(tmp_path / "logs")]
    assert "done at step 2" in _run([*train, "--num_iter", "2", "--batch_mode", "multiview",
                                     "--views_per_batch", "4"], capsys)
    assert "done at step 4" in _run([*train, "--num_iter", "4", "--batch_mode", "host",
                                     "--use_native_loader", "true", "--data_workers", "2"],
                                    capsys)
    assert "test views" in _run(["eval", *common], capsys)
    assert "view-0.png" in _run(["render", *common, "--view", "0", "--out_dir",
                                 str(tmp_path / "r")], capsys)


def test_cli_pod_preset_resumes_its_error_store(tmp_path, capsys, monkeypatch):
    """--preset pod (error-weighted resampling of half the rays, as the
    JAX preset resolves it) on the multiview PNG layout: its checkpoint
    carries the error store, and a resume reads it back and goes on from
    it (the store the resumed run starts from is the saved one)."""
    for preset_argv in (["train", "--preset", "pod"], ["train", "--preset", "pod",
                                                       "--error_resample_frac", "0.8"]):
        args = cli.build_parser().parse_args(preset_argv)
        args._explicit = cli.explicit_dests(preset_argv)
        jargs = jcli.build_parser().parse_args(preset_argv)
        jargs._explicit = jcli.explicit_dests(preset_argv)
        assert (cli.config_from_args(args).train.error_resample_frac
                == jcli.config_from_args(jargs).train.error_resample_frac)
    rng = np.random.default_rng(10)
    for i in range(4):
        images.save_png(str(tmp_path / f"image-{i}.png"), rng.uniform(size=(8, 8, 4)))
    common = ["--preset", "pod", "--img_dir", str(tmp_path), "--view_end", "4",
              "--num_views_per_hemisphere", "2", "--width", "8", "--height", "8",
              "--num_samples", "8", "--num_rays", "32", "--eval_steps", "100",
              "--save_dir", str(tmp_path / "ck"), "--log_dir", str(tmp_path / "logs")]
    _run(["train", *common, "--num_iter", "3"], capsys)
    first = ckpt.latest_checkpoint(str(tmp_path / "ck"))
    saved = ckpt.load_err_store(first)
    assert saved.shape == (4 * 8 * 8,) and (saved != 1.0).any()  # it moved off its start
    from nerf_rs_tpu_torch.data import dataset as dataset_mod
    monkeypatch.setattr(dataset_mod.DeviceDataset, "init_error_store",
                        lambda self, initial=1.0: pytest.fail("the resume began a fresh store"))
    out = _run(["train", *common, "--num_iter", "5"], capsys)
    assert "resumed the error store from" in out and "done at step 5" in out
    assert ckpt.load_err_store(ckpt.latest_checkpoint(str(tmp_path / "ck"))).shape == saved.shape
