"""The port's field export (``utils/export.py``, ``cli export``) on the
CPU against the JAX package's (``tests/test_export.py``): the density grid
at res 16 on converted weights, at f32 and at the default bf16; the
occupied points; the bytes of the ``.ply`` and the arrays of the ``.npz``;
and the CLI, which exports the EMA weights where the checkpoint holds them
and runs on the card unless asked for the CPU.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.models import mlp as jmlp
from nerf_rs_tpu.utils import export as jex
from nerf_rs_tpu_torch import cli
from nerf_rs_tpu_torch.config import ModelConfig
from nerf_rs_tpu_torch.convert import params_from_numpy
from nerf_rs_tpu_torch.models.mlp import NerfMLP
from nerf_rs_tpu_torch.train import checkpoint as ckpt
from nerf_rs_tpu_torch.train import step
from nerf_rs_tpu_torch.utils import export as ex

torch.set_num_threads(2)

CFG = ModelConfig(net_depth=2, net_width=32, skip_layer=9, feature_width=32,
                  view_head_width=16, pos_enc_levels=4, dir_enc_levels=2)


def _pair(seed=0):
    params = jmlp.init_nerf_params(jax.random.PRNGKey(seed), jconfig.ModelConfig(**CFG.__dict__))
    model = NerfMLP(CFG)
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    return params, model


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sample_density_grid_matches_jax(dtype):
    """res 16 over [-1.6, 1.6]^3 in slabs of 16 (and of 3: the slabs move
    no value). f32: 1e-5 (the cell centres of the two linspaces part by an
    f32 ulp, which the encoding's top frequency 2^3 keeps under 2e-6); bf16
    (the export's default): test_apply_nerf_mixed_matches_jax's bf16 bars,
    sigma 2e-2 and rgb 5e-3."""
    params, model = _pair()
    jd, td, tol_s, tol_c = ((None, None, 1e-5, 1e-5) if dtype == "f32"
                            else (jnp.bfloat16, torch.bfloat16, 2e-2, 5e-3))
    want_s, want_c = jex.sample_density_grid(params, jconfig.ModelConfig(**CFG.__dict__),
                                             res=16, dtype=jd)
    got_s, got_c = ex.sample_density_grid(model, CFG, res=16, dtype=td)
    assert got_s.shape == (16, 16, 16) and got_c.shape == (16, 16, 16, 3)
    assert got_s.dtype == np.float32
    np.testing.assert_allclose(got_s, want_s, atol=tol_s, rtol=0)
    np.testing.assert_allclose(got_c, want_c, atol=tol_c, rtol=0)
    again_s, again_c = ex.sample_density_grid(model, CFG, res=16, dtype=td, slab=3)
    np.testing.assert_array_equal(again_s, got_s)
    np.testing.assert_array_equal(again_c, got_c)


def test_occupied_points_and_files_match_jax(tmp_path):
    """The cells above the threshold, their centres and 8-bit colours,
    equal to the JAX function's; the ``.ply`` byte for byte; the ``.npz``
    arrays equal."""
    rng = np.random.default_rng(0)
    sigma = rng.uniform(0, 10, (16, 16, 16)).astype(np.float32)
    rgb = rng.uniform(0, 1, (16, 16, 16, 3)).astype(np.float32)
    xyz, rgb8 = ex.occupied_points(sigma, rgb, 1.6, 5.0)
    jxyz, jrgb8 = jex.occupied_points(sigma, rgb, 1.6, 5.0)
    np.testing.assert_array_equal(xyz, jxyz)
    np.testing.assert_array_equal(rgb8, jrgb8)
    assert 0 < xyz.shape[0] < sigma.size
    ex.save_ply(str(tmp_path / "p.ply"), xyz, rgb8)
    jex.save_ply(str(tmp_path / "j.ply"), jxyz, jrgb8)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    ex.save_npz(str(tmp_path / "p.npz"), sigma, rgb, 1.6)
    jex.save_npz(str(tmp_path / "j.npz"), sigma, rgb, 1.6)
    a, b = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert sorted(a.files) == sorted(b.files) == ["aabb", "rgb", "sigma"]
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


def test_cli_export_uses_the_ema_and_the_card(tmp_path, capsys):
    """``export`` of a checkpoint: the grid of its EMA weights (through
    the eager field at bf16), the point cloud of the cells above the
    threshold; no checkpoint is an error (rc 1); without ``--device cpu``
    and no card it raises, as every entry point does."""
    save = str(tmp_path / "ck")
    common = ["--dataset", "sphere", "--width", "8", "--height", "8", "--num_samples", "8",
              "--save_dir", save]
    assert cli.main(["train", *common, "--num_rays", "32", "--num_iter", "3", "--ema_decay",
                     "0.9", "--eval_steps", "100", "--log_dir", str(tmp_path / "logs"),
                     "--device", "cpu"]) == 0
    out = str(tmp_path / "exp" / "field")
    assert cli.main(["export", *common, "--grid_res", "12", "--export_aabb", "1.0",
                     "--threshold", "0.0", "--out", out, "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "using EMA weights for inference" in text and "exported 12^3 grid" in text
    grid = np.load(out + ".npz")
    assert grid["sigma"].shape == (12, 12, 12) and grid["rgb"].shape == (12, 12, 12, 3)
    args = cli.build_parser().parse_args(["export", *common])
    args._explicit = cli.explicit_dests(["export", *common])
    cfg = cli.config_from_args(args)
    ema = ckpt.load_ema(ckpt.latest_checkpoint(save), step.init_state(cfg).params)
    want_s, _ = ex.sample_density_grid(ema, cfg.model, res=12, aabb=1.0)
    np.testing.assert_array_equal(grid["sigma"], want_s)
    n = int((grid["sigma"] > 0.0).sum())
    assert f"{n} points (sigma > 0.0)" in text
    assert cli.main(["export", *common, "--save_dir", str(tmp_path / "none"),
                     "--device", "cpu"]) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["export", *common, "--out", out])
