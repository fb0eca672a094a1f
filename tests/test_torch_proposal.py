"""The PyTorch port's proposal sampling on the CPU (ROADMAP slice 5, with
tests/test_torch_unbounded.py): the proposal MLP on converted JAX weights,
its seeded init, the histogram helpers, one- and two-level resampling
(``randomized=False``: the inverse CDF at a linspace, so no draw), the
interlevel loss, the annealing exponent, the proposal branch of
``render_rays`` and ``eval_step``, the train kernel route of the proposal
step against the port's own eager loss on the same draws, one train step
of ``--preset proposal`` against the JAX step, and checkpoints that carry
the proposal net.

Small widths, a few rays, inputs from numpy seeds; every tolerance is
stated where it is used.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.models import proposal as jprop_model
from nerf_rs_tpu.ops import proposal as jprop
from nerf_rs_tpu.ops import render as jrender_ops
from nerf_rs_tpu.train import step as jstep
from nerf_rs_tpu_torch.config import CameraConfig, ProposalConfig
from nerf_rs_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_rs_tpu_torch.models import proposal as prop_model
from nerf_rs_tpu_torch.ops import proposal as prop
from nerf_rs_tpu_torch.ops import render as render_ops
from nerf_rs_tpu_torch.train import checkpoint as ckpt
from nerf_rs_tpu_torch.train import step

from test_torch_unbounded import (_small_preset, assert_step_matches_jax, preset_batch,
                                  preset_states)

torch.set_num_threads(2)

PCFG = ProposalConfig(enabled=True, num_samples=8, net_depth=3, net_width=16,
                      pos_enc_levels=4)
CAM = CameraConfig(near=0.3, far=6.0)
N = 12


def _prop_net(pcfg=PCFG, seed=3):
    """JAX-drawn proposal weights (sigma bias raised so the histogram is
    not flat) and the port's net holding them (``params_from_numpy``)."""
    params = jprop_model.init_proposal_params(jax.random.PRNGKey(seed), pcfg)
    params["sigma"]["b"] = params["sigma"]["b"] + 0.5
    net = prop_model.ProposalMLP(pcfg)
    net.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    return params, net


def _rays(n=N, seed=4):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("contract", [False, True])
@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_apply_proposal_matches_jax(contract, dtype):
    """sigma at points inside and far outside the unit ball, with and
    without the contraction: f32 at atol 1e-5 (products summed in another
    order); bf16 layers at 2e-2 of the largest sigma (the two frameworks
    round the bf16 activations at their own points)."""
    params, net = _prop_net()
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(64, 5, 3)) * np.exp(rng.uniform(-2, 2, (64, 5, 1)))).astype(np.float32)
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if dtype else (None, None)
    with torch.no_grad():
        got = prop_model.apply_proposal(net, torch.from_numpy(x), PCFG, tdt, contract)
        assert torch.equal(got, net(torch.from_numpy(x), tdt, contract))
    want = np.asarray(jprop_model.apply_proposal(params, jnp.asarray(x), PCFG, jdt,
                                                 contract=contract))
    assert got.shape == (64, 5) and got.dtype == torch.float32
    tol = 1e-5 if dtype is None else 2e-2 * float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, atol=tol)
    assert float(got.max()) > 0.0


def test_init_proposal_params_is_seeded_he():
    """He truncated-normal weights and zero biases from numpy's stream
    PROPOSAL_STREAM: the same on every call, another draw than the main
    field's stream, the JAX layout's shapes."""
    a, b = prop_model.init_proposal_params(PCFG, 0), prop_model.init_proposal_params(PCFG, 0)
    c = prop_model.init_proposal_params(PCFG, 1)
    tree = params_to_numpy(a)
    want = jax.tree.map(np.shape, jprop_model.init_proposal_params(jax.random.PRNGKey(0), PCFG))
    assert jax.tree.map(np.shape, tree) == want
    for (k, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(x, y), k
        if k.endswith(".b"):
            assert not bool(x.any()), k
        else:
            assert not torch.equal(x, z), k
            assert float(x.abs().max()) <= 2.0 * (2.0 / x.shape[0]) ** 0.5 + 1e-6, k
    from nerf_rs_tpu_torch.models.mlp import seed_rng

    first = seed_rng(0, prop_model.PROPOSAL_STREAM).standard_normal(8)
    assert not np.allclose(first, seed_rng(0, 1).standard_normal(8))


def test_histogram_helpers_match_jax():
    rng = np.random.default_rng(6)
    ts = np.sort(rng.uniform(0.3, 6.0, (N, 9)), -1).astype(np.float32)
    sigma = rng.uniform(0.0, 3.0, (N, 9)).astype(np.float32)
    deltas = np.diff(np.concatenate([ts, np.full((N, 1), 6.0, np.float32)], -1), axis=-1)
    np.testing.assert_array_equal(prop.edges_from_ts(torch.from_numpy(ts)).numpy(),
                                  np.asarray(jprop.edges_from_ts(jnp.asarray(ts))))
    np.testing.assert_allclose(
        prop.weights_from_sigma(torch.from_numpy(sigma), torch.from_numpy(deltas)).numpy(),
        np.asarray(jprop.weights_from_sigma(jnp.asarray(sigma), jnp.asarray(deltas))),
        atol=1e-6)
    w = torch.from_numpy(rng.uniform(0, 1, (N, 9)).astype(np.float32))
    assert prop.anneal_weights(w, None) is w
    np.testing.assert_allclose(prop.anneal_weights(w, 0.3).numpy(),
                               np.asarray(jprop.anneal_weights(jnp.asarray(w.numpy()), 0.3)),
                               rtol=1e-6)


@pytest.mark.parametrize("space", ["linear", "disparity"])
@pytest.mark.parametrize("levels", [1, 2])
def test_proposal_resample_matches_jax(levels, space):
    """One and two levels through the one proposal net, midpoint draws
    (randomized=False: the stratified midpoints and the inverse CDF at a
    linspace), with the contraction: the main ts (sorted, inside [near,
    far]) and every level's histogram at atol 1e-5 x far and 1e-5 (f32).
    Past the first level the bars are 2e-4 x far and 1e-4: a level's
    inverse CDF divides by a bin's CDF step, so an f32 rounding of the
    weights moves a sample within a steep bin (2 of 192 samples read 1e-4
    x far)."""
    pcfg = dataclasses.replace(PCFG, num_levels=levels)
    params, net = _prop_net(pcfg)
    o, d = _rays()
    ts, hists = prop.proposal_resample(torch.from_numpy(o), torch.from_numpy(d), net, pcfg, 16,
                                       CAM, False, space=space, contract=True)
    jts, jhists = jprop.proposal_resample(jax.random.PRNGKey(0), jnp.asarray(o), jnp.asarray(d),
                                          params, pcfg, 16, CAM, False, space=space,
                                          contract=True)
    assert ts.shape == (N, 16) and len(hists) == levels
    assert bool((ts[:, 1:] >= ts[:, :-1]).all())
    assert float(ts.min()) >= CAM.near and float(ts.max()) <= CAM.far
    bar = 1e-5 if levels == 1 else 2e-4
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(jts), atol=bar * CAM.far)
    for lvl, ((bins, w), (jbins, jw)) in enumerate(zip(hists, jhists)):
        bar = 1e-5 if lvl == 0 else 1e-4
        np.testing.assert_allclose(bins.detach().numpy(), np.asarray(jbins),
                                   atol=2 * bar * CAM.far)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), atol=bar)
    assert hists[0][1].requires_grad  # the histogram carries the proposal's gradient


def test_interlevel_loss_matches_jax():
    """The loss summed over two levels and its gradient in the proposal
    weights against the JAX function, at f32 rounding (rtol 1e-5); the
    main weights get no gradient."""
    rng = np.random.default_rng(7)
    main_edges = np.sort(rng.uniform(0.3, 6.0, (N, 17)), -1).astype(np.float32)
    w_main = rng.uniform(0, 0.2, (N, 16)).astype(np.float32)
    hists_np = [(np.sort(rng.uniform(0.3, 6.0, (N, 9)), -1).astype(np.float32),
                 rng.uniform(0, 0.3, (N, 8)).astype(np.float32)) for _ in range(2)]
    tw = [torch.from_numpy(w).requires_grad_() for _, w in hists_np]
    tmain = torch.from_numpy(w_main).requires_grad_()
    loss = prop.multi_interlevel_loss(torch.from_numpy(main_edges), tmain,
                                      [(torch.from_numpy(b), w) for (b, _), w in zip(hists_np, tw)])
    loss.backward()
    jfn = lambda ws: jprop.multi_interlevel_loss(  # noqa: E731
        jnp.asarray(main_edges), jnp.asarray(w_main),
        [(jnp.asarray(b), w) for (b, _), w in zip(hists_np, ws)])
    want, jgrads = jax.value_and_grad(jfn)([jnp.asarray(w) for _, w in hists_np])
    assert float(want) > 0
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for g, jg in zip(tw, jgrads):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-8)
    assert tmain.grad is None
    # a proposal that covers everything costs nothing
    cover = prop.interlevel_loss(torch.from_numpy(main_edges), tmain,
                                 torch.tensor([[0.3, 6.0]]).expand(N, 2), torch.ones(N, 1))
    assert float(cover) == 0.0


@pytest.mark.parametrize("st", [None, 0, 1, 37, 500, 999, 1000, 4000])
def test_prop_anneal_matches_jax(st):
    """The annealing exponent in f32, as the JAX package computes it: the
    same bits."""
    cfg = _small_preset("proposal")
    jcfg = jconfig.Config.from_dict(cfg.to_dict())
    got = step._prop_anneal(cfg, st)
    want = jstep._prop_anneal(jcfg, None if st is None else jnp.int32(st))
    if st is None:
        assert got is None and want is None
    else:
        assert got == float(want)
        assert 0.0 <= got <= 1.0
    off = dataclasses.replace(cfg, proposal=dataclasses.replace(cfg.proposal, anneal_steps=0))
    assert step._prop_anneal(off, 5) is None


def test_render_and_eval_through_the_proposal_match_jax():
    """render_rays' proposal branch (eager field, midpoint draws) and the
    same through the render kernel's plain version, against the JAX
    render_rays with prop_params on converted weights: rgb, acc and
    weights at 3e-3 (the render bars of tests/test_torch_hierarchical.py),
    ts at 5e-4 x far (the inverse CDF moves a sample within a steep bin by
    a weight's f32 rounding over the bin's CDF step: 2 of 128 read 1.5e-4
    x far); eval_step reports the same pass."""
    cfg = _small_preset("proposal")
    jcfg, jstate, state = preset_states(cfg)
    o, d, gold = preset_batch()
    want, _ = jrender_ops.render_rays(jstate.params, jnp.asarray(o), jnp.asarray(d),
                                      jax.random.PRNGKey(0), jcfg.model, jcfg.render, jcfg.camera,
                                      randomized=False, prop_params=jstate.fine_params,
                                      prop_cfg=jcfg.proposal)
    for fused in (False, True):
        with torch.no_grad():
            got, fine = render_ops.render_rays(
                state.params, torch.from_numpy(o), torch.from_numpy(d), cfg.model, cfg.render,
                cfg.camera, randomized=False, use_fused=fused, prop_params=state.fine_params,
                prop_cfg=cfg.proposal)
        assert fine is None and got.ts.shape == (o.shape[0], cfg.render.num_samples)
        for name, tol in (("rgb", 3e-3), ("acc", 3e-3), ("weights", 3e-3),
                          ("ts", 5e-4 * cfg.camera.far)):
            np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                       atol=tol, err_msg=f"{name}, fused={fused}")
    out = step.eval_step(state, step.Batch(*map(torch.from_numpy, (o, d, gold))), cfg)
    jout = jstep.eval_step(jstate, jstep.Batch(*map(jnp.asarray, (o, d, gold))),
                           jax.random.PRNGKey(0), jcfg)
    np.testing.assert_allclose(out["rgb"].numpy(), np.asarray(jout["rgb"]), atol=3e-3)
    np.testing.assert_allclose(float(out["psnr"]), float(jout["psnr"]), rtol=1e-3)


@pytest.mark.parametrize("levels,dist", [(1, 0.0), (2, 0.05)])
def test_whole_ray_proposal_grads_match_the_eager_loss(levels, dist):
    """The train kernel route of a proposal step (the proposal eager, the
    main field through K2's plain version, the proposal's gradient from
    the interlevel loss alone) against autograd of the port's eager
    ``_proposal_loss``, with one generator seed giving both routes the
    same jittered draws: the same main samples (the kernel route's
    weights are the eager ones to the bf16 field's rounding), the losses
    at 2e-3, the main field's leaves at 4e-2 and the proposal's at 5e-2 of
    the leaf's max (kernel vs autograd bars: bf16 rounds at other points;
    the proposal's leaves see that through the main weights in the
    interlevel loss)."""
    cfg = _small_preset("unbounded" if levels == 2 else "proposal")
    cfg = dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, randomized=True),
        proposal=dataclasses.replace(cfg.proposal, num_levels=levels, anneal_steps=100),
        train=dataclasses.replace(cfg.train, distortion_weight=dist, precision="mixed"))
    _, _, state = preset_states(cfg)
    o, d, gold = preset_batch()
    batch = step.Batch(*map(torch.from_numpy, (o, d, gold)))
    gen = lambda: torch.Generator().manual_seed(21)  # noqa: E731
    grads, aux = step.whole_ray_grads(state.params, batch, gen(), cfg, state.fine_params, 40)
    loss, aux_e = step.loss_fn(state.params, batch, gen(), cfg, state.fine_params, 40)
    loss.backward()
    for key in ["loss", "loss_coarse", "loss_prop"] + (["loss_dist"] if dist else []):
        assert abs(float(aux[key]) - float(aux_e[key].detach())) < 2e-3, key
    assert float(aux["loss_prop"]) > 0
    named = dict(step.named_trainable(state))
    assert sorted(grads) == sorted(named)
    for name, g in grads.items():
        ref = named[name].grad
        scale = float(ref.abs().max())
        assert scale > 1e-8, name
        tol = 5e-2 if name.startswith("fine.") else 4e-2
        assert float((g - ref).abs().max()) / scale < tol, name


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "autograd"])
def test_proposal_train_step_matches_jax(kernel):
    assert_step_matches_jax("proposal", kernel)


def test_proposal_rejects_a_fine_pass():
    cfg = _small_preset("proposal")
    bad = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, num_fine_samples=8))
    with pytest.raises(ValueError, match="num_fine_samples"):
        step.init_state(bad)


def test_checkpoint_carries_the_proposal_net(tmp_path):
    """The proposal net rides the second slot: saved, restored for a resume
    (optimizer state over both nets) and for eval; a run without the
    proposal cannot load it."""
    cfg = _small_preset("proposal")
    state = step.init_state(cfg)
    assert isinstance(state.fine_params, prop_model.ProposalMLP)
    o, d, gold = preset_batch()
    batch = step.Batch(*map(torch.from_numpy, (o, d, gold)))
    state, _ = step.train_step(state, batch, None, cfg)
    path = ckpt.save(state, str(tmp_path))
    fresh = ckpt.restore(path, step.init_state(cfg))
    assert fresh.step == 1
    for (k, x), (_, y) in zip(step.named_trainable(state), step.named_trainable(fresh)):
        assert torch.equal(x, y), k
    s1, _ = step.train_step(state, batch, None, cfg)
    s2, _ = step.train_step(fresh, batch, None, cfg)
    for (k, x), (_, y) in zip(step.named_trainable(s1), step.named_trainable(s2)):
        assert torch.equal(x, y), k
    with pytest.raises(ValueError, match="preset"):
        ckpt.restore_weights(path, step.init_state(
            dataclasses.replace(cfg, proposal=dataclasses.replace(cfg.proposal,
                                                                  enabled=False))).params)
