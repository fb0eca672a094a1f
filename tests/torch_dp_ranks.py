"""The rank side of the port's data-parallel CPU tests: gloo ranks that
run the cases a test wrote and save what each rank saw. It imports no JAX
and nothing of the JAX package, so the spawned ranks never load them
(pytest does not collect this file).

    python tests/torch_dp_ranks.py WORLD CASES_PKL OUT_DIR

starts WORLD gloo ranks on the CPU through the port's launcher
(``parallel/launch.run``); each runs every case of CASES_PKL (a list of
dicts: a ``kind``, the port config as ``Config.to_dict``, weights as numpy
trees, rays and batches as numpy arrays) and writes OUT_DIR/rank{r}.pkl,
one result a case. The kinds: ``step`` (``dp.make_dp_train_step`` over a
given batch), ``slice`` (``dp.make_slice_dp_train_step``), ``render``
(``dp.make_dp_render``), ``instep`` (the in-step form on the sphere:
per-ray draws, the sharded store, error-weighted draws) and ``multiscene``
(``multiscene.make_multiscene_train_step``). A step's result holds the
reduced gradients (what ``apply_grads`` left in ``.grad``), the updated
weights, the aux scalars and a digest of the whole state.
"""

import hashlib
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _np(t):
    return t.detach().cpu().numpy().copy()


def state_digest(state) -> str:
    """sha256 of every tensor of the state: weights, Adam's moments and
    counts, the EMA, the grid."""
    import torch

    h = hashlib.sha256()
    tensors = [p for _, p in sorted(state.params.state_dict().items())]
    if state.fine_params is not None:
        tensors += [p for _, p in sorted(state.fine_params.state_dict().items())]
    for per_param in state.optimizer.state_dict()["state"].values():
        tensors += [v for _, v in sorted(per_param.items()) if isinstance(v, torch.Tensor)]
    if state.grid is not None:
        tensors.append(state.grid)
    for t in tensors:
        h.update(_np(t).tobytes())
    return h.hexdigest()


def _state(cfg, case, device="cpu"):
    from nerf_rs_tpu_torch.convert import params_from_numpy
    from nerf_rs_tpu_torch.train import step

    state = step.init_state(cfg, device)
    if case.get("params") is not None:
        state.params.load_state_dict(params_from_numpy(case["params"]))
    return state


def _step_result(state, aux):
    from nerf_rs_tpu_torch.train.step import named_trainable

    return {"grads": {n: _np(p.grad) for n, p in named_trainable(state)},
            "params": {k: _np(v) for k, v in state.params.state_dict().items()},
            "aux": {k: float(v) for k, v in aux.items() if v.dim() == 0},
            "ray_err": _np(aux["ray_err"]), "digest": state_digest(state)}


def _batch(arrays):
    import torch

    from nerf_rs_tpu_torch.train.step import Batch

    return Batch(*(None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays))


def run_step(cfg, case):
    from nerf_rs_tpu_torch.parallel import dp, mesh as mesh_mod
    from nerf_rs_tpu_torch.train import step

    state = _state(cfg, case)
    if case["kind"] == "slice":
        fn = dp.make_slice_dp_train_step(cfg, mesh_mod.make_slice_mesh(case["slices"]))
    else:
        fn = dp.make_dp_train_step(cfg, mesh_mod.make_mesh())
    state, aux = fn(state, _batch(case["batch"]), step.step_generator(0, 0, "cpu"))
    return _step_result(state, aux)


def run_render(cfg, case):
    import torch

    from nerf_rs_tpu_torch.parallel import dp, mesh as mesh_mod
    from nerf_rs_tpu_torch.render import render_frame

    state = _state(cfg, case)
    o, d = (torch.from_numpy(a) for a in case["rays"])
    rgb, depth, acc = render_frame(cfg, state.params, o, d, dp.make_dp_render(cfg,
                                                                             mesh_mod.make_mesh()))
    return {"rgb": _np(rgb), "depth": _np(depth), "acc": _np(acc)}


def run_instep(cfg, case):
    """Three in-step steps on the sphere through the loop's pieces: per
    ray, with the sharded store (this rank's views) or error-weighted."""
    from nerf_rs_tpu_torch.data.dataset import update_error_store
    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.parallel import dist_init, dp, mesh as mesh_mod
    from nerf_rs_tpu_torch.train import step

    mesh = mesh_mod.make_mesh()
    rank, world = dist_init.rank(), dist_init.world_size()
    variant = case["variant"]
    shard = variant == "shard_store"
    ds = make_dataset(cfg, "cpu", local_multiple=world if shard else 1)
    if shard:
        ds = ds.view_block(rank, world)
    store = ds.init_error_store() if variant == "err" else None
    state = step.init_state(cfg, "cpu")
    fn = dp.make_dp_train_step(cfg, mesh, ds, shard_store=shard, err_store=store)
    per = -(-cfg.train.num_rays // world)
    out = {"digests": [], "batch_idx": [], "local_idx": [], "ray_err": [], "stores": [],
           "views": ds.num_views}
    for it in range(3):
        g = step.step_generator(cfg.train.seed, it, "cpu")
        if store is not None:
            before = store.clone()
            own = ds.sample_batch_error_weighted(dp.shard_generator(g, rank), per, before,
                                                 cfg.train.error_resample_frac).idx
            out["local_idx"].append(_np(own))
            out["stores"].append(_np(before))
        state, aux = fn(state, g)
        if store is not None:
            update_error_store(store, aux["batch_idx"], aux["ray_err"],
                               cfg.train.error_resample_ema)
            out["ray_err"].append(_np(aux["ray_err"]))
        out["batch_idx"].append(_np(aux["batch_idx"]))
        out["digests"].append(state_digest(state))
    if store is not None:
        out["stores"].append(_np(store))
    return out


def run_multiscene(cfg, case):
    from nerf_rs_tpu_torch.convert import params_from_numpy
    from nerf_rs_tpu_torch.parallel import mesh as mesh_mod, multiscene
    from nerf_rs_tpu_torch.train import step

    n = len(case["scene_params"])
    mesh = mesh_mod.make_scene_mesh(n)
    scenes = multiscene.local_scenes(mesh, n)
    states = multiscene.init_multiscene_state(cfg, mesh, n, "cpu")
    for state, i in zip(states, scenes):
        state.params.load_state_dict(params_from_numpy(case["scene_params"][i]))
    fn = multiscene.make_multiscene_train_step(cfg, mesh, n)
    states, auxes = fn(states, [_batch(case["batches"][i]) for i in scenes],
                       step.step_generator(0, 0, "cpu"))
    return {"scenes": list(scenes), "mesh": dict(mesh.shape),
            "results": [_step_result(s, a) for s, a in zip(states, auxes)]}


RUNNERS = {"step": run_step, "slice": run_step, "render": run_render, "instep": run_instep,
           "multiscene": run_multiscene}


def rank_main(cases_path: str, out_dir: str) -> int:
    import torch

    from nerf_rs_tpu_torch.config import Config
    from nerf_rs_tpu_torch.parallel import dist_init

    torch.set_num_threads(1)
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    results = [RUNNERS[c["kind"]](Config.from_dict(c["cfg"]), c) for c in cases]
    with open(os.path.join(out_dir, f"rank{dist_init.rank()}.pkl"), "wb") as f:
        pickle.dump(results, f)
    return 0


if __name__ == "__main__":
    from nerf_rs_tpu_torch.parallel import launch

    world, cases_path, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.exit(launch.run(rank_main, (cases_path, out_dir), world, "cpu"))
