"""The record preset's 64x64 learning drive in both packages from one start
and one stream of draws, run by hand (pytest does not collect this file):

    python tests/torch_record_pair.py start SEED OUT
    python tests/torch_record_pair.py jax STREAM STEPS OUT
    python tests/torch_record_pair.py port STREAM STEPS OUT
    python tests/torch_record_pair.py port-start SEED OUT
    python tests/torch_record_pair.py convert JAX_SAVE_DIR OUT

``start`` writes the JAX package's initial weights for ``--seed SEED``
(OUT/start.pkl, numpy arrays) and the same weights as a port checkpoint at
step 0 (OUT/port-start/), from which ``python -m nerf_rs_tpu_torch.cli train
--save_dir`` resumes, so the port's own draws can run from JAX's start.
``port-start`` is the other way round: the port's initial weights for
``--seed SEED`` as a JAX checkpoint at step 0 (OUT/jax-start/), for the JAX
CLI's resume. ``convert`` writes the newest JAX checkpoint under
JAX_SAVE_DIR (weights and occupancy grid) as a port checkpoint under OUT,
for the port's ``cli eval`` of JAX-trained weights.
``jax`` and ``port`` train from OUT/start.pkl for STEPS steps on the CPU
(the drive's flags: --num_samples 32 --num_fine_samples 64, 1024 rays, lr
1e-3, each package's eager step), with the batch's pixels from
numpy's default_rng(1000 + STREAM) and every uniform draw of the step and
of the occupancy grid's update (the coarse edges, the fine edges, the
grid's jitter) from numpy's default_rng((STREAM, step, *shape)): in JAX
through ``jax.random.uniform``, in the port through ``torch.rand``. Each
writes OUT/{jax,port}.log (per step: the loss, the share of the grid's
cells above ``occ_threshold``, seconds) and its checkpoint under OUT/, on
which each package's ``cli eval --preset record ... --max_views 4`` reads
the drive's PSNR. The two packages share no process: each side imports
only its own package."""

import os
import pickle
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ARGV = ["train", "--preset", "record", "--dataset", "sphere", "--width", "64", "--height", "64",
        "--num_samples", "32", "--num_fine_samples", "64", "--learning_rate", "1e-3",
        "--num_rays", "1024", "--use_whole_ray_train", "false", "--use_fused_kernel", "false"]
STEP = [0]


def draw(stream: int, shape: tuple) -> np.ndarray:
    return np.random.default_rng([stream, STEP[0], *shape]).random(shape, dtype=np.float32)


def jax_config(seed: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from nerf_rs_tpu import cli as jcli

    argv = ARGV + ["--seed", str(seed)]
    a = jcli.build_parser().parse_args(argv)
    a._explicit = jcli.explicit_dests(argv)
    return jcli.config_from_args(a)


def port_config(seed: int = 0):
    from nerf_rs_tpu_torch import cli

    argv = ARGV + ["--seed", str(seed), "--device", "cpu"]
    b = cli.build_parser().parse_args(argv)
    b._explicit = cli.explicit_dests(argv)
    return cli.config_from_args(b)


def start(seed: int, out: str) -> None:
    import jax

    from nerf_rs_tpu.train import step as jstep
    from nerf_rs_tpu_torch.convert import params_from_numpy
    from nerf_rs_tpu_torch.train import checkpoint as ckpt
    from nerf_rs_tpu_torch.train.step import init_state

    tree = jax.tree.map(np.asarray, jstep.init_state(jax.random.PRNGKey(seed),
                                                     jax_config(seed)).params)
    with open(os.path.join(out, "start.pkl"), "wb") as f:
        pickle.dump(tree, f)
    state = init_state(port_config())
    state.params.load_state_dict(params_from_numpy(tree))
    print(ckpt.save(state.params, os.path.join(out, "port-start"), step=0))


def port_start(seed: int, out: str) -> None:
    import jax
    import jax.numpy as jnp

    from nerf_rs_tpu.train import checkpoint as jckpt, step as jstep
    from nerf_rs_tpu_torch.convert import params_to_numpy
    from nerf_rs_tpu_torch.train.step import init_state

    cfg = jax_config(seed)
    state = jstep.init_state(jax.random.PRNGKey(seed), cfg)
    tree = params_to_numpy(dict(init_state(port_config(seed)).params.state_dict()))
    state = state._replace(params=jax.tree.map(jnp.asarray, tree))
    print(jckpt.save(state, os.path.join(out, "jax-start")))


def convert(src: str, out: str) -> None:
    import glob

    import jax
    import torch

    from nerf_rs_tpu.train import checkpoint as jckpt, step as jstep
    from nerf_rs_tpu_torch.convert import params_from_numpy
    from nerf_rs_tpu_torch.train import checkpoint as ckpt
    from nerf_rs_tpu_torch.train.step import init_state

    path = max(glob.glob(os.path.join(src, "checkpoint-*.msgpack")),
               key=lambda f: int(f.rsplit("-", 1)[1].split(".")[0]))
    js = jckpt.restore(path, jstep.init_state(jax.random.PRNGKey(0), jax_config(0)))
    state = init_state(port_config())
    state.params.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, js.params)))
    state.grid = torch.from_numpy(np.array(js.grid, dtype=np.float32))
    print(ckpt.save(state, out, step=int(js.step)))


def drive(side: str, stream: int, steps: int, out: str) -> None:
    with open(os.path.join(out, "start.pkl"), "rb") as f:
        tree = pickle.load(f)
    if side == "jax":
        import jax
        import jax.numpy as jnp

        cfg = jax_config(0)
        from nerf_rs_tpu.data import factory as jfactory
        from nerf_rs_tpu.ops import occupancy as jocc
        from nerf_rs_tpu.train import checkpoint as jckpt, step as jstep

        state = jstep.init_state(jax.random.PRNGKey(0), cfg)
        state = state._replace(params=jax.tree.map(jnp.asarray, tree))

        def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
            shape = tuple(shape)
            data = (jax.random.key_data(key)
                    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key) else key)
            u = jax.pure_callback(lambda k: draw(stream, shape),
                                  jax.ShapeDtypeStruct(shape, jnp.float32), data)
            return u * (maxval - minval) + minval

        jax.random.uniform = uniform
        ds = jfactory.make_dataset(cfg)
        dtype = jstep._matmul_dtype(cfg) or jnp.float32
    else:
        import torch

        from nerf_rs_tpu_torch.convert import params_from_numpy
        from nerf_rs_tpu_torch.data.factory import make_dataset
        from nerf_rs_tpu_torch.train import checkpoint as ckpt, step
        from nerf_rs_tpu_torch.train.loop import update_occupancy

        cfg = port_config()
        state = step.init_state(cfg)
        state.params.load_state_dict(params_from_numpy(tree))

        def rand(*size, generator=None, device=None, dtype=None, **kw):
            shape = (tuple(size[0]) if len(size) == 1
                     and isinstance(size[0], (tuple, list, torch.Size)) else tuple(size))
            return torch.from_numpy(draw(stream, shape)).to(device or "cpu")

        torch.rand = rand
        ds = make_dataset(cfg)
    rc = cfg.render
    rng = np.random.default_rng(1000 + stream)
    t0 = time.time()
    with open(os.path.join(out, f"{side}.log"), "w") as log:
        for it in range(steps):
            STEP[0] = it
            idx = rng.integers(0, ds.num_views * 64 * 64, 1024)
            if side == "jax":
                batch = ds.batch_from_idx(jnp.asarray(idx, jnp.int32))
                state, aux = jstep.train_step(state, batch, jax.random.PRNGKey(it), cfg)
                loss = float(aux["loss"])  # waits, so STEP is this step's in the callbacks
                if it % rc.occ_update_steps == 0:
                    grid = jocc.update_grid(state.grid, state.params, jax.random.PRNGKey(it),
                                            cfg.model, rc.occ_aabb, rc.occ_decay, dtype)
                    state = state._replace(grid=grid.block_until_ready())
                occ = float((state.grid > rc.occ_threshold).mean())
            else:
                state, aux = step.train_step(state, ds.batch_from_idx(torch.from_numpy(idx)),
                                             None, cfg)
                loss = float(aux["loss"])
                if it % rc.occ_update_steps == 0:
                    state.grid = update_occupancy(state, cfg, it)
                occ = float((state.grid > rc.occ_threshold).float().mean())
            print(it, f"{loss:.6f}", f"{occ:.4f}", f"{time.time() - t0:.0f}", file=log,
                  flush=True)
        if side == "jax":
            print(jckpt.save(state, os.path.join(out, "ck-jax")), file=log)
        else:
            print(ckpt.save(state, os.path.join(out, "ck-port")), file=log)


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode == "start" and len(sys.argv) == 4:
        os.makedirs(sys.argv[3], exist_ok=True)
        start(int(sys.argv[2]), sys.argv[3])
    elif mode == "port-start" and len(sys.argv) == 4:
        os.makedirs(sys.argv[3], exist_ok=True)
        port_start(int(sys.argv[2]), sys.argv[3])
    elif mode == "convert" and len(sys.argv) == 4:
        convert(sys.argv[2], sys.argv[3])
    elif mode in ("jax", "port") and len(sys.argv) == 5:
        os.makedirs(sys.argv[4], exist_ok=True)
        drive(mode, int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        sys.exit(__doc__)
