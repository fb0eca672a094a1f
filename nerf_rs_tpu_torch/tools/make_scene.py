"""Write a procedural Blender-format scene with the port (the counterpart
of ``tools/make_scene.py``, which runs the JAX package):

  python -m nerf_rs_tpu_torch.tools.make_scene --out data/proclego --size 800
  python -m nerf_rs_tpu_torch.tools.make_scene --out /tmp/lego --size 16 \\
      --n_train 2 --n_val 1 --n_test 1 --num_samples 64 --device cpu

Deterministic in ``--seed`` (the train, val and test camera rings are
disjoint draws); the gold frames are integrated on ``--device`` (the card
unless ``cpu`` is asked for). The scene: ``data/procedural.py``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nerf_rs_tpu_torch.tools.make_scene")
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, default=800)
    p.add_argument("--n_train", type=int, default=100)
    p.add_argument("--n_val", type=int, default=10)
    p.add_argument("--n_test", type=int, default=25)
    p.add_argument("--num_samples", type=int, default=512,
                   help="gold integration samples per ray")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scene", default="lego",
                   choices=["lego", "helix", "facing", "lego360", "deep360"],
                   help="procedural field (data/procedural.FIELDS); 'facing' is the "
                        "forward-facing rig for --ndc training, 'lego360' the unbounded "
                        "scene for --preset unbounded")
    p.add_argument("--device", default="cuda",
                   help="where the frames are integrated: cuda (the card; raises without "
                        "one) or cpu")
    args = p.parse_args(argv)

    from ..data.procedural import make_blender_scene
    from ..train.loop import resolve_device

    make_blender_scene(args.out, size=args.size, n_train=args.n_train, n_val=args.n_val,
                       n_test=args.n_test, num_samples=args.num_samples, seed=args.seed,
                       scene=args.scene, device=resolve_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
