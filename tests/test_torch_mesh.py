"""The port's marching tetrahedra (``utils/mesh.py``) on the CPU against
the JAX package's (``tests/test_mesh.py``): both are numpy, so on a
sphere's signed distance (and a field's noisy grid, with colours) the
vertices, faces and colours are bit-equal and the PLY and OBJ files byte
for byte; the mesh is the analytic sphere's, closed and wound outward; and
``cli export --mesh`` writes it beside the point cloud.
"""

import os

import numpy as np
import pytest

from nerf_rs_tpu.utils import mesh as jmesh
from nerf_rs_tpu_torch import cli
from nerf_rs_tpu_torch.train import checkpoint as ckpt
from nerf_rs_tpu_torch.utils import mesh


def _sphere_grid(res=32, aabb=1.0, radius=0.5, scale=10.0):
    """sigma = scale (radius - |p|) at the cell centres: 0 at |p| = radius."""
    cell = 2.0 * aabb / res
    c = np.linspace(-aabb + cell / 2, aabb - cell / 2, res, dtype=np.float32)
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    return scale * (radius - np.sqrt(gx ** 2 + gy ** 2 + gz ** 2))


@pytest.mark.parametrize("res,chunk", [(16, 16), (24, 5), (32, 16)])
def test_marching_tetrahedra_is_the_jax_function(res, chunk):
    rng = np.random.default_rng(res)
    for sigma, rgb in ((_sphere_grid(res), None),
                       (_sphere_grid(res) + rng.normal(0, 1, (res,) * 3).astype(np.float32),
                        rng.uniform(0, 1, (res,) * 3 + (3,)).astype(np.float32))):
        got = mesh.marching_tetrahedra(sigma, 0.0, 1.0, rgb=rgb, chunk=chunk)
        want = jmesh.marching_tetrahedra(sigma, 0.0, 1.0, rgb=rgb, chunk=chunk)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_sphere_mesh_is_closed_outward_and_on_the_surface():
    """Vertices within 0.2 cells of the radius, every edge shared by two
    faces, every normal pointing away from the centre, the area within 3%
    of 4 pi r^2; an empty and a full grid give no faces."""
    res, radius = 32, 0.5
    verts, faces, _ = mesh.marching_tetrahedra(_sphere_grid(res, radius=radius), 0.0, 1.0)
    assert np.max(np.abs(np.linalg.norm(verts, axis=1) - radius)) < 0.2 * 2.0 / res
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), 1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    nrm = np.cross(v1 - v0, v2 - v0)
    assert ((nrm * (v0 + v1 + v2)).sum(1) > 0).all()
    area = 0.5 * np.linalg.norm(nrm, axis=1).sum()
    assert abs(area - 4 * np.pi * radius ** 2) < 0.03 * 4 * np.pi * radius ** 2
    for fill in (-1.0, 1.0):
        v, f, _ = mesh.marching_tetrahedra(np.full((8, 8, 8), fill, np.float32), 0.0, 1.0)
        assert f.shape == (0, 3)


def test_mesh_files_are_the_jax_files(tmp_path):
    sigma = _sphere_grid(res=12)
    rgb = np.full((12, 12, 12, 3), 0.5, np.float32)
    verts, faces, colors = mesh.marching_tetrahedra(sigma, 0.0, 1.0, rgb=rgb)
    for name, mine, theirs in (("c.ply", lambda p: mesh.save_mesh_ply(p, verts, faces, colors),
                                lambda p: jmesh.save_mesh_ply(p, verts, faces, colors)),
                               ("n.ply", lambda p: mesh.save_mesh_ply(p, verts, faces),
                                lambda p: jmesh.save_mesh_ply(p, verts, faces)),
                               ("m.obj", lambda p: mesh.save_mesh_obj(p, verts, faces),
                                lambda p: jmesh.save_mesh_obj(p, verts, faces))):
        mine(str(tmp_path / f"p-{name}"))
        theirs(str(tmp_path / f"j-{name}"))
        assert (tmp_path / f"p-{name}").read_bytes() == (tmp_path / f"j-{name}").read_bytes()
    head = (tmp_path / "p-c.ply").read_text().splitlines()
    assert f"element vertex {verts.shape[0]}" in head and f"element face {faces.shape[0]}" in head


def test_cli_export_mesh(tmp_path, capsys):
    """``export --mesh`` at a threshold inside the field's sigma range
    (softplus: a relu field of three steps is 0 everywhere)
    writes ``<out>_mesh.ply`` (the grid's mesh, as ``marching_tetrahedra``
    gives it) beside the point cloud."""
    common = ["--dataset", "sphere", "--width", "8", "--height", "8", "--num_samples", "8",
              "--sigma_activation", "softplus", "--save_dir", str(tmp_path / "ck"),
              "--device", "cpu"]
    assert cli.main(["train", *common, "--num_rays", "32", "--num_iter", "3",
                     "--eval_steps", "100", "--log_dir", str(tmp_path / "logs")]) == 0
    out = str(tmp_path / "field")
    assert cli.main(["export", *common, "--grid_res", "16", "--export_aabb", "1.0",
                     "--out", out]) == 0
    sigma = np.load(out + ".npz")["sigma"]
    thr = float(0.5 * (sigma.min() + sigma.max()))
    capsys.readouterr()
    assert cli.main(["export", *common, "--grid_res", "16", "--export_aabb", "1.0",
                     "--threshold", str(thr), "--mesh", "true", "--out", out]) == 0
    verts, faces, _ = mesh.marching_tetrahedra(sigma, thr, 1.0)
    assert faces.shape[0] > 0 and os.path.exists(out + ".ply")
    assert (f"mesh: {verts.shape[0]} verts / {faces.shape[0]} faces -> {out}_mesh.ply"
            in capsys.readouterr().out)
    txt = open(out + "_mesh.ply").read().splitlines()
    assert f"element face {faces.shape[0]}" in txt
    assert ckpt.latest_checkpoint(str(tmp_path / "ck")).endswith("-3.pt")
