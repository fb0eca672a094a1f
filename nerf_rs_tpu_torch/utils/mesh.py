"""Triangle meshes from the sampled density grid, the counterpart of
``nerf_rs_tpu/utils/mesh.py`` (vectorised numpy, the same arithmetic bit
for bit): marching tetrahedra over sigma > threshold. Each grid cell
splits into 6 tetrahedra around its main diagonal, and the 16 in/out cases
of a tetrahedron reduce to three shapes (none, one triangle, a quad), built
by ``_tet_case_table`` rather than copied from a table. Shared cell faces
split along the same diagonal, so interior crossings close up; each
triangle's winding points its normal away from the inside (sigma >
threshold) corners of its tetrahedron. Vertices sit on grid edges at the
linearly interpolated threshold crossing and are shared through their
(corner, corner) edge key. ``save_mesh_ply`` and ``save_mesh_obj`` write
ASCII PLY (with vertex colours) and Wavefront OBJ.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# Cube corners indexed by bits (x, y, z): corner c has offset
# ((c >> 2) & 1, (c >> 1) & 1, c & 1).
_CORNER_OFF = np.array(
    [[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)], np.int64
)

# 6-tetrahedra decomposition of the cube, every tet sharing the main
# diagonal 0-7. Adjacent cells split their shared faces identically
# (each face's diagonal always runs through the lexicographically
# smallest corner), which is what makes the global mesh watertight.
_TETS = np.array(
    [
        [0, 5, 1, 7],
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
    ],
    np.int64,
)


def _tet_case_table() -> List[List[Tuple[int, int]]]:
    """For each 4-bit inside-mask: the crossing triangles as a flat
    list of (local tet vertex a, local tet vertex b) edge pairs, 3 per
    triangle. Derived, not transcribed: 1 or 3 inside corners -> the
    3 edges incident to the lone corner; 2 inside -> the quad of the 4
    in/out edges split into two triangles."""
    table: List[List[Tuple[int, int]]] = []
    for mask in range(16):
        inside = [v for v in range(4) if mask & (1 << v)]
        outside = [v for v in range(4) if not mask & (1 << v)]
        if len(inside) in (0, 4):
            table.append([])
        elif len(inside) == 1 or len(inside) == 3:
            lone = inside[0] if len(inside) == 1 else outside[0]
            others = [v for v in range(4) if v != lone]
            table.append([(lone, others[0]), (lone, others[1]),
                          (lone, others[2])])
        else:  # 2 in / 2 out: quad (p,r)-(p,s)-(q,s)-(q,r)
            p, q = inside
            r, s = outside
            table.append([
                (p, r), (p, s), (q, s),
                (p, r), (q, s), (q, r),
            ])
    return table


_CASES = _tet_case_table()


def marching_tetrahedra(
    sigma: np.ndarray,
    threshold: float,
    aabb: float,
    rgb: np.ndarray | None = None,
    chunk: int = 16,
):
    """Extract the sigma == threshold isosurface as a triangle mesh.

    Args:
      sigma: (res, res, res) float grid of cell-center densities
        (utils/export.sample_density_grid layout: axis order x, y, z,
        centers spanning [-aabb, aabb] per axis).
      threshold: iso value (same units as --threshold of the point
        cloud export).
      aabb: half-extent of the sampled cube.
      rgb: optional (res, res, res, 3) float grid; per-vertex colors
        are sampled at the nearest grid cell of each vertex.
      chunk: x-slabs of cells processed per pass (bounds peak memory:
        a 512^3 grid never materializes 6 * 511^3 tet masks at once).

    Returns:
      (verts (V, 3) f32 world coordinates, faces (F, 3) int64 indices,
       colors (V, 3) uint8 or None).
    """
    res = sigma.shape[0]
    if sigma.shape != (res, res, res):
        raise ValueError(f"sigma must be a cube, got {sigma.shape}")
    sigma = np.asarray(sigma, np.float32)
    inside_grid = sigma > threshold

    tri_edge_a: List[np.ndarray] = []  # global corner indices
    tri_edge_b: List[np.ndarray] = []
    tri_inside_ctr: List[np.ndarray] = []  # per-face inside centroid

    cell = 2.0 * aabb / res
    first = -aabb + cell / 2.0

    def corner_coords(idx: np.ndarray) -> np.ndarray:
        k = idx % res
        j = (idx // res) % res
        i = idx // (res * res)
        return first + cell * np.stack([i, j, k], axis=-1).astype(np.float32)

    n1 = res - 1
    for x0 in range(0, n1, chunk):
        nx = min(chunk, n1 - x0)
        ii, jj, kk = np.meshgrid(
            np.arange(x0, x0 + nx), np.arange(n1), np.arange(n1),
            indexing="ij",
        )
        base = (ii * res + jj) * res + kk  # (nx, n1, n1) corner 0 index
        base = base.reshape(-1)
        # global corner index per cube corner: (cells, 8)
        off = (_CORNER_OFF[:, 0] * res + _CORNER_OFF[:, 1]) * res \
            + _CORNER_OFF[:, 2]
        corners = base[:, None] + off[None, :]
        ins = inside_grid.reshape(-1)[corners]  # (cells, 8) bool

        for tet in _TETS:
            tc = corners[:, tet]  # (cells, 4) global corner ids
            ti = ins[:, tet]  # (cells, 4)
            case = (ti * (1 << np.arange(4))).sum(axis=1)  # (cells,)
            for m in range(1, 15):
                edges = _CASES[m]
                if not edges:
                    continue
                sel = np.nonzero(case == m)[0]
                if sel.size == 0:
                    continue
                sel_tc = tc[sel]  # (n, 4)
                n_tri = len(edges) // 3
                ea = sel_tc[:, [e[0] for e in edges]]  # (n, 3*n_tri)
                eb = sel_tc[:, [e[1] for e in edges]]
                tri_edge_a.append(ea.reshape(-1, 3))
                tri_edge_b.append(eb.reshape(-1, 3))
                # inside centroid of this tet (for winding): mean of
                # inside corners' coordinates
                in_mask = np.array(
                    [bool(m & (1 << v)) for v in range(4)], bool
                )
                ctr = corner_coords(sel_tc[:, in_mask]).mean(axis=1)
                tri_inside_ctr.append(
                    np.repeat(ctr, n_tri, axis=0)
                )

    if not tri_edge_a:
        empty = np.zeros((0, 3), np.float32)
        return empty, np.zeros((0, 3), np.int64), None

    ea = np.concatenate(tri_edge_a)  # (F, 3) global corner a per vertex
    eb = np.concatenate(tri_edge_b)
    ctr = np.concatenate(tri_inside_ctr)  # (F, 3)

    # dedupe vertices by undirected edge key
    lo = np.minimum(ea, eb)
    hi = np.maximum(ea, eb)
    key = lo.astype(np.int64) * (res * res * res) + hi
    uniq, faces_flat = np.unique(key, return_inverse=True)
    faces = faces_flat.reshape(-1, 3)

    ulo = (uniq // (res * res * res)).astype(np.int64)
    uhi = (uniq % (res * res * res)).astype(np.int64)
    sa = sigma.reshape(-1)[ulo]
    sb = sigma.reshape(-1)[uhi]
    t = np.clip((threshold - sa) / np.where(sb != sa, sb - sa, 1.0), 0.0, 1.0)
    pa = corner_coords(ulo)
    pb = corner_coords(uhi)
    verts = (pa + t[:, None] * (pb - pa)).astype(np.float32)

    # normalize winding: normal must point AWAY from the inside corners
    v0, v1, v2 = (verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]])
    nrm = np.cross(v1 - v0, v2 - v0)
    outward = ((v0 + v1 + v2) / 3.0) - ctr
    flip = (nrm * outward).sum(axis=1) < 0.0
    faces[flip] = faces[flip][:, ::-1]

    colors = None
    if rgb is not None:
        idx = np.clip(
            np.round((verts - first) / cell).astype(np.int64), 0, res - 1
        )
        colors = np.clip(
            rgb[idx[:, 0], idx[:, 1], idx[:, 2]] * 255.0, 0, 255
        ).astype(np.uint8)
    return verts, faces, colors


def save_mesh_ply(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray,
    colors: np.ndarray | None = None,
) -> None:
    """ASCII PLY triangle mesh (+ optional uchar vertex colors)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {verts.shape[0]}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {faces.shape[0]}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        if colors is not None:
            for (x, y, z), (r, g, b) in zip(verts, colors):
                f.write(f"{x:.5f} {y:.5f} {z:.5f} {r} {g} {b}\n")
        else:
            for x, y, z in verts:
                f.write(f"{x:.5f} {y:.5f} {z:.5f}\n")
        for a, b, c in faces:
            f.write(f"3 {a} {b} {c}\n")


def save_mesh_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Wavefront OBJ (1-indexed faces); colors are PLY-only."""
    with open(path, "w") as f:
        for x, y, z in verts:
            f.write(f"v {x:.5f} {y:.5f} {z:.5f}\n")
        for a, b, c in faces:
            f.write(f"f {a + 1} {b + 1} {c + 1}\n")
