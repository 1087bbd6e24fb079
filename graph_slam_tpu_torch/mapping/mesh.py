"""Point cloud -> triangle mesh (pcd2mesh twin) — a copy of
``graph_slam_tpu/mapping/mesh.py`` (numpy only, on the host).

The reference's ``mapping/pcd2mesh.cpp`` runs PCL greedy projection
triangulation. Equivalent here: organize points into a voxel-hash grid,
connect k-nearest neighbourhoods by local 2D Delaunay-style fans —
simplified to a *grid-projection triangulation*: points are binned into an
(az, el) or (x, y) grid (dominant-plane projection) and adjacent occupied
cells are triangulated. Produces watertight-enough meshes for the viewer
outputs the reference generates; exact PCL parity is not a goal (the
reference itself calls an external library).
"""

from __future__ import annotations

import numpy as np


__all__ = ["grid_triangulate", "write_ply_mesh", "pcd_to_mesh"]


def grid_triangulate(points, cell: float = 0.05, max_edge: float = 0.15):
    """Project onto the dominant plane, grid-bin, and triangulate adjacent
    cells. Returns (vertices (V,3), faces (F,3) int)."""
    pts = np.asarray(points, np.float64)
    if len(pts) < 3:
        return pts, np.zeros((0, 3), np.int64)
    mu = pts.mean(axis=0)
    C = (pts - mu).T @ (pts - mu)
    _, vecs = np.linalg.eigh(C)
    # basis: two largest-variance directions
    b1, b2 = vecs[:, 2], vecs[:, 1]
    u = (pts - mu) @ b1
    v = (pts - mu) @ b2
    iu = np.floor(u / cell).astype(np.int64)
    iv = np.floor(v / cell).astype(np.int64)
    iu -= iu.min()
    iv -= iv.min()
    W = iv.max() + 1
    key = iu * W + iv
    # one representative point per cell (first occurrence)
    _, first = np.unique(key, return_index=True)
    cell_of = {int(key[i]): int(i) for i in sorted(first)}

    faces = []

    def vid(ku, kv):
        return cell_of.get(int(ku * W + kv))

    for (k, idx) in cell_of.items():
        ku, kv = divmod(k, W)
        a = idx
        b = vid(ku + 1, kv)
        c = vid(ku, kv + 1)
        d = vid(ku + 1, kv + 1)

        def close(i, j):
            return np.linalg.norm(pts[i] - pts[j]) <= max_edge

        if b is not None and c is not None and close(a, b) and close(a, c) \
                and close(b, c):
            faces.append((a, b, c))
        if b is not None and c is not None and d is not None \
                and close(b, d) and close(c, d) and close(b, c):
            faces.append((b, d, c))
    return pts, np.asarray(faces, np.int64).reshape(-1, 3)


def write_ply_mesh(path: str, vertices, faces, color=(200, 200, 200)):
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for p in vertices:
            f.write(f"{float(p[0])!r} {float(p[1])!r} {float(p[2])!r} "
                    f"{color[0]} {color[1]} {color[2]}\n")
        for t in faces:
            f.write(f"3 {int(t[0])} {int(t[1])} {int(t[2])}\n")


def pcd_to_mesh(points, out_path: str, cell: float = 0.05,
                max_edge: float = 0.15):
    """pcd2mesh main: triangulate + write mesh PLY."""
    verts, faces = grid_triangulate(points, cell, max_edge)
    write_ply_mesh(out_path, verts, faces)
    return verts, faces
