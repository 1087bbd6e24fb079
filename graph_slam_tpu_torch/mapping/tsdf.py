"""TSDF fusion: dense volumetric mapping, one grid update per frame (port of
``graph_slam_tpu/mapping/tsdf.py``).

The reference's mapping tier accumulates raw point clouds and meshes them
with greedy projection triangulation (mapping_PCD.cpp, pcd2mesh.cpp); this
is the volumetric upgrade: a truncated signed distance field over a fixed
voxel grid, integrated by projective association (KinectFusion-style).

``integrate`` is the reference's elementwise pass over the (N, N, N) grid
as torch operations on the grid's device, in the reference's arithmetic
and order: the voxel centres in the grid's dtype, the geometry in the
grid's dtype promoted with the pose's (float64 for the float64 poses of
``fuse_trajectory``, as JAX promotes under x64), half-to-even rounding to
the pixel. The grid is updated in place (the reference donates it) in
slabs along the first axis, which bound the temporaries (a 512^3 grid is
537 MB a float32 field) and do not change the result. Divisors are
tensors: the card divides a tensor by a Python scalar as a product with
its reciprocal.

``extract_mesh`` is marching tetrahedra in two parts: the candidate cubes
(all eight corners observed, a sign change among them) are found on the
device with exact comparisons, and only those cubes' corner values come
to the host, where the tetrahedra, the interpolation and the vertex weld
are the reference's numpy. ``extract_mesh_numpy`` is the reference's
whole extraction in numpy, the plain version the tests hold it to.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CameraIntrinsics
from ..core import se3
from ..device import resolve, to_host
from .pointcloud import _traj_pose

__all__ = ["TsdfVolume", "make_volume", "integrate", "candidate_cubes",
           "extract_mesh", "extract_mesh_numpy", "fuse_trajectory"]

# voxels a slab of ``integrate`` covers at most: ~1.5 GB of float64
# temporaries at its peak
SLAB_VOXELS = 1 << 24


class TsdfVolume(NamedTuple):
    tsdf: torch.Tensor     # (N, N, N) f32 in [-1, 1] (1 = free / far)
    weight: torch.Tensor   # (N, N, N) f32
    origin: torch.Tensor   # (3,) world position of voxel (0,0,0) corner
    voxel: torch.Tensor    # () voxel edge length in meters


def make_volume(origin, size_m: float, n: int = 128,
                dtype=torch.float32, *, device=None) -> TsdfVolume:
    """Cubic volume with corner at ``origin`` spanning ``size_m`` meters, on
    ``device`` (``None``: the CUDA card)."""
    dev = resolve(device)
    return TsdfVolume(
        tsdf=torch.ones((n, n, n), dtype=dtype, device=dev),
        weight=torch.zeros((n, n, n), dtype=dtype, device=dev),
        origin=torch.as_tensor(np.asarray(origin, np.float64)).to(dev,
                                                                  dtype),
        voxel=torch.tensor(size_m / n, dtype=dtype, device=dev),
    )


def integrate(vol: TsdfVolume, K: CameraIntrinsics, depth, pose_R, pose_t,
              trunc_vox: float = 4.0, w_max: float = 64.0,
              z_min: float = 0.05, z_max: float = 10.0) -> TsdfVolume:
    """Fuse one depth frame taken from camera-to-world pose (R, t) into
    ``vol`` in place; returns ``vol``.

    Projective TSDF: for every voxel, sdf = observed depth along the
    voxel's pixel ray minus the voxel's camera depth, truncated at
    ``trunc_vox`` voxels and averaged into the grid (weight capped at
    ``w_max`` so the map can still adapt). Pinhole projection without
    distortion. One pass covers the planes of the first axis that hold at
    most ``SLAB_VOXELS`` voxels.
    """
    n = vol.tsdf.shape[0]
    dt = vol.tsdf.dtype
    dev = vol.tsdf.device
    depth = torch.as_tensor(depth).to(dev, dt)
    h, w = depth.shape
    R = torch.as_tensor(pose_R).to(dev)
    t = torch.as_tensor(pose_t).to(dev)
    ct = torch.promote_types(dt, torch.promote_types(R.dtype, t.dtype))
    R, t = R.to(ct), t.to(ct)
    trunc = trunc_vox * vol.voxel
    neg_trunc = (-trunc).to(ct)
    trunc = trunc.to(ct)
    flat = depth.reshape(-1)

    idx = (torch.arange(n, dtype=dt, device=dev) + 0.5) * vol.voxel
    dy = ((vol.origin[1] + idx).to(ct) - t[1])[None, :, None]
    dz = ((vol.origin[2] + idx).to(ct) - t[2])[None, None, :]
    slab = max(1, SLAB_VOXELS // (n * n))
    for i0 in range(0, n, slab):
        i1 = min(n, i0 + slab)
        # world -> camera: p_c = R^T (p_w - t)
        dx = ((vol.origin[0] + idx[i0:i1]).to(ct) - t[0])[:, None, None]
        cx_ = R[0, 0] * dx + R[1, 0] * dy + R[2, 0] * dz
        cy_ = R[0, 1] * dx + R[1, 1] * dy + R[2, 1] * dz
        cz_ = R[0, 2] * dx + R[1, 2] * dy + R[2, 2] * dz
        safe_z = torch.where(cz_ > 1e-6, cz_, 1.0)
        u = K.fx * cx_ / safe_z + K.cx
        v = K.fy * cy_ / safe_z + K.cy
        del cx_, cy_, safe_z
        # the reference casts the rounded pixel to int32 and clips; the
        # clamp comes first here (an out-of-range cast is undefined), which
        # gives the same pixel wherever the voxel is in view
        ui = torch.clamp(torch.round(u), 0, w - 1).to(torch.int64)
        vi = torch.clamp(torch.round(v), 0, h - 1).to(torch.int64)
        d = flat[vi * w + ui]
        del ui, vi
        in_view = ((cz_ > z_min) & (u >= 0) & (u <= w - 1)
                   & (v >= 0) & (v <= h - 1) & (d > z_min) & (d < z_max))
        del u, v
        sdf = d.to(ct) - cz_
        del d, cz_
        upd = in_view & (sdf > neg_trunc)
        del in_view
        tsdf_obs = torch.clamp(sdf / trunc, -1.0, 1.0)
        del sdf
        t_old = vol.tsdf[i0:i1]
        w_old = vol.weight[i0:i1]
        t_new = ((t_old * w_old).to(ct) + tsdf_obs) \
            / torch.clamp(w_old + 1.0, min=1.0).to(ct)
        del tsdf_obs
        torch.where(upd, t_new.to(dt), t_old, out=t_old)
        del t_new
        torch.where(upd, torch.clamp(w_old + 1.0, max=w_max), w_old,
                    out=w_old)
    return vol


# ---------------------------------------------------------------------------
# Marching tetrahedra (candidates on the device, the rest on the host)

# 6-tet decomposition of a cube around the 0-7 diagonal (each tet is a
# bit-monotone path 0 -> a -> b -> 7); cube corner k = (k>>2, k>>1, k) & 1
_TETS = np.array([(0, 5, 1, 7), (0, 1, 3, 7), (0, 3, 2, 7),
                  (0, 2, 6, 7), (0, 6, 4, 7), (0, 4, 5, 7)], dtype=np.int64)

# tet edge list: local corner pairs
_TET_EDGES = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
                      dtype=np.int64)

_CORNERS = np.array([(k >> 2 & 1, k >> 1 & 1, k & 1) for k in range(8)],
                    np.int64)                          # (8, 3)


def _build_mt_table():
    """16-case marching-tetrahedra table: up to 2 triangles per case, each
    triangle = 3 edge ids into ``_TET_EDGES``; -1 pads."""
    table = -np.ones((16, 6), np.int64)
    edge_id = {(a, b): k for k, (a, b) in enumerate(map(tuple, _TET_EDGES))}
    edge_id.update({(b, a): k for (a, b), k in list(edge_id.items())})

    def edges_from(c, others):
        return [edge_id[(c, o)] for o in others]

    for case in range(1, 15):
        inside = [c for c in range(4) if case >> c & 1]
        if len(inside) == 1:
            c = inside[0]
            others = [o for o in range(4) if o != c]
            table[case, :3] = edges_from(c, others)
        elif len(inside) == 3:
            c = [o for o in range(4) if o not in inside][0]
            others = [o for o in range(4) if o != c]
            table[case, :3] = edges_from(c, others)
        else:  # 2-2 split: quad ring -> two triangles
            a, b = inside
            o1, o2 = [o for o in range(4) if o not in inside]
            ring = [edge_id[(a, o1)], edge_id[(b, o1)],
                    edge_id[(b, o2)], edge_id[(a, o2)]]
            table[case, :3] = [ring[0], ring[1], ring[2]]
            table[case, 3:] = [ring[0], ring[2], ring[3]]
    return table


_MT_TABLE = _build_mt_table()


def _shifted(x, c, n):
    """The (n-1)^3 view of ``x`` at cube corner offset ``c``."""
    return x[c[0]:n - 1 + c[0], c[1]:n - 1 + c[1], c[2]:n - 1 + c[2]]


def candidate_cubes(vol: TsdfVolume, min_weight: float = 1.0):
    """The cubes marching tetrahedra visits, on the volume's device: every
    cube whose 8 corners are observed (weight >= ``min_weight``) and whose
    values straddle zero. Returns ``(cubes (M, 3) int64, values (M, 8))``
    as tensors, cubes in C order (``np.argwhere``'s), values in the
    volume's dtype at ``_CORNERS``."""
    n = vol.tsdf.shape[0]
    observed = neg = pos = None
    for c in _CORNERS:
        w_c = _shifted(vol.weight, c, n) >= min_weight
        v_c = _shifted(vol.tsdf, c, n)
        observed = w_c if observed is None else observed & w_c
        neg = v_c < 0 if neg is None else neg | (v_c < 0)
        pos = v_c >= 0 if pos is None else pos | (v_c >= 0)
    cubes = torch.nonzero(observed & neg & pos)
    corners = torch.as_tensor(_CORNERS, device=cubes.device)
    at = cubes[:, None, :] + corners[None]             # (M, 8, 3)
    values = vol.tsdf[at[..., 0], at[..., 1], at[..., 2]]
    return cubes, values


def _triangulate(cz, cval, origin, voxel: float):
    """Marching tetrahedra over candidate cubes ``cz`` (M, 3) with corner
    values ``cval`` (M, 8) float64, then the 1e-6-voxel vertex weld: the
    reference's host body."""
    if len(cz) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    # per-cube corner positions (voxel centers)
    cpos = (cz[:, None, :] + _CORNERS[None]) * voxel \
        + origin + 0.5 * voxel                         # (M, 8, 3)

    tris = []
    for tet in _TETS:
        tv = cval[:, tet]                              # (M, 4)
        tp = cpos[:, tet]                              # (M, 4, 3)
        case = ((tv < 0) << np.arange(4)).sum(1)       # (M,)
        rows = _MT_TABLE[case]                         # (M, 6)
        # interpolated vertex on each of the 6 tet edges
        a = _TET_EDGES[:, 0]
        b = _TET_EDGES[:, 1]
        va, vb = tv[:, a], tv[:, b]                    # (M, 6)
        tfrac = va / np.where(np.abs(va - vb) < 1e-12, 1e-12, va - vb)
        tfrac = np.clip(tfrac, 0.0, 1.0)
        everts = tp[:, a] + tfrac[..., None] * (tp[:, b] - tp[:, a])
        for t0 in (0, 3):
            sel = rows[:, t0] >= 0
            if not sel.any():
                continue
            e = rows[sel, t0:t0 + 3]                   # (S, 3)
            vv = everts[sel]                           # (S, 6, 3)
            tris.append(np.stack([vv[np.arange(len(e)), e[:, k]]
                                  for k in range(3)], axis=1))
    if not tris:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    soup = np.concatenate(tris)                        # (T, 3, 3)
    # weld vertices on a 1e-6 grid
    flat = soup.reshape(-1, 3)
    keys = np.round(flat / (1e-6 * voxel)).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    verts = np.zeros((len(uniq), 3))
    verts[inv] = flat
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return verts, faces[good]


def extract_mesh(vol: TsdfVolume, min_weight: float = 1.0):
    """Zero-isosurface of the fused TSDF as (vertices (V,3), faces (F,3)).

    Marching tetrahedra over every cube whose 8 corners are all observed
    (weight >= min_weight) and whose values straddle zero: the candidates
    on the device (``candidate_cubes``), the triangles on the host. The
    result equals ``extract_mesh_numpy``'s bit for bit.
    """
    cz, cval, origin, voxel = to_host((*candidate_cubes(vol, min_weight),
                                       vol.origin, vol.voxel))
    return _triangulate(cz, cval.astype(np.float64),
                        origin.astype(np.float64), float(voxel))


def extract_mesh_numpy(tsdf, weight, origin, voxel, min_weight: float = 1.0):
    """The reference's ``extract_mesh`` whole, in numpy, over host arrays:
    the plain version ``extract_mesh`` is held to."""
    tsdf = np.asarray(tsdf, np.float64)
    wgt = np.asarray(weight)
    origin = np.asarray(origin, np.float64)
    voxel = float(voxel)
    n = tsdf.shape[0]
    # candidate cubes: fully observed + sign change among corners
    vals8 = np.stack([_shifted(tsdf, c, n) for c in _CORNERS])
    wt8 = np.stack([_shifted(wgt, c, n) for c in _CORNERS])
    observed = (wt8 >= min_weight).all(0)
    neg = (vals8 < 0).any(0)
    pos = (vals8 >= 0).any(0)
    cand = observed & neg & pos                        # (n-1, n-1, n-1)
    cz = np.argwhere(cand)                             # (M, 3)
    cval = vals8[:, cand.nonzero()[0], cand.nonzero()[1],
                 cand.nonzero()[2]].T                  # (M, 8)
    return _triangulate(cz, cval, origin, voxel)


def fuse_trajectory(traj, frames, K: CameraIntrinsics, origin,
                    size_m: float, n: int = 128, stride: int = 1,
                    u2c: se3.Pose | None = None, trunc_vox: float = 4.0, *,
                    device=None):
    """Fuse every ``stride``-th trajectory frame into a fresh volume on
    ``device`` (``None``: the CUDA card).

    ``traj``: io.Trajectory (camera/IMU-to-world poses, w-x-y-z quats);
    ``frames``: seq_id -> (intensity, depth_m) | None. Poses are float64,
    as the reference's under x64.
    """
    dev = resolve(device)
    vol = make_volume(origin, size_m, n, device=dev)
    for k in range(0, len(traj.ids), stride):
        got = frames(int(traj.seq[k]))
        if got is None:
            continue
        pose = _traj_pose(traj, k, u2c, dev)
        integrate(vol, K, got[1], pose.R, pose.t, trunc_vox=trunc_vox)
    return vol
