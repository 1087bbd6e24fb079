"""Synthetic generators (port of ``datasets/synthetic.py:22-96,174-202``).

``make_sphere_graph`` builds the sphere2500-class pose graph: a spiral over
a sphere with odometry edges and short-range loop closures, ~4 edges per
pose like the classic g2o sphere2500 (2500 poses / 9799 edges). It draws
the same numpy random numbers in the same order as the reference, so the
two packages build the same graph from the same seed.

``_render_plane_frame`` ray-casts depth and intensity of world planes
(the plane-rescue scenario's renderer), a numpy copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..graph import GraphBuilder

__all__ = ["make_sphere_graph", "sphere_ground_truth"]


def _so3_exp(w):
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-10:
        return np.eye(3) + W
    return np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th**2 * (W @ W)


def sphere_ground_truth(n_poses: int, radius: float = 10.0, turns: int = 25):
    """Spiral over a sphere: positions + smooth headings (numpy)."""
    k = np.arange(n_poses)
    phi = np.arccos(1 - 2 * (k + 0.5) / n_poses)      # polar angle 0..pi
    lam = np.pi * turns * phi                          # azimuth spiral
    pos = radius * np.stack(
        [np.sin(phi) * np.cos(lam), np.sin(phi) * np.sin(lam), np.cos(phi)],
        axis=1,
    )
    Rs = []
    for i in range(n_poses):
        if i + 1 < n_poses:
            fwd = pos[i + 1] - pos[i]
        else:
            fwd = pos[i] - pos[i - 1]
        fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
        up = pos[i] / (np.linalg.norm(pos[i]) + 1e-12)
        left = np.cross(up, fwd)
        left /= np.linalg.norm(left) + 1e-12
        fwd2 = np.cross(left, up)
        Rs.append(np.stack([fwd2, left, up], axis=1))
    return np.stack(Rs), pos


def make_sphere_graph(n_poses: int = 2500, edges_per_pose: float = 4.0,
                      meas_noise: float = 0.02, init_noise: float = 0.1,
                      seed: int = 0, *, dtype=torch.float32, device=None,
                      bucket: int = 256):
    """Build (graph, values, gt) for the sphere stress benchmark, on the
    CUDA card unless ``device`` names another."""
    device = resolve(device)
    r = np.random.default_rng(seed)
    Rs, ts = sphere_ground_truth(n_poses)

    def between(i, j):
        return Rs[i].T @ Rs[j], Rs[i].T @ (ts[j] - ts[i])

    b = GraphBuilder()
    for i in range(n_poses):
        if i == 0 or init_noise == 0:
            b.add_pose((Rs[i], ts[i]))
        else:
            dR = _so3_exp(r.normal(size=3) * init_noise * 0.3)
            b.add_pose((Rs[i] @ dR, ts[i] + r.normal(size=3) * init_noise))
    b.add_prior_pose(0, (Rs[0], ts[0]), sigmas=np.full(6, 1e-6))

    info = np.diag([100.0, 100.0, 100.0, 25.0, 25.0, 25.0])

    def noisy(Rij, tij):
        dR = _so3_exp(r.normal(size=3) * meas_noise * 0.3)
        return Rij @ dR, tij + r.normal(size=3) * meas_noise

    for i in range(n_poses - 1):
        b.add_between(i, i + 1, noisy(*between(i, i + 1)), information=info)

    n_extra = int((edges_per_pose - 1.0) * n_poses)
    # short-range loop closures: nodes nearby in space (same sphere band)
    cand_i = r.integers(0, n_poses - 1, size=3 * n_extra)
    cand_j = cand_i + r.integers(2, 50, size=3 * n_extra)
    keep = cand_j < n_poses
    cand_i, cand_j = cand_i[keep][:n_extra], cand_j[keep][:n_extra]
    for i, j in zip(cand_i, cand_j):
        b.add_between(int(i), int(j), noisy(*between(int(i), int(j))),
                      information=info)

    graph, values = b.build(bucket=bucket, device=device, dtype=dtype)
    return graph, values, (Rs, ts)


def _render_plane_frame(K, R_cam, t_cam, scene, noise=0.0, seed=0):
    """Ray-cast depth+intensity of a set of world planes from a camera pose.

    ``scene`` is [(plane4_world, intensity_value), ...] with plane form
    ``n . x + d = 0``; the camera pose is world-from-camera (R, t). Returns
    float32 numpy (intensity, depth), depth 0 where no plane is hit.
    """
    r = np.random.default_rng(seed)
    h, w = K.height, K.width
    us, vs = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    rays = np.stack([(us - K.cx) / K.fx, (vs - K.cy) / K.fy,
                     np.ones_like(us)], axis=-1)          # (H, W, 3)
    depth = np.full((h, w), np.inf)
    inten = np.zeros((h, w), np.float32)
    for plane_w, value in scene:
        n, d = np.asarray(plane_w[:3]), float(plane_w[3])
        # plane in the camera frame: n_c = R^T n, d_c = d + n . t
        n_c = R_cam.T @ n
        d_c = d + n @ t_cam
        denom = rays @ n_c
        safe = np.where(np.abs(denom) > 1e-9, denom, 1.0)
        z = np.where(np.abs(denom) > 1e-9, -d_c / safe, np.inf)
        hit = (z > 0.2) & (z < depth)
        depth = np.where(hit, z, depth)
        inten = np.where(hit, value, inten)
    depth = np.where(np.isfinite(depth), depth, 0.0)
    if noise:
        depth = depth + r.normal(size=depth.shape) * noise * (depth > 0)
    return inten.astype(np.float32), depth.astype(np.float32)
