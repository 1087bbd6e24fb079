"""OrientedPlane3 manifold on torch tensors (port of
``planes/oriented_plane.py``).

A plane is a 4-vector ``(nx, ny, nz, d)`` with unit ``n`` and plane
equation ``n.x + d = 0``. The normal lives on S^2 with a 2-dof tangent in
the GTSAM ``Unit3::basis``; the distance is additive.
"""

from __future__ import annotations

import torch

__all__ = ["normalize", "basis", "retract", "local", "transform",
           "error_vector"]


def normalize(plane):
    """Normalize the (n, d) 4-vector so ||n|| = 1 (d scales with it)."""
    norm = torch.linalg.norm(plane[..., :3], dim=-1, keepdim=True)
    return plane / torch.where(norm > 0, norm, torch.ones_like(norm))


def basis(n):
    """Orthonormal tangent basis B(n): (..., 3, 2), GTSAM ``Unit3::basis``.

    Cross with the x axis when |n_z| is the largest component, else with z.
    """
    ax, ay, az = torch.abs(n[..., 0]), torch.abs(n[..., 1]), torch.abs(n[..., 2])
    use_x = (az >= ax) & (az >= ay)
    one, zero = torch.ones_like(ax), torch.zeros_like(ax)
    axis = torch.where(use_x[..., None],
                       torch.stack([one, zero, zero], -1),
                       torch.stack([zero, zero, one], -1))
    b1 = torch.linalg.cross(n, axis)
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    b2 = torch.linalg.cross(n, b1)
    return torch.stack([b1, b2], dim=-1)


def retract(plane, xi):
    """Sphere expmap on n along B(n) xi[:2]; d += xi[2]."""
    n = plane[..., :3]
    d = plane[..., 3]
    v = xi[..., :2]
    B = basis(n)
    theta2 = torch.sum(v * v, dim=-1)
    big = theta2 > 1e-16
    theta = torch.sqrt(torch.where(big, theta2, torch.ones_like(theta2)))
    sinc = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    cosv = torch.where(big, torch.cos(theta), 1.0 - theta2 / 2.0)
    Bv = (B @ v[..., None])[..., 0]
    n_new = cosv[..., None] * n + sinc[..., None] * Bv
    n_new = n_new / torch.linalg.norm(n_new, dim=-1, keepdim=True)
    return torch.cat([n_new, (d + xi[..., 2])[..., None]], dim=-1)


def local(plane_a, plane_b):
    """Tangent of plane_b in the chart at plane_a (inverse of retract)."""
    na, nb = plane_a[..., :3], plane_b[..., :3]
    B = basis(na)
    cos_t = torch.clamp(torch.sum(na * nb, dim=-1), -1.0, 1.0)
    perp = nb - cos_t[..., None] * na
    pn2 = torch.sum(perp * perp, dim=-1)
    tiny = torch.finfo(cos_t.dtype).tiny ** 0.5
    ok = pn2 > tiny
    pn = torch.sqrt(torch.where(ok, pn2, torch.ones_like(pn2)))
    pn_safe = torch.where(ok, pn, torch.zeros_like(pn))
    theta = torch.atan2(pn_safe, cos_t)
    scale = torch.where(ok, theta / pn, torch.ones_like(pn))
    w = scale[..., None] * perp
    v = (B.transpose(-1, -2) @ w[..., None])[..., 0]
    return torch.cat([v, (plane_b[..., 3] - plane_a[..., 3])[..., None]],
                     dim=-1)


def transform(plane, pose_R, pose_t):
    """World plane seen from a frame with world-from-frame pose (R, t):
    ``n' = R^T n``, ``d' = d + n . t`` (GTSAM ``OrientedPlane3::transform``).
    """
    n = plane[..., :3]
    d = plane[..., 3]
    n_local = (pose_R.transpose(-1, -2) @ n[..., None])[..., 0]
    d_local = d + torch.sum(n * pose_t, dim=-1)
    return torch.cat([n_local, d_local[..., None]], dim=-1)


def error_vector(measured, predicted):
    """GTSAM ``OrientedPlane3Factor`` error: local(measured -> predicted)."""
    return local(measured, predicted)
