"""Plane fitting from depth points (port of ``planes/extraction.py:50-90``).

Plane convention: ``(n, d)`` with ``n . p + d = 0``. The functions take an
explicit leading batch of planes/weights (the reference vmaps its
single-plane versions). ``extract_planes`` (batched RANSAC) is not ported
yet (ROADMAP item C).
"""

from __future__ import annotations

import torch

from . import oriented_plane

__all__ = ["point_plane_dist", "fit_plane_lsq", "plane_tangent_cov"]


def point_plane_dist(plane, pts):
    """|n . p + d| for (..., 4) plane(s) against (N, 3) points."""
    return torch.abs(torch.einsum("...i,ni->...n", plane[..., :3], pts)
                     + plane[..., 3:4])


def fit_plane_lsq(pts, w):
    """Weighted least-squares plane: centroid + smallest-eigvec normal.

    ``pts`` (N, 3), ``w`` (..., N) -> (..., 4). The eigenvector's sign is
    arbitrary (it differs between LAPACK builds); the flip that makes
    ``d >= 0`` canonicalises it, as in the reference.
    """
    w = w.to(pts.dtype)
    ws = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    mu = torch.einsum("...n,ni->...i", w, pts) / ws[..., None]
    centered = pts - mu[..., None, :]                      # (..., N, 3)
    C = torch.einsum("...ni,...nj->...ij", centered * w[..., None], centered)
    _, evecs = torch.linalg.eigh(C)
    n = evecs[..., :, 0]
    d = -torch.sum(n * mu, dim=-1)
    flip = torch.where(d < 0, -1.0, 1.0).to(pts.dtype)
    return torch.cat([n * flip[..., None], (d * flip)[..., None]], dim=-1)


def plane_tangent_cov(plane, pts, w, sigma_z: float = 0.014):
    """GN covariance of (n, d) in the OrientedPlane3 tangent chart.

    r_k = n . p_k + d with noise sigma_z; J_k = [p_k^T B(n), 1];
    cov = sigma_z^2 (sum w_k J_k^T J_k + 1e-9 I)^-1. ``plane`` (..., 4),
    ``pts`` (N, 3), ``w`` (..., N) -> (..., 3, 3).
    """
    B = oriented_plane.basis(plane[..., :3])               # (..., 3, 2)
    Jn = pts @ B                                           # (..., N, 2)
    J = torch.cat([Jn, torch.ones_like(Jn[..., :1])], dim=-1)
    H = torch.einsum("...ni,...nj,...n->...ij", J, J, w.to(pts.dtype))
    H = H + torch.eye(3, dtype=pts.dtype, device=pts.device) * 1e-9
    return sigma_z * sigma_z * torch.linalg.inv(H)
