"""Plane segmentation from depth points: batched RANSAC + LS refinement
(port of ``planes/extraction.py``).

Plane convention: ``(n, d)`` with ``n . p + d = 0``. The fitting helpers
take an explicit leading batch of planes/weights (the reference vmaps its
single-plane versions), and the points may carry the same leading batch.

``extract_planes`` is the greedy multi-plane RANSAC: all ``n_hyp``
hypotheses of a plane are scored in one batch, the best is refit twice by
least squares on its inlier set, and its inliers leave the cloud before
the next plane is sought (a static number of planes).

The random draw differs from the reference's, which samples with
``jax.random.categorical``: here the hypotheses' uniforms are drawn on the
CPU from an explicit ``torch.Generator`` (``hypothesis_uniforms``) and
each uniform picks the k-th point still in the cloud through a cumulative
sum and ``searchsorted`` on the points' device. The draw is therefore the
same on the card and on the CPU and makes no host sync; the detections
equal the reference's wherever the refits end on the same inlier sets
whatever the draw (the two-plane room, ``tests/test_torch_planes.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import oriented_plane

__all__ = ["PlaneDetection", "point_plane_dist", "fit_plane_lsq",
           "plane_tangent_cov", "hypothesis_uniforms", "extract_planes"]


class PlaneDetection(NamedTuple):
    """Fixed-capacity plane set of one frame (a leading frame axis when
    batched)."""

    params: torch.Tensor   # (P, 4) — (n, d), unit normal
    cov: torch.Tensor      # (P, 3, 3) — tangent covariance [basis(2), d]
    inlier: torch.Tensor   # (P, N) bool — membership per input point
    count: torch.Tensor    # (P,) int32 inlier counts
    valid: torch.Tensor    # (P,) bool


def point_plane_dist(plane, pts):
    """|n . p + d| for (..., 4) plane(s) against (..., N, 3) points."""
    return torch.abs(torch.einsum("...i,...ni->...n", plane[..., :3], pts)
                     + plane[..., 3:4])


def fit_plane_lsq(pts, w):
    """Weighted least-squares plane: centroid + smallest-eigvec normal.

    ``pts`` (..., N, 3), ``w`` (..., N) -> (..., 4). The eigenvector's sign
    is arbitrary (it differs between LAPACK builds); the flip that makes
    ``d >= 0`` canonicalises it, as in the reference.
    """
    w = w.to(pts.dtype)
    ws = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    mu = torch.einsum("...n,...ni->...i", w, pts) / ws[..., None]
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
    ``pts`` (..., N, 3), ``w`` (..., N) -> (..., 3, 3). ``inv_ex`` leaves
    its status on the device (``inv`` would read it back: a host sync).
    """
    B = oriented_plane.basis(plane[..., :3])               # (..., 3, 2)
    Jn = pts @ B                                           # (..., N, 2)
    J = torch.cat([Jn, torch.ones_like(Jn[..., :1])], dim=-1)
    H = torch.einsum("...ni,...nj,...n->...ij", J, J, w.to(pts.dtype))
    H = H + torch.eye(3, dtype=pts.dtype, device=pts.device) * 1e-9
    return sigma_z * sigma_z * torch.linalg.inv_ex(H)[0]


def _plane_from_3pts(p0, p1, p2):
    """Plane through 3 points + degeneracy flag (near-collinear samples)."""
    n = torch.linalg.cross(p1 - p0, p2 - p0)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    degenerate = norm[..., 0] < 1e-6
    n = n / torch.where(norm > 1e-12, norm, torch.ones_like(norm))
    d = -torch.sum(n * p0, dim=-1)
    return torch.cat([n, d[..., None]], dim=-1), degenerate


def hypothesis_uniforms(key, max_planes: int, n_hyp: int = 512):
    """The RANSAC draw of one frame: ``(max_planes, n_hyp, 3)`` float64
    uniforms in [0, 1), drawn on the CPU from a ``torch.Generator`` seeded
    from ``key``, a tuple of non-negative ints, through numpy's
    ``SeedSequence`` (the role of ``jax.random.fold_in``: distinct tuples,
    independent draws; ``vision.matching.uniforms``). The caller moves
    them to the points' device."""
    from ..vision.matching import uniforms

    return uniforms(key, (max_planes, n_hyp, 3), "cpu")


def _sample(u, remaining):
    """Map uniforms ``(B, S)`` to indices of points still in the cloud:
    uniform u picks the floor(u * n_remaining)-th remaining point. With no
    point left any index will do (the plane then fails its support)."""
    csum = torch.cumsum(remaining.to(torch.int64), dim=-1)   # (B, N)
    n_rem = csum[:, -1:]
    k = torch.floor(u * n_rem.to(u.dtype)).to(torch.int64)
    k = torch.minimum(k, torch.clamp(n_rem - 1, min=0))
    idx = torch.searchsorted(csum, k, right=True)
    return torch.clamp(idx, max=remaining.shape[-1] - 1)


def extract_planes(u, pts, valid, max_planes: int = 4,
                   dist_thresh: float = 0.02, min_support: int = 300,
                   sigma_z: float = 0.014) -> PlaneDetection:
    """Greedy multi-plane RANSAC over a (padded) point set.

    ``u`` holds the draw, ``(max_planes, n_hyp, 3)`` uniforms
    (``hypothesis_uniforms``) on the points' device; ``pts (N, 3)`` and
    ``valid (N,)``, or a leading frame axis on all three (``u (B, ...)``,
    ``pts (B, N, 3)``, ``valid (B, N)``), which extracts every frame in one
    batch. The computation runs in ``pts.dtype``.
    """
    single = pts.dim() == 2
    if single:
        u, pts, valid = u[None], pts[None], valid[None]
    B, n = pts.shape[:2]
    dtype, dev = pts.dtype, pts.device
    frames = torch.arange(B, device=dev)
    n_hyp = u.shape[-2]
    remaining = valid

    params_out = torch.zeros((B, max_planes, 4), dtype=dtype, device=dev)
    params_out[..., 2].fill_(1.0)
    cov_out = torch.zeros((B, max_planes, 3, 3), dtype=dtype, device=dev)
    inlier_out = torch.zeros((B, max_planes, n), dtype=torch.bool,
                             device=dev)
    count_out = torch.zeros((B, max_planes), dtype=torch.int32, device=dev)
    valid_out = torch.zeros((B, max_planes), dtype=torch.bool, device=dev)

    for p in range(max_planes):
        samp = _sample(u[:, p].reshape(B, -1), remaining)    # (B, n_hyp*3)
        corners = pts[frames[:, None], samp].reshape(B, n_hyp, 3, 3)
        cand, degen = _plane_from_3pts(corners[..., 0, :], corners[..., 1, :],
                                       corners[..., 2, :])
        inl = ((point_plane_dist(cand, pts[:, None]) < dist_thresh)
               & remaining[:, None, :])                      # (B, n_hyp, N)
        scores = torch.where(degen, -1, torch.sum(inl, dim=-1))
        best = torch.argmax(scores, dim=-1)

        # two LS refinement rounds on the inlier set
        m = inl[frames, best]
        plane = fit_plane_lsq(pts, m)
        m = (point_plane_dist(plane, pts) < dist_thresh) & remaining
        plane = fit_plane_lsq(pts, m)
        m = (point_plane_dist(plane, pts) < dist_thresh) & remaining
        cnt = torch.sum(m, dim=-1).to(torch.int32)
        ok = cnt >= min_support
        cov = plane_tangent_cov(plane, pts, m, sigma_z)

        params_out[:, p] = torch.where(ok[:, None], plane, params_out[:, p])
        cov_out[:, p] = torch.where(ok[:, None, None], cov, cov_out[:, p])
        inlier_out[:, p] = m & ok[:, None]
        count_out[:, p] = torch.where(ok, cnt, 0)
        valid_out[:, p] = ok
        remaining = remaining & ~(m & ok[:, None])

    det = PlaneDetection(params=params_out, cov=cov_out, inlier=inlier_out,
                         count=count_out, valid=valid_out)
    return PlaneDetection(*(x[0] for x in det)) if single else det
