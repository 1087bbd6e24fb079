"""Visual relative odometry core: descriptor matching, rigid 3D-3D
estimation, batched RANSAC and PnP, and the VO covariance (port of
``vision/matching.py``).

- descriptor matching is one matmul + ratio/mutual tests;
- RANSAC solves every hypothesis at once: all hypotheses sample, solve
  (closed-form Umeyama, one batched 3x3 SVD) and score in one batch;
- the edge information is the reference's Hessian of residuals
  (``CGraphGT::computeCovVRO``): sigma^-2 sum_k J_k^T J_k with
  J_k = R [-hat(p_k) | I] in the (omega, v) tangent.

The hypotheses' draws cannot be JAX's (``jax.random.categorical``): a
``key`` is a tuple of non-negative ints from which ``uniforms`` draws
float64 uniforms on the CPU (a ``torch.Generator`` seeded through numpy's
``SeedSequence``, as the plane RANSAC's draws are made);
they are mapped to valid points on the device with a cumsum and
``searchsorted``. So the card and the CPU make the same draws. With no
valid point the draw is uniform over all N points, as the reference's
``log(probs + 1e-30)`` logits make it.

Each function takes an optional leading batch axis through the private
``*_b`` forms, which ``frontend.match_one_to_many`` uses.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import se3, so3
from ..device import upload
from .cal3ds2 import Cal3DS2, project_point, project_point_jacobian

__all__ = ["MatchingResult", "match_descriptors", "umeyama", "ransac_rigid",
           "pnp_ransac", "vo_information", "uniforms"]


@dataclasses.dataclass
class MatchingResult:
    """The reference's ``MatchingResult`` record (edge between two frames)."""

    id_from: int
    id_to: int
    T: tuple                  # (R (3,3), t (3,)) numpy: frame id_to in id_from
    information: np.ndarray   # (6, 6)
    num_inliers: int
    succeed: bool

    @property
    def valid(self) -> bool:
        return self.succeed


def uniforms(key, shape, device) -> torch.Tensor:
    """float64 uniforms in [0, 1) of ``shape``, drawn on the CPU from a
    generator seeded by ``key`` (a tuple of non-negative ints, or one int;
    distinct keys, independent draws) and sent to ``device`` without a
    host sync. The plane RANSAC draws through it too."""
    key = (key,) if isinstance(key, (int, np.integer)) else key
    seed = np.random.SeedSequence([int(k) for k in key]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    return upload(u, device)


def _draw(u, valid):
    """Indices (B, ...) of points drawn by the uniforms ``u`` (B, ...):
    uniform over the valid points of each batch row (``valid`` (B, N)),
    uniform over all N where none is."""
    B, n = valid.shape
    csum = torch.cumsum(valid.to(torch.int64), dim=-1)       # (B, N)
    n_valid = csum[:, -1]
    pool = torch.where(n_valid > 0, n_valid, torch.full_like(n_valid, n))
    shape = (B,) + (1,) * (u.dim() - 1)
    pool = pool.reshape(shape)
    k = torch.minimum(torch.floor(u * pool.to(u.dtype)).to(torch.int64),
                      pool - 1)
    kv = torch.searchsorted(csum, k.reshape(B, -1), right=True).reshape(
        k.shape)
    return torch.where((n_valid > 0).reshape(shape), torch.clamp(
        kv, max=n - 1), k)


def _take(x, idx):
    """``x`` (B, N, ...) gathered at ``idx`` (B, ...) along N."""
    B = x.shape[0]
    flat = idx.reshape(B, -1)
    rows = torch.arange(B, device=x.device)[:, None]
    return x[rows, flat].reshape(*idx.shape, *x.shape[2:])


def _match_descriptors_b(desc_i, desc_j, ratio: float = 0.8,
                         mutual: bool = True):
    """``match_descriptors`` over a leading batch axis: desc_i (B, N, D),
    desc_j (B, M, D)."""
    sim = desc_i @ desc_j.transpose(-1, -2)          # cosine similarity
    d2 = 2.0 - 2.0 * sim                             # squared L2, unit norm
    nn1 = torch.argmin(d2, dim=-1)                   # first minimum on ties
    best = torch.min(d2, dim=-1).values
    d2_masked = d2.scatter(-1, nn1[..., None], torch.inf)
    second = torch.min(d2_masked, dim=-1).values
    ok = best < (ratio * ratio) * second
    if mutual:
        nn_back = torch.argmin(d2, dim=-2)           # best i for each j
        ar = torch.arange(d2.shape[-2], device=d2.device)
        ok = ok & (torch.gather(nn_back, -1, nn1) == ar)
    return nn1, ok


def match_descriptors(desc_i, desc_j, ratio: float = 0.8,
                      mutual: bool = True):
    """Nearest-neighbor matching with Lowe ratio + mutual-consistency tests.

    desc_*: (N, D) L2-normalized descriptors (padded rows allowed: zero
    rows never win). Returns (idx_j (N,), valid (N,)): for each feature in
    i, its match in j. One (N, D) @ (D, M) matmul does the work.
    """
    nn1, ok = _match_descriptors_b(desc_i[None], desc_j[None], ratio, mutual)
    return nn1[0], ok[0]


def _det3(M):
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def umeyama(p_src, p_dst, w):
    """Weighted closed-form rigid transform: R, t minimizing
    sum w_k ||R p_src_k + t - p_dst_k||^2 (Umeyama / Horn, SVD), over any
    leading batch axes. A degenerate set (repeated draws, zero weights)
    still gives a rotation."""
    w = w[..., None]
    ws = torch.sum(w, dim=-2, keepdim=True)
    ws = torch.where(ws > 0, ws, torch.ones_like(ws))
    mu_s = torch.sum(p_src * w, dim=-2, keepdim=True) / ws
    mu_d = torch.sum(p_dst * w, dim=-2, keepdim=True) / ws
    S = torch.einsum("...ki,...kj->...ij", (p_dst - mu_d) * w, p_src - mu_s)
    U, _, Vt = torch.linalg.svd(S)
    d = torch.sign(_det3(U @ Vt))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = (U * D[..., None, :]) @ Vt
    t = mu_d[..., 0, :] - (R @ mu_s[..., 0, :, None])[..., 0]
    return R, t


def _ransac_rigid_b(u, pts_src, pts_dst, valid, inlier_thresh: float = 0.05,
                    min_inliers: int = 12):
    """``ransac_rigid`` over a leading batch axis, its draw given as
    uniforms ``u`` (B, n_hyp, 3)."""
    B, n_hyp = u.shape[:2]
    samp = _draw(u, valid)                              # (B, n_hyp, 3)
    src3 = _take(pts_src, samp)                         # (B, n_hyp, 3, 3)
    dst3 = _take(pts_dst, samp)
    w3 = torch.ones(samp.shape, dtype=pts_src.dtype, device=pts_src.device)
    R, t = umeyama(src3, dst3, w3)                      # every hypothesis

    pred = torch.einsum("bhij,bnj->bhni", R, pts_src) + t[:, :, None, :]
    err = torch.linalg.norm(pred - pts_dst[:, None], dim=-1)
    inl = (err < inlier_thresh) & valid[:, None, :]
    best = torch.argmax(torch.sum(inl, dim=-1), dim=-1)  # first maximum
    mask = inl[torch.arange(B, device=u.device), best]

    # refit on the best hypothesis' inliers, twice
    for _ in range(2):
        Rb, tb = umeyama(pts_src, pts_dst, mask.to(pts_src.dtype))
        pe = (Rb[:, None] @ pts_src[..., None])[..., 0] + tb[:, None]
        e = torch.linalg.norm(pe - pts_dst, dim=-1)
        mask = (e < inlier_thresh) & valid
    ok = torch.sum(mask, dim=-1) >= min_inliers
    return Rb, tb, mask, ok


def ransac_rigid(key, pts_src, pts_dst, valid, n_hyp: int = 2048,
                 inlier_thresh: float = 0.05, min_inliers: int = 12):
    """All-hypotheses-at-once RANSAC for the 3D-3D rigid transform.

    pts_*: (N, 3) matched point pairs with ``valid`` mask. Samples 3
    correspondences per hypothesis (``uniforms(key, ...)``), solves
    Umeyama for all ``n_hyp`` hypotheses in one batch, scores inliers with
    one (n_hyp, N) distance matrix, refits on the best inlier set twice,
    and reports (R, t, inlier_mask, ok), all on the points' device.
    """
    u = uniforms(key, (1, n_hyp, 3), pts_src.device)
    R, t, inl, ok = _ransac_rigid_b(u, pts_src[None], pts_dst[None],
                                    valid[None], inlier_thresh, min_inliers)
    return R[0], t[0], inl[0], ok[0]


def _se3_right_jacobian(xi):
    """(..., 6, 6) right Jacobian of ``se3.expmap`` in the (omega, v)
    chart: Expmap(xi + d) ~ Expmap(xi) Expmap(Jr(xi) d); Jr(xi) = Jl(-xi)
    with Jl = [[Jl3(w), 0], [Q(w, v), Jl3(w)]]."""
    m = -xi
    Jl3 = so3.left_jacobian(m[..., :3])
    Q = se3._q_left(m)
    Z = torch.zeros_like(Jl3)
    return torch.cat([torch.cat([Jl3, Z], -1), torch.cat([Q, Jl3], -1)], -2)


def _gn(cal, pts, uv, w, iters, x0):
    """Fixed-trip damped GN for xi (se3 chart of T_ji), weighted, over a
    leading hypothesis axis: pts (H, N, 3), uv (H, N, 2), w (H, N),
    x0 (H, 6). The residual Jacobian is closed form: d uv / d p_cam
    (``project_point_jacobian``) . R [-hat(p) | I] . Jr(xi)."""
    x = x0
    eye = torch.eye(6, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        T = se3.expmap(x)
        pc = (T.R[:, None] @ pts[..., None])[..., 0] + T.t[:, None]
        uv_p, D = project_point_jacobian(cal, pc)         # (H, N, 2, 3)
        r = (uv_p - uv) * w[..., None]                    # (H, N, 2)
        A = torch.cat([-T.R[:, None] @ so3.hat(pts),
                       T.R[:, None].expand(-1, pts.shape[1], -1, -1)], -1)
        J = (D @ A @ _se3_right_jacobian(x)[:, None]) * w[..., None, None]
        J = J.reshape(J.shape[0], -1, 6)                  # (H, 2N, 6)
        H = J.transpose(-1, -2) @ J + 1e-4 * eye
        g = J.transpose(-1, -2) @ r.reshape(r.shape[0], -1, 1)
        x = x - torch.linalg.solve_ex(H, g)[0][..., 0]
    return x


def pnp_ransac(key, pts_i, uv_j, valid, cal: Cal3DS2, n_hyp: int = 512,
               inlier_px: float = 3.0, min_inliers: int = 12,
               gn_iters: int = 10):
    """Batched RANSAC-PnP: 3D points in frame i vs pixels in frame j.

    The frontend's PnP match path (``camera_node_pnp.h``): every 4-point
    hypothesis runs a fixed-trip Gauss-Newton on the se(3) chart of T_ji
    (``p_j = T_ji p_i``) from identity, all hypotheses in one batch of 6x6
    solves; scoring is one (n_hyp, N) reprojection pass.

    Returns (R_ij, t_ij, inlier_mask, ok): the pose of frame j in frame
    i, the frontend convention.
    """
    n = pts_i.shape[0]
    dtype, dev = pts_i.dtype, pts_i.device
    samp = _draw(uniforms(key, (1, n_hyp, 4), dev), valid[None])[0]
    p4 = pts_i[samp]                       # (n_hyp, 4, 3)
    u4 = uv_j[samp]                        # (n_hyp, 4, 2)
    xi_h = _gn(cal, p4, u4, torch.ones((n_hyp, 4), dtype=dtype, device=dev),
               gn_iters, torch.zeros((n_hyp, 6), dtype=dtype, device=dev))

    # score every hypothesis: one (n_hyp, N, 2) reprojection
    T_h = se3.expmap(xi_h)
    pc = torch.einsum("hij,nj->hni", T_h.R, pts_i) + T_h.t[:, None, :]
    uv_pred = project_point(cal, pc)
    err = torch.linalg.norm(uv_pred - uv_j[None], dim=-1)
    behind = pc[..., 2] < 1e-3
    inl = (err < inlier_px) & valid[None, :] & ~behind
    best = torch.argmax(torch.sum(inl, dim=1))

    # refit on the best inlier set, twice (warm-started)
    xi, mask = xi_h[best][None], inl[best]
    for _ in range(2):
        xi = _gn(cal, pts_i[None], uv_j[None], mask.to(dtype)[None],
                 gn_iters, xi)
        T = se3.expmap(xi[0])
        pcn = se3.transform_from(T, pts_i)
        e = torch.linalg.norm(project_point(cal, pcn) - uv_j, dim=-1)
        mask = (e < inlier_px) & valid & (pcn[..., 2] > 1e-3)
    ok = torch.sum(mask) >= min_inliers
    T_ij = se3.inverse(se3.expmap(xi[0]))
    return T_ij.R, T_ij.t, mask, ok


def vo_information(R, t, inlier_mask, pts_src, sigma: float = 0.01):
    """6x6 information of the VO edge from inlier geometry, over any
    leading batch axes.

    Gauss-Newton covariance of the rigid estimate in the (omega, v) chart:
    per-inlier Jacobian J_k = R [-hat(p_k) | I]; information =
    (1/sigma^2) * sum_k J_k^T J_k (computeCovVRO role, inverted).
    """
    m = inlier_mask.to(pts_src.dtype)
    P = so3.hat(pts_src)                                  # (..., N, 3, 3)
    Jw = -(R[..., None, :, :] @ P)                        # (..., N, 3, 3)
    Jv = R[..., None, :, :].expand_as(Jw)
    J = torch.cat([Jw, Jv], dim=-1)                       # (..., N, 3, 6)
    H = torch.einsum("...nei,...nej,...n->...ij", J, J, m)
    return H / (sigma * sigma)
