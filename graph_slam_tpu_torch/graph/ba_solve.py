"""Schur-complement landmark elimination for bundle adjustment (port of
``graph/ba_solve.py``).

Eliminate the (many) Point3 landmarks first, solve the reduced camera
system, back-substitute. Two forms of the same damped GN step:

- ``schur_gn_step`` / ``ba_gn_optimize``: the normal equations. The
  pose-landmark coupling ``U`` is a dense (Dp, Pq, 3) tensor and the
  reduced Hessian ``S = A - U L^-1 U^T`` two matmuls plus batched 3x3
  inverses. The reduction cancels catastrophically in float32 (both terms
  ~1e10-1e13 for pixel-whitened BA while S is orders smaller), so it runs
  in float64 whatever the arena dtype; the per-factor work stays in the
  arena dtype.
- ``sqrt_schur_gn_step`` / ``ba_gn_optimize_sqrt``: the square-root (QR)
  form, float32-stable. Each landmark's observation rows are stacked as

      M_q = [ J_q (2K x 3) | J_p blockdiag (2K x 6K) | r (2K x 1) ]
            [ L^T          | 0                       | L^-1 g     ]

  where the landmark's priors and the damping merge into one 3-row block
  (L the closed-form Cholesky of sum J_prior^T J_prior + lambda I). Three
  Householder reflections zero its first three columns: rows 0:3 are the
  landmark's [R3 | E | c1], kept for back-substitution, rows 3: the
  orthogonally reduced pose rows. The reduced system is the sum over
  landmarks of each landmark's Gram block ``red^T red`` (6K x 6K) added
  at its pose columns: a batched matmul and one scatter-add per landmark
  chunk. The reference relocates columns with a one-hot matmul instead
  (its accelerator serializes scatters), 2 Pq nred Dp^2 operations where
  the Gram form needs Pq nred (6K)^2; ``tests/test_torch_ba.py`` holds the
  two forms to each other. The Gram products run in the arena's dtype;
  the reduced system (Dp x Dp) is accumulated, factored and solved in
  float64. Each of its entries sums ~10^3 landmark blocks, whose float32
  rounding reaches the size of the system's smallest eigenvalue at
  100,000 landmarks: summed in float32, that configuration's Cholesky
  failed and its chi2 went NaN on the card, where float64 costs next to
  nothing at Dp = 1,920.

``assembly_precision="high"`` forms each Gram block from three bf16
products of its operands (hi.hi + hi.lo + lo.hi, the reference's bf16x3),
accumulated in float32, and adds a 5e-5 relative jitter to S's
diagonal. The bf16-rounded parts are multiplied in the operands' own
dtype, where a product of two bf16 values is exact, so the card and the
CPU compute the same sums.
"""

from __future__ import annotations

import numpy as np
import torch

from . import factors as F
from .assemble import dense_hg
from .factors import FactorGraph, total_error
from .solve import solve_dense
from .variables import VariableArena, layout_of, retract_all, used_slot_mask

__all__ = ["schur_gn_step", "ba_gn_optimize",
           "build_point_obs", "sqrt_schur_gn_step", "ba_gn_optimize_sqrt"]

_JITTER = 5e-5   # relative diagonal jitter under reduced-precision assembly


def _nonpoint_blocks(graph: FactorGraph, values: VariableArena):
    """(r, J, cols) for every table that touches no point landmark."""
    def none(t):
        return type(t)(*(x[:0] for x in t))

    return F.linearize_blocks(graph._replace(
        projection=none(graph.projection),
        prior_point=none(graph.prior_point)), values)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def schur_gn_step(graph: FactorGraph, values: VariableArena, damping):
    """One GN step with point landmarks eliminated by Schur complement."""
    lay = layout_of(values)
    Dp, Pq = lay.point_off, lay.point_cap
    dt, dev = values.pose_t.dtype, values.pose_t.device
    mask_p = used_slot_mask(values)[:Dp]

    blocks = _nonpoint_blocks(graph, values)
    g_q = torch.zeros(Pq, 3, dtype=dt, device=dev)
    U = torch.zeros(Dp, Pq, 3, dtype=dt, device=dev)
    live_q = (torch.arange(Pq, device=dev) < values.num_points).to(dt)
    Lblk = (damping * live_q + (1.0 - live_q))[:, None, None] \
        * _eye(3, mask_p)

    if graph.projection.pose_idx.shape[0]:
        r, J = F._projection_lin(values, graph.projection)
        Jp, Jq = J[:, :, :6], J[:, :, 6:]
        cp = lay.pose_cols(graph.projection.pose_idx)
        qidx = graph.projection.point_idx
        blocks.append((r, Jp, cp))
        g_q.index_add_(0, qidx, torch.einsum("fei,fe->fi", Jq, r))
        U.index_put_((cp, qidx[:, None].expand(-1, 6)),
                     torch.einsum("fei,fej->fij", Jp, Jq), accumulate=True)
        Lblk.index_add_(0, qidx, torch.einsum("fei,fej->fij", Jq, Jq))
    if graph.prior_point.idx.shape[0]:
        r, J = F._prior_vec_lin(graph.prior_point, values.point)
        qidx = graph.prior_point.idx
        g_q.index_add_(0, qidx, torch.einsum("fei,fe->fi", J, r))
        Lblk.index_add_(0, qidx, torch.einsum("fei,fej->fij", J, J))
    A, g_p = dense_hg(blocks, mask_p)
    A.diagonal().add_(damping)

    # the reduction and the reduced solve in float64
    rd = torch.float64
    U64 = U.to(rd).reshape(Dp, 3 * Pq)
    gq64 = g_q.to(rd)
    Linv = torch.linalg.inv_ex(Lblk.to(rd))[0]
    WL = torch.einsum("dqi,qij->dqj", U64.reshape(Dp, Pq, 3), Linv)
    S = A.to(rd) - WL.reshape(Dp, 3 * Pq) @ U64.T
    Lg = torch.einsum("qij,qj->qi", Linv, gq64)
    dp = solve_dense(S, g_p.to(rd) - U64 @ Lg.reshape(-1), 0.0)

    Ut_dp = (dp @ U64).reshape(Pq, 3)
    dq = -torch.einsum("qij,qj->qi", Linv, gq64 + Ut_dp).reshape(-1)
    return retract_all(values, torch.cat([dp, dq]).to(dt))


def ba_gn_optimize(graph: FactorGraph, values: VariableArena,
                   iterations: int = 8, damping: float = 1e-6):
    """GN with Schur elimination, fixed trip count: (values, chi2)."""
    for _ in range(iterations):
        values = schur_gn_step(graph, values, damping)
    return values, total_error(graph, values)


# ---------------------------------------------------------------------------
# Square-root (QR) Schur elimination


def _by_landmark(idx, active, cap: int, min_width: int):
    """(cap, W) table of the active rows of each landmark, in row order
    (zero-padded), and its validity mask; W = max(min_width, most rows)."""
    rows = np.flatnonzero(active)
    q = idx[rows]
    order = np.argsort(q, kind="stable")
    q, rows = q[order], rows[order]
    counts = np.bincount(q, minlength=cap)
    W = max(min_width, int(counts.max()) if counts.size else 0)
    pos = np.arange(q.size) - (np.cumsum(counts) - counts)[q]
    tab = np.zeros((cap, W), np.int64)
    valid = np.zeros((cap, W), bool)
    tab[q, pos] = rows
    valid[q, pos] = True
    return tab, valid


def build_point_obs(graph: FactorGraph, point_cap: int):
    """Host-side landmark -> row index tables (static sparsity).

    Returns numpy ``(obs_idx (Pq, K) int64, obs_valid (Pq, K) bool,
    prior_row (Pq, P) int64, prior_valid (Pq, P) bool)``: ``obs_idx`` lists
    each landmark's active projection rows (K = most observations of a
    landmark, at least 1), ``prior_row`` its active point-prior rows
    (P = most priors of a landmark, 0 when none has one; several priors on
    one landmark all ride the QR stack).
    """
    def host(x):
        return x.detach().cpu().numpy()

    pj, pp = graph.projection, graph.prior_point
    obs_idx, obs_valid = _by_landmark(host(pj.point_idx), host(pj.active),
                                      point_cap, 1)
    prior_row, prior_valid = _by_landmark(host(pp.idx), host(pp.active),
                                          point_cap, 0)
    return obs_idx, obs_valid, prior_row, prior_valid


def _eliminate3(M):
    """Orthogonally zero the first 3 columns of each (m, n) stack with 3
    batched Householder reflections (the first 3 steps of QR).

    Rows ``0:3`` come out as ``[R3 | E | c1]`` with ``R3`` upper
    triangular; rows ``3:`` are the orthogonally reduced factor.
    """
    M = M.clone()
    for c in range(3):
        x = M[:, c:, c]
        nx = torch.sqrt(torch.sum(x * x, dim=1))
        sgn = torch.where(x[:, 0] >= 0, 1.0, -1.0).to(M.dtype)
        v = x.clone()
        v[:, 0] += sgn * nx                               # x - alpha e1
        vn = torch.sqrt(torch.sum(v * v, dim=1))
        big = vn > 1e-30
        inv = torch.where(big, 1.0 / torch.where(big, vn, torch.ones_like(
            vn)), torch.zeros_like(vn))
        v = v * inv[:, None]
        w = torch.einsum("pi,pij->pj", v, M[:, c:, :])
        M[:, c:, :] -= 2.0 * v[:, :, None] * w[:, None, :]
    return M


def _bf16_split(x):
    """x = hi + lo + O(2^-16 |x|), hi and lo bf16 values in x's dtype."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    return hi, (x - hi).to(torch.bfloat16).to(x.dtype)


def _gram(red, rhs, precision):
    """Each landmark's (6K, 6K) Gram block red^T red and (6K,) red^T rhs."""
    redT = red.transpose(1, 2)
    if precision is None:
        return redT @ red, (redT @ rhs[:, :, None])[:, :, 0]
    if precision != "high":
        raise ValueError(f"assembly_precision must be None or 'high', not "
                         f"{precision!r}")
    hi, lo = _bf16_split(red)
    rhi, rlo = _bf16_split(rhs[:, :, None])
    hiT, loT = hi.transpose(1, 2), lo.transpose(1, 2)
    return (hiT @ hi + hiT @ lo + loT @ hi,
            (hiT @ rhi + hiT @ rlo + loT @ rhi)[:, :, 0])


def _landmark_qr_reduce(graph: FactorGraph, values: VariableArena, lay,
                        obs_idx, obs_valid, prior_row, prior_valid,
                        q_ids, damping, chunk: int,
                        assembly_precision=None):
    """Per-landmark QR elimination and the reduced system's assembly.

    ``q_ids`` are the global landmark indices of these table rows
    (``arange(Pq)`` on one device; a shard's slice when landmarks are
    sharded). Returns the landmark part ``(S (Dp, Dp), g (Dp,))`` in
    float64 (no
    damping, priors or non-point terms: callers add those once) and the
    back-substitution pieces ``(R3, E, c1, cp_flat, live)``. The Gram
    blocks are formed and added ``chunk`` landmarks at a time, which bounds
    the assembly's work arrays ((chunk, 6K, 6K) blocks and their indices).
    """
    Dp = lay.point_off
    dt = values.pose_t.dtype
    Pq, K = obs_idx.shape
    nloc = 6 * K

    r_all, J_all = F._projection_lin(values, graph.projection)
    v = obs_valid.to(dt)
    J_g = J_all[obs_idx] * v[:, :, None, None]            # (Pq, K, 2, 9)
    r_g = r_all[obs_idx] * v[:, :, None]                  # (Pq, K, 2)
    Mq = J_g[..., 6:].reshape(Pq, 2 * K, 3)
    Mp = torch.einsum("qkej,kl->qkelj", J_g[..., :6], _eye(K, v)).reshape(
        Pq, 2 * K, nloc)                                  # block diagonal
    Mr = r_g.reshape(Pq, 2 * K, 1)

    live = (q_ids < values.num_points).to(dt)
    if graph.prior_point.idx.shape[0] and prior_row.shape[1]:
        rp_all, Jp_all = F._prior_vec_lin(graph.prior_point, values.point)
        pv = prior_valid.to(dt)
        Jpr = Jp_all[prior_row] * pv[:, :, None, None]    # (Pq, P, 3, 3)
        rpr = rp_all[prior_row] * pv[:, :, None]
        Hp = torch.einsum("qpij,qpik->qjk", Jpr, Jpr)
        gp = torch.einsum("qpij,qpi->qj", Jpr, rpr)
    else:
        Hp = torch.zeros(Pq, 3, 3, dtype=dt, device=v.device)
        gp = torch.zeros(Pq, 3, dtype=dt, device=v.device)
    lam = damping * live + (1.0 - live)   # a dead landmark gets identity
    Hp = Hp + lam[:, None, None] * _eye(3, v)
    # closed-form 3x3 Cholesky H = L L^T and forward solve L c = g
    tiny = torch.tensor(1e-30, dtype=dt, device=v.device)
    l11 = torch.sqrt(torch.maximum(Hp[:, 0, 0], tiny))
    l21 = Hp[:, 1, 0] / l11
    l31 = Hp[:, 2, 0] / l11
    l22 = torch.sqrt(torch.maximum(Hp[:, 1, 1] - l21 * l21, tiny))
    l32 = (Hp[:, 2, 1] - l31 * l21) / l22
    l33 = torch.sqrt(torch.maximum(Hp[:, 2, 2] - l31 * l31 - l32 * l32,
                                   tiny))
    c1p = gp[:, 0] / l11
    c2p = (gp[:, 1] - l21 * c1p) / l22
    c3p = (gp[:, 2] - l31 * c1p - l32 * c2p) / l33
    z = torch.zeros_like(l11)
    Lt = torch.stack([torch.stack([l11, l21, l31], -1),
                      torch.stack([z, l22, l32], -1),
                      torch.stack([z, z, l33], -1)], dim=1)   # L^T
    merged = torch.cat([Lt, torch.zeros(Pq, 3, nloc, dtype=dt,
                                        device=v.device),
                        torch.stack([c1p, c2p, c3p], -1)[:, :, None]], -1)
    M = torch.cat([torch.cat([Mq, Mp, Mr], dim=-1), merged], dim=1)

    Rq = _eliminate3(M)
    R3 = Rq[:, :3, :3]
    E = Rq[:, :3, 3:3 + nloc]
    c1 = Rq[:, :3, -1]
    red_pose = Rq[:, 3:, 3:3 + nloc]                      # (Pq, nred, 6K)
    red_rhs = Rq[:, 3:, -1]                               # (Pq, nred)
    cp_flat = lay.pose_cols(graph.projection.pose_idx)[obs_idx].reshape(
        Pq, nloc)

    # invalid observation slots carry all-zero columns through the QR, so
    # their Gram rows add nothing at the pose they point to
    S = torch.zeros(Dp, Dp, dtype=torch.float64, device=v.device)
    g = torch.zeros(Dp, dtype=torch.float64, device=v.device)
    C = max(1, min(chunk, Pq))
    for s0 in range(0, Pq, C):
        G, gl = _gram(red_pose[s0:s0 + C], red_rhs[s0:s0 + C],
                      assembly_precision)
        cp = cp_flat[s0:s0 + C]
        S.view(-1).index_add_(
            0, (cp[:, :, None] * Dp + cp[:, None, :]).reshape(-1),
            G.reshape(-1).to(S.dtype))
        g.index_add_(0, cp.reshape(-1), gl.reshape(-1).to(g.dtype))
    return (S, g), (R3, E, c1, cp_flat, live)


def _add_nonpoint_and_base(graph, values, lay, S, g, damping):
    """Non-landmark factor blocks + pose damping + unused-slot identity."""
    H, g_np = dense_hg(_nonpoint_blocks(graph, values),
                       used_slot_mask(values)[:lay.point_off])
    S = S + H.to(S.dtype)
    S.diagonal().add_(damping)
    return S, g + g_np.to(g.dtype)


def _backsub_points(R3, E, c1, cp_flat, live, dp):
    """Landmark updates from the kept QR rows: (Pq, 3), by an explicit
    3x3 upper-triangular back-substitution."""
    b = -(c1 + torch.einsum("qij,qj->qi", E, dp[cp_flat]))
    x2 = b[:, 2] / R3[:, 2, 2]
    x1 = (b[:, 1] - R3[:, 1, 2] * x2) / R3[:, 1, 1]
    x0 = (b[:, 0] - R3[:, 0, 1] * x1 - R3[:, 0, 2] * x2) / R3[:, 0, 0]
    return torch.stack([x0, x1, x2], dim=-1) * live[:, None]


def _clip_rows(d, dim, max_norm):
    """Per-variable trust region: scale (N*dim,) tangent rows whose norm
    exceeds ``max_norm`` down to it."""
    rows = d.reshape(-1, dim)
    n = torch.linalg.norm(rows, dim=1, keepdim=True)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-30), max=1.0)
    return (rows * scale).reshape(-1)


def _clip_nonpoint(dp, lay, max_norm):
    """Per-variable trust region over the non-point tangent, each variable
    clipped by its own width (poses 6, velocities 3, biases 6, planes 3)."""
    segs = [_clip_rows(dp[off:off + width * cap], width, max_norm)
            for off, width, cap in (
                (lay.pose_off, 6, lay.pose_cap),
                (lay.vel_off, 3, lay.vel_cap),
                (lay.bias_off, 6, lay.bias_cap),
                (lay.plane_off, 3, lay.plane_cap)) if cap]
    return torch.cat(segs)


def sqrt_schur_gn_step(graph: FactorGraph, values: VariableArena,
                       obs_idx, obs_valid, prior_row, prior_valid,
                       damping, chunk: int = 2048, step_clip=None,
                       assembly_precision=None):
    """One damped GN step by per-landmark QR elimination (float32-stable).

    The tables are ``build_point_obs``'s, as tensors on the arena's device.
    ``step_clip`` (meters/radians) is a per-variable trust region on the
    update: a weakly constrained landmark (one grazing observation and a
    loose prior) can solve to a huge finite step whose squared residual
    overflows float32 chi2; GN has no globalization of its own.
    ``assembly_precision="high"`` forms the reduced system from bf16x3
    products and jitters its diagonal by 5e-5 relative, which keeps its
    Cholesky positive definite under the assembly's error.
    """
    lay = layout_of(values)
    Pq = obs_idx.shape[0]
    (S, g), back = _landmark_qr_reduce(
        graph, values, lay, obs_idx, obs_valid, prior_row, prior_valid,
        torch.arange(Pq, device=obs_idx.device), damping, chunk,
        assembly_precision=assembly_precision)
    S, g = _add_nonpoint_and_base(graph, values, lay, S, g, damping)
    if assembly_precision is not None:
        S.diagonal().mul_(1.0 + _JITTER)
    dp = solve_dense(S, g, 0.0).to(values.pose_t.dtype)
    dq = _backsub_points(*back, dp).reshape(-1)
    if step_clip is not None:
        dp = _clip_nonpoint(dp, lay, step_clip)
        dq = _clip_rows(dq, 3, step_clip)
    return retract_all(values, torch.cat([dp, dq]))


def ba_gn_optimize_sqrt(graph: FactorGraph, values: VariableArena,
                        iterations: int = 8, damping: float = 1e-6,
                        chunk: int = 2048, step_clip=None,
                        assembly_precision=None):
    """GN with square-root (QR) Schur elimination, fixed trip count:
    (values, chi2). Builds the observation tables once on the host."""
    lay = layout_of(values)
    dev = values.pose_t.device
    tabs = [torch.as_tensor(t, device=dev)
            for t in build_point_obs(graph, lay.point_cap)]
    for _ in range(iterations):
        values = sqrt_schur_gn_step(graph, values, *tabs, damping,
                                    chunk=chunk, step_clip=step_clip,
                                    assembly_precision=assembly_precision)
    return values, total_error(graph, values)
