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
  two forms to each other.

  K is not the problem's longest track but that of the landmark's width
  class (``landmark_classes``): landmarks are grouped by their count k of
  active projection rows into (0, 2], (2, 4], (4, 8], ... up to the
  longest track, each class stacked at its own widest member, and only
  each landmark's own 6k x 6k Gram entries reach the scatter (36 sum k^2
  a step). A padded slot's columns stay zero through the QR, so it adds
  nothing; scattered, its entries would all land on one pose's block of
  S, whose atomics then serialize. Tracks of one length make one class.

  The Gram products run in the arena's dtype;
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

from typing import NamedTuple

import numpy as np
import torch

from . import factors as F
from .assemble import dense_hg
from .factors import FactorGraph, total_error
from .solve import solve_dense
from .variables import VariableArena, layout_of, retract_all, used_slot_mask

__all__ = ["schur_gn_step", "ba_gn_optimize", "build_point_obs",
           "landmark_classes", "sqrt_schur_gn_step", "ba_gn_optimize_sqrt"]

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


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


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
    pj, pp = graph.projection, graph.prior_point
    obs_idx, obs_valid = _by_landmark(_host(pj.point_idx), _host(pj.active),
                                      point_cap, 1)
    prior_row, prior_valid = _by_landmark(_host(pp.idx), _host(pp.active),
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
        R = M[:, c:, :]
        x = R[:, :, c]
        nx = torch.linalg.vector_norm(x, dim=1)
        v = x.clone()
        v[:, 0] += torch.where(x[:, 0] >= 0, nx, -nx)     # x - alpha e1
        vn = torch.linalg.vector_norm(v, dim=1)
        v *= torch.where(vn > 1e-30, vn.reciprocal(), 0.0)[:, None]
        R.addcmul_(v[:, :, None], torch.bmm(v[:, None, :], R), value=-2.0)
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


def _width_classes(counts):
    """Each landmark's width class from its count of active projection
    rows alone: (0, 2], (2, 4], (4, 8], ... and the last class up to the
    longest track, each stacked at its own widest member (at least 1).
    A landmark with no rows (bucket padding, a dead slot) joins the
    narrowest class that has rows, so tracks of one length make one class.
    Returns (the class of each landmark (Pq,), the width of each class)."""
    counts = np.asarray(counts)
    K = max(int(counts.max()) if counts.size else 0, 1)
    bounds = [1 << e for e in range(1, K.bit_length()) if 1 << e < K] + [K]
    cls = np.searchsorted(bounds, counts)
    seen = counts > 0
    if seen.any():
        cls[~seen] = cls[seen].min()
    used, cls = np.unique(cls, return_inverse=True)
    widths = [max(int(counts[cls == c].max()), 1) for c in range(used.size)]
    return cls, widths


class LandmarkClass(NamedTuple):
    """One width class of the landmark tables and its static scatter
    tables. Landmark l of the class (table row ``rows[l]``, k active rows)
    owns entries ``ends[l]:ends[l + 1]`` of ``src`` and ``dst``: its 36 k^2
    Gram entries as flat indices into the class's (n, 6W, 6W) blocks and
    into S (Dp x Dp); likewise ``ends_g``, ``src_g`` and ``dst_g`` for its
    6k right-hand-side entries, into (n, 6W) and g."""
    width: int
    rows: torch.Tensor          # (n,) table rows, ascending
    obs_idx: torch.Tensor       # (n, W) projection rows, valid slots first
    obs_valid: torch.Tensor     # (n, W)
    cols: torch.Tensor          # (n, 6W) pose columns of each slot
    src: torch.Tensor
    dst: torch.Tensor
    ends: np.ndarray            # (n + 1,), on the host
    src_g: torch.Tensor
    dst_g: torch.Tensor
    ends_g: np.ndarray

    @property
    def gram_entries(self) -> int:
        """Gram elements the class scatters into S a step (36 sum k^2)."""
        return int(self.ends[-1])


def _spread(sizes, dev):
    """``sizes[l]`` consecutive entries for each landmark l: each entry's
    landmark and its offset in the landmark's run, and the host prefix
    sums of ``sizes`` (the total is known here, so nothing syncs)."""
    ends = np.concatenate([[0], np.cumsum(sizes)])
    lm = torch.repeat_interleave(
        torch.arange(len(sizes), device=dev),
        torch.as_tensor(sizes, device=dev), output_size=int(ends[-1]))
    off = torch.arange(int(ends[-1]), device=dev) \
        - torch.as_tensor(ends[:-1], device=dev)[lm]
    return lm, off, ends


def landmark_classes(graph: FactorGraph, lay, obs_idx, obs_valid):
    """``build_point_obs``'s observation tables (on the host or a device)
    grouped into width classes (``_width_classes``), each with the flat
    indices of its landmarks' own Gram and right-hand-side entries. One
    host read of ``obs_valid``; the index arithmetic runs on the graph's
    device. ``ba_gn_optimize_sqrt`` builds them once a solve and hands
    them to every step."""
    obs_idx, obs_valid = _host(obs_idx), _host(obs_valid)
    dev = graph.projection.pose_idx.device
    counts = obs_valid.sum(axis=1)
    cls, widths = _width_classes(counts)
    pose_cols = lay.pose_cols(graph.projection.pose_idx)
    out = []
    for c, W in enumerate(widths):
        rows = np.flatnonzero(cls == c)
        w = 6 * W
        idx = torch.as_tensor(obs_idx[rows, :W], device=dev)
        cols = pose_cols[idx].reshape(rows.size, w)
        side = 6 * counts[rows]
        lm, off, ends = _spread(side * side, dev)
        k6 = torch.as_tensor(side, device=dev)[lm]
        i, j = off // k6, off % k6
        src = (lm * w + i) * w + j
        dst = cols[lm, i] * lay.point_off + cols[lm, j]
        lm, i, ends_g = _spread(side, dev)
        out.append(LandmarkClass(
            W, torch.as_tensor(rows, device=dev), idx,
            torch.as_tensor(obs_valid[rows, :W], device=dev), cols,
            src, dst, ends, lm * w + i, cols[lm, i], ends_g))
    return tuple(out)


def _prior_top(graph, values, prior_row, prior_valid, live, damping):
    """Each landmark's merged prior-and-damping rows ``[L^T | L^-1 g]``
    (Pq, 3, 4), L the closed-form Cholesky of sum J_prior^T J_prior +
    lambda I (the identity for a dead landmark)."""
    dt, dev = live.dtype, live.device
    Pq = live.shape[0]
    if graph.prior_point.idx.shape[0] and prior_row.shape[1]:
        rp_all, Jp_all = F._prior_vec_lin(graph.prior_point, values.point)
        pv = prior_valid.to(dt)
        Jpr = Jp_all[prior_row] * pv[:, :, None, None]    # (Pq, P, 3, 3)
        rpr = rp_all[prior_row] * pv[:, :, None]
        Hp = torch.einsum("qpij,qpik->qjk", Jpr, Jpr)
        gp = torch.einsum("qpij,qpi->qj", Jpr, rpr)
    else:
        Hp = torch.zeros(Pq, 3, 3, dtype=dt, device=dev)
        gp = torch.zeros(Pq, 3, dtype=dt, device=dev)
    lam = damping * live + (1.0 - live)   # a dead landmark gets identity
    Hp = Hp + lam[:, None, None] * _eye(3, live)
    # closed-form 3x3 Cholesky H = L L^T and forward solve L c = g
    tiny = torch.tensor(1e-30, dtype=dt, device=dev)
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
    return torch.stack([torch.stack([l11, l21, l31, c1p], -1),
                        torch.stack([z, l22, l32, c2p], -1),
                        torch.stack([z, z, l33, c3p], -1)], dim=1)


def _landmark_qr_reduce(graph: FactorGraph, values: VariableArena, lay,
                        obs_idx, obs_valid, prior_row, prior_valid,
                        q_ids, damping, chunk: int,
                        assembly_precision=None, classes=None):
    """Per-landmark QR elimination and the reduced system's assembly, one
    width class at a time (``classes``: ``landmark_classes`` of the
    observation tables, derived here when not given).

    ``q_ids`` are the global landmark indices of these table rows
    (``arange(Pq)`` on one device; a shard's slice when landmarks are
    sharded). Returns the landmark part ``(S (Dp, Dp), g (Dp,))`` in
    float64 (no damping, priors or non-point terms: callers add those
    once) and, for each class, the back-substitution pieces ``(rows, R3,
    E, c1, cols, live)`` of its landmarks (``rows``: their table rows).
    The Gram blocks are formed and added ``chunk`` landmarks of a class at
    a time, which bounds the assembly's work arrays ((chunk, 6W, 6W)
    blocks).
    """
    if classes is None:
        classes = landmark_classes(graph, lay, obs_idx, obs_valid)
    Dp = lay.point_off
    dt, dev = values.pose_t.dtype, values.pose_t.device
    r_all, J_all = F._projection_lin(values, graph.projection)
    live = (q_ids < values.num_points).to(dt)
    top = _prior_top(graph, values, prior_row, prior_valid, live, damping)

    S = torch.zeros(Dp, Dp, dtype=torch.float64, device=dev)
    g = torch.zeros(Dp, dtype=torch.float64, device=dev)
    back = []
    for cl in classes:
        n, W = cl.obs_idx.shape
        w = 6 * W
        v = cl.obs_valid.to(dt)
        J_g = J_all[cl.obs_idx] * v[:, :, None, None]     # (n, W, 2, 9)
        r_g = r_all[cl.obs_idx] * v[:, :, None]           # (n, W, 2)
        Mp = torch.einsum("qkej,kl->qkelj", J_g[..., :6], _eye(W, v))
        t = top[cl.rows]
        M = torch.cat([
            torch.cat([J_g[..., 6:].reshape(n, 2 * W, 3),
                       Mp.reshape(n, 2 * W, w),           # block diagonal
                       r_g.reshape(n, 2 * W, 1)], dim=-1),
            torch.cat([t[:, :, :3],
                       torch.zeros(n, 3, w, dtype=dt, device=dev),
                       t[:, :, 3:]], dim=-1)], dim=1)
        Rq = _eliminate3(M)
        red_pose = Rq[:, 3:, 3:3 + w]                     # (n, nred, 6W)
        red_rhs = Rq[:, 3:, -1]                           # (n, nred)
        C = max(1, min(chunk, n))
        for s0 in range(0, n, C):
            s1 = min(s0 + C, n)
            G, gl = _gram(red_pose[s0:s1], red_rhs[s0:s1],
                          assembly_precision)
            a, b = int(cl.ends[s0]), int(cl.ends[s1])
            S.view(-1).index_add_(0, cl.dst[a:b], G.reshape(-1)[
                cl.src[a:b] - s0 * w * w].to(S.dtype))
            a, b = int(cl.ends_g[s0]), int(cl.ends_g[s1])
            g.index_add_(0, cl.dst_g[a:b], gl.reshape(-1)[
                cl.src_g[a:b] - s0 * w].to(g.dtype))
        back.append((cl.rows, Rq[:, :3, :3], Rq[:, :3, 3:3 + w],
                     Rq[:, :3, -1], cl.cols, live[cl.rows]))
    return (S, g), tuple(back)


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


def _point_updates(back, dp, n: int):
    """(n, 3) landmark updates in table-row order, class by class."""
    dq = torch.zeros(n, 3, dtype=dp.dtype, device=dp.device)
    for rows, *piece in back:
        dq.index_copy_(0, rows, _backsub_points(*piece, dp))
    return dq


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
                       assembly_precision=None, classes=None):
    """One damped GN step by per-landmark QR elimination (float32-stable).

    The tables are ``build_point_obs``'s, as tensors on the arena's device.
    ``classes`` is their precomputed form, ``landmark_classes`` of the
    observation tables, which a loop of steps builds once; without it the
    step derives it (one host read of ``obs_valid``).
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
        assembly_precision=assembly_precision, classes=classes)
    S, g = _add_nonpoint_and_base(graph, values, lay, S, g, damping)
    if assembly_precision is not None:
        S.diagonal().mul_(1.0 + _JITTER)
    dp = solve_dense(S, g, 0.0).to(values.pose_t.dtype)
    dq = _point_updates(back, dp, Pq).reshape(-1)
    if step_clip is not None:
        dp = _clip_nonpoint(dp, lay, step_clip)
        dq = _clip_rows(dq, 3, step_clip)
    return retract_all(values, torch.cat([dp, dq]))


def ba_gn_optimize_sqrt(graph: FactorGraph, values: VariableArena,
                        iterations: int = 8, damping: float = 1e-6,
                        chunk: int = 2048, step_clip=None,
                        assembly_precision=None):
    """GN with square-root (QR) Schur elimination, fixed trip count:
    (values, chi2). Builds the observation tables and their width classes
    once."""
    lay = layout_of(values)
    dev = values.pose_t.device
    obs = build_point_obs(graph, lay.point_cap)
    classes = landmark_classes(graph, lay, obs[0], obs[1])
    tabs = [torch.as_tensor(t, device=dev) for t in obs]
    for _ in range(iterations):
        values = sqrt_schur_gn_step(graph, values, *tabs, damping,
                                    chunk=chunk, step_clip=step_clip,
                                    assembly_precision=assembly_precision,
                                    classes=classes)
    return values, total_error(graph, values)
