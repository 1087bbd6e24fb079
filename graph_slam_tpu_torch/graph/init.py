"""Chordal initialization for SE(3) pose graphs (port of ``graph/init.py``).

A batch solve started from composed odometry can sit far from the basin on
long loopy graphs. GTSAM ships ``InitializePose3`` (chordal relaxation) for
this; the reference SLAM code never calls it. Both stages here are one
dense linear solve over the graph Laplacian:

1. **Rotation stage** (chordal relaxation, Martinec & Pajdla CVPR'07 /
   Carlone et al. ICRA'15): relax ``R_j = R_i R_ij`` to a linear system in
   the rotation *rows*. With ``y_p^c`` the c-th row of ``R_p``, each edge
   gives ``y_j^c = R_ij^T y_i^c``: the three rows decouple and share one
   (3P, 3P) normal matrix with three right-hand sides. The solution is
   projected back to SO(3) per pose by SVD.
2. **Translation stage**: with the rotations fixed, ``t_j - t_i = R_i
   t_ij`` is linear in all translations: the same sparsity, one
   right-hand side.

Anchoring comes from the graph's own prior-pose rows. Unused arena slots
keep their original values.

The reference scatters into a flat (3P, 3P) matrix to dodge TPU tile
padding of trailing (3, 3) dims; here every 3x3 block of a stage goes in
with one ``index_put_(accumulate=True)``, and the solve is
``cholesky_ex`` + ``cholesky_solve``, which reads no status back to the
host.
"""

from __future__ import annotations

import torch

from .variables import VariableArena

__all__ = ["chordal_initialize", "project_so3"]


def project_so3(A):
    """Nearest rotation(s) to ``A`` (..., 3, 3) in Frobenius norm, via SVD."""
    U, _, Vt = torch.linalg.svd(A)
    det = torch.linalg.det(U @ Vt)
    D = torch.cat([torch.ones(*A.shape[:-2], 2, dtype=A.dtype,
                              device=A.device), det[..., None]], dim=-1)
    return (U * D[..., None, :]) @ Vt


def _block_matrix(P, bi, bj, blocks):
    """(3P, 3P) matrix holding the (F, 3, 3) ``blocks`` at block coordinates
    (bi, bj); duplicates accumulate."""
    r3 = torch.arange(3, device=bi.device)
    rows = (3 * bi[:, None, None] + r3[None, :, None]).expand(-1, 3, 3)
    cols = (3 * bj[:, None, None] + r3[None, None, :]).expand(-1, 3, 3)
    M = torch.zeros(3 * P, 3 * P, dtype=blocks.dtype, device=blocks.device)
    M.index_put_((rows.reshape(-1), cols.reshape(-1)), blocks.reshape(-1),
                 accumulate=True)
    return M


def _solve_spd(M, rhs):
    """Cholesky solve; rhs (3P, k) -> (P, 3, k)."""
    L, _ = torch.linalg.cholesky_ex(M)
    return torch.cholesky_solve(rhs, L).reshape(M.shape[0] // 3, 3,
                                                rhs.shape[-1])


def chordal_initialize(graph, values: VariableArena,
                       anchor_weight: float = 1e4) -> VariableArena:
    """Replace the arena's poses with a chordal-relaxation initialization.

    Uses the graph's active ``between`` rows as relative-rotation /
    relative-translation constraints and its active ``prior_pose`` rows as
    anchors. Everything else in the arena (velocities, biases, landmarks,
    unused pose slots) is untouched.
    """
    bt = graph.between
    pp = graph.prior_pose
    dt = values.pose_t.dtype
    dev = values.pose_t.device
    P = values.pose_R.shape[0]

    w_e = bt.active.to(dt)                              # (F,)
    i, j = bt.i, bt.j
    Q = bt.meas_R.transpose(1, 2).to(dt)                # R_ij^T per edge
    I3 = torch.eye(3, dtype=dt, device=dev)
    eyeF = w_e[:, None, None] * I3
    w_a = pp.active.to(dt) * anchor_weight
    a = pp.idx
    eyeA = w_a[:, None, None] * I3

    # slots with no constraint at all: pin to identity so Cholesky holds
    diag_mass = torch.zeros(P, dtype=dt, device=dev)
    diag_mass.index_add_(0, i, w_e).index_add_(0, j, w_e).index_add_(0, a, w_a)
    loose = (diag_mass == 0).to(dt)
    diag_fix = torch.repeat_interleave(loose, 3) + 1e-8
    bi = torch.cat([i, j, i, j, a])
    bj = torch.cat([i, j, j, i, a])

    # --- rotation stage -------------------------------------------------
    M = _block_matrix(P, bi, bj, torch.cat([
        eyeF, eyeF, -w_e[:, None, None] * Q.transpose(1, 2),
        -w_e[:, None, None] * Q, eyeA]))
    M.diagonal().add_(diag_fix)
    rhs = torch.zeros(P, 3, 3, dtype=dt, device=dev)
    rhs.index_add_(0, a, w_a[:, None, None] * pp.mean_R.transpose(1, 2).to(dt))
    Yb = _solve_spd(M, rhs.reshape(3 * P, 3))           # (P, 3, 3) = R^T
    R_est = project_so3(Yb.transpose(1, 2))

    # --- translation stage ----------------------------------------------
    L = _block_matrix(P, bi, bj, torch.cat([eyeF, eyeF, -eyeF, -eyeF, eyeA]))
    L.diagonal().add_(diag_fix)
    b_e = w_e[:, None] * torch.einsum("fab,fb->fa", R_est[i],
                                      bt.meas_t.to(dt))
    g = torch.zeros(P, 3, dtype=dt, device=dev)
    g.index_add_(0, j, b_e).index_add_(0, i, -b_e)
    g.index_add_(0, a, w_a[:, None] * pp.mean_t.to(dt))
    t_est = _solve_spd(L, g.reshape(3 * P, 1))[:, :, 0]

    # keep original values on slots the system knows nothing about
    keep = loose.bool()
    pose_R = torch.where(keep[:, None, None], values.pose_R, R_est)
    pose_t = torch.where(keep[:, None], values.pose_t, t_est)
    return values._replace(pose_R=pose_R, pose_t=pose_t)
