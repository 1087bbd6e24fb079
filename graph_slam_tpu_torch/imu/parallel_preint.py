"""Log-depth IMU preintegration (port of ``imu/parallel_preint.py``).

Every recurrence of the sequential step is affine in the state, with
coefficients that depend only on the measurements and the rotation
prefix, so the window parallelizes:

1. rotation prefixes ``P_k = A_0 ... A_k``: an inclusive product scan over
   (N, 3, 3), written by hand at log depth (torch has no associative
   scan): ⌈log2 N⌉ rounds of one batched matmul each, every round
   left-multiplying by the earlier partial products;
2. ``dv``/``dp`` and the five bias Jacobians: closed-form prefix sums
   given the rotation prefixes (batched matmuls + ``cumsum``);
3. the 15x15 covariance: only the window's total (Φ, Q) is needed, so a
   pairwise tree reduction under ``(F2, Q2) ∘ (F1, Q1) =
   (F2 F1, F2 Q1 F2ᵀ + Q2)`` (later ∘ earlier), with the same per-step
   F/Q as the sequential path.

Rows with ``dt <= 0`` contribute ``A = I``, ``F = I``, ``Q = 0`` exactly,
so padded windows integrate unchanged. Same math as the sequential oracle;
only the evaluation order differs, so results agree to roundoff. Leading
axes of the state and the measurements are a batch.
"""

from __future__ import annotations

import torch

from ..core import so3
from .preintegration import (ImuParams, PreintState, _as, _right_jacobian,
                             _T, step_noise, transition)

__all__ = ["integrate_segment_parallel"]


def _excl(x, dim):
    """Exclusive prefix sum along ``dim``."""
    return torch.cumsum(x, dim=dim) - x


def prefix_products(A):
    """Inclusive products ``P_k = A_0 @ ... @ A_k`` along axis -3, in
    ⌈log2 N⌉ rounds (Hillis-Steele): round d sets ``P_k = P_{k-d} @ P_k``
    for k >= d."""
    P = A
    n = A.shape[-3]
    d = 1
    while d < n:
        P = torch.cat([P[..., :d, :, :], P[..., :-d, :, :] @ P[..., d:, :, :]],
                      dim=-3)
        d *= 2
    return P


def compose_transitions(F, Q):
    """Total ``(Φ, Q)`` of a window of per-step pairs along axis -3, by a
    pairwise tree; an odd count is padded at the end with ``(I, 0)``, which
    composes exactly."""
    while F.shape[-3] > 1:
        if F.shape[-3] % 2:
            eye = torch.eye(F.shape[-1], dtype=F.dtype, device=F.device)
            F = torch.cat([F, eye.expand(*F.shape[:-3], 1, *eye.shape)], -3)
            Q = torch.cat([Q, torch.zeros_like(Q[..., :1, :, :])], -3)
        F1, F2 = F[..., 0::2, :, :], F[..., 1::2, :, :]   # earlier, later
        Q1, Q2 = Q[..., 0::2, :, :], Q[..., 1::2, :, :]
        F = F2 @ F1
        Q = F2 @ Q1 @ _T(F2) + Q2
    return F[..., 0, :, :], Q[..., 0, :, :]


def integrate_segment_parallel(state: PreintState, acc, gyr, dt,
                               params: ImuParams) -> PreintState:
    """Drop-in replacement for the sequential ``integrate_segment`` (same
    signature, same result to roundoff), evaluated at log depth."""
    acc, gyr, dt = (_as(x, state.dR) for x in (acc, gyr, dt))
    dt = torch.clamp(dt, min=0.0)                         # (..., N)
    s = dt[..., None, None]
    dt2 = dt * dt
    s2 = dt2[..., None, None]

    ba = state.bias_hat[..., None, :3]
    bg = state.bias_hat[..., None, 3:]
    a = acc - ba                                          # (..., N, 3)
    w = (gyr - bg) * dt[..., None]                        # 0 on masked rows
    A = so3.expmap(w)                                     # (..., N, 3, 3)
    Jr = _right_jacobian(w)

    # -- 1. rotation prefixes; exclusive G_k = P_{k-1}, G_0 = I -----------
    P = prefix_products(A)
    G = torch.cat([torch.eye(3, dtype=A.dtype, device=A.device).expand(
        *A.shape[:-3], 1, 3, 3), P[..., :-1, :, :]], dim=-3)
    G_N = P[..., -1, :, :]
    R = state.dR[..., None, :, :] @ G                     # dR_k

    # -- 2. deltas + bias Jacobians as prefix sums ---------------------------
    Ra = (R @ a[..., None])[..., 0]                       # dR_k a_k
    u = Ra * dt[..., None]                                # dv increments
    dv_pre = state.dv[..., None, :] + _excl(u, -2)
    dv_N = state.dv + u.sum(-2)
    dp_N = (state.dp + (dv_pre * dt[..., None]).sum(-2)
            + 0.5 * (Ra * dt2[..., None]).sum(-2))

    # H_R_bg,k = G_k^T (H0 - T_k),  T_k = sum_{j<k} G_{j+1} Jr_j dt_j
    GJr = (P @ Jr) * s
    H_R_pre = _T(G) @ (state.H_R_bg[..., None, :, :] - _excl(GJr, -3))
    H_R_bg_N = _T(G_N) @ (state.H_R_bg - GJr.sum(-3))

    # H_v_ba,k = H0 - sum_{j<k} dR_j dt_j
    Rdt = R * s
    H_v_ba_pre = state.H_v_ba[..., None, :, :] - _excl(Rdt, -3)
    H_v_ba_N = state.H_v_ba - Rdt.sum(-3)

    # H_v_bg,k = H0 - sum_{j<k} aW_j H_R_bg,j dt_j,  aW_j = dR_j hat(a_j)
    aW = R @ so3.hat(a)
    M = (aW @ H_R_pre) * s
    H_v_bg_pre = state.H_v_bg[..., None, :, :] - _excl(M, -3)
    H_v_bg_N = state.H_v_bg - M.sum(-3)

    # H_p_*: one more integration layer over the H_v_* prefixes
    H_p_ba_N = (state.H_p_ba + (H_v_ba_pre * s).sum(-3)
                - 0.5 * (R * s2).sum(-3))
    H_p_bg_N = (state.H_p_bg + (H_v_bg_pre * s).sum(-3)
                - 0.5 * (M * s).sum(-3))

    # -- 3. covariance: tree reduction over the per-step (F, Q) pairs --------
    F = transition(_T(A), Jr, aW, R, s, s2)
    Q = step_noise(Jr, R, s, s2, params)
    Phi, Qtot = compose_transitions(F, Q)
    cov_N = Phi @ state.cov @ _T(Phi) + Qtot

    return PreintState(
        dR=state.dR @ G_N, dp=dp_N, dv=dv_N,
        H_R_bg=H_R_bg_N, H_p_ba=H_p_ba_N, H_p_bg=H_p_bg_N,
        H_v_ba=H_v_ba_N, H_v_bg=H_v_bg_N,
        cov=cov_N, dt=state.dt + dt.sum(-1),
        bias_hat=state.bias_hat,
    )
