"""IMU preintegration: Forster-style ΔR/Δv/Δp with bias Jacobians and a
15x15 combined covariance (port of ``imu/preintegration.py``).

    ΔR_{k+1} = ΔR_k Exp((ω_k - bg) dt)
    Δv_{k+1} = Δv_k + ΔR_k (a_k - ba) dt
    Δp_{k+1} = Δp_k + Δv_k dt + 0.5 ΔR_k (a_k - ba) dt²

with first-order bias Jacobians and EKF covariance propagation over the
15-dim error state ordered ``[δθ, δp, δv, δba, δbg]``. Rows with
``dt <= 0`` are identity updates, so fixed-size padded windows integrate
variable-length segments.

``integrate_segment`` here is the sequential step-by-step form, the parity
oracle (exported as ``integrate_segment_scan``); the package's
``integrate_segment`` is the log-depth form in ``parallel_preint``.
``corrected_deltas`` and ``predict_navstate`` broadcast over leading batch
axes of the state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3, so3
from ..device import resolve

__all__ = [
    "ImuParams",
    "PreintState",
    "init_preint",
    "integrate_segment",
    "predict_navstate",
    "corrected_deltas",
]

Tensor = torch.Tensor


class ImuParams(NamedTuple):
    """Continuous-time noise model (GTSAM Params equivalent)."""

    accel_cov: Tensor        # (3,3) accelerometer white noise PSD
    gyro_cov: Tensor         # (3,3) gyroscope white noise PSD
    integration_cov: Tensor  # (3,3) position integration error
    bias_acc_cov: Tensor     # (3,3) accel bias random walk PSD
    bias_omega_cov: Tensor   # (3,3) gyro bias random walk PSD
    bias_acc_omega_init: Tensor  # (6,6) initial bias uncertainty
    gravity: Tensor          # (3,) world gravity, e.g. (0,0,-9.81)


class PreintState(NamedTuple):
    """Preintegrated deltas + bias Jacobians + covariance + elapsed time."""

    dR: Tensor       # (..., 3, 3)
    dp: Tensor       # (..., 3)
    dv: Tensor       # (..., 3)
    H_R_bg: Tensor   # (..., 3, 3) dLog(ΔR)/dbg
    H_p_ba: Tensor   # (..., 3, 3)
    H_p_bg: Tensor   # (..., 3, 3)
    H_v_ba: Tensor   # (..., 3, 3)
    H_v_bg: Tensor   # (..., 3, 3)
    cov: Tensor      # (..., 15, 15) over [δθ, δp, δv, δba, δbg]
    dt: Tensor       # (...) total integrated time
    bias_hat: Tensor  # (..., 6) (ba, bg) used for integration


def init_preint(bias_hat, params: ImuParams, *, dtype=torch.float64,
                device=None) -> PreintState:
    """Fresh preintegration (resetIntegrationAndSetBias equivalent) on
    ``device`` (``None``: the CUDA card). Leading axes of ``bias_hat``
    give a batch of states.

    The bias block of the covariance starts at ``bias_acc_omega_init``.
    """
    device = resolve(device)
    b = torch.as_tensor(bias_hat, dtype=dtype, device=device)
    batch = b.shape[:-1]

    def eye3():
        return torch.eye(3, dtype=dtype, device=device).expand(
            *batch, 3, 3).clone()

    def z(*shape):
        return torch.zeros((*batch, *shape), dtype=dtype, device=device)

    cov = z(15, 15)
    cov[..., 9:15, 9:15] = params.bias_acc_omega_init.to(dtype)
    return PreintState(dR=eye3(), dp=z(3), dv=z(3), H_R_bg=z(3, 3),
                       H_p_ba=z(3, 3), H_p_bg=z(3, 3), H_v_ba=z(3, 3),
                       H_v_bg=z(3, 3), cov=cov, dt=z(), bias_hat=b)


def _right_jacobian(w):
    """SO(3) right Jacobian J_r(w) = J_l(-w)."""
    return so3.left_jacobian(-w)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _T(A):
    return A.transpose(-1, -2)


def transition(At, Jr, aW, R, dt, dt2):
    """Per-step error-state transition F (..., 15, 15); ``dt``/``dt2``
    broadcast against the (..., 3, 3) blocks."""
    I3 = torch.eye(3, dtype=At.dtype, device=At.device)
    F = torch.eye(15, dtype=At.dtype, device=At.device).expand(
        *At.shape[:-2], 15, 15).clone()
    F[..., 0:3, 0:3] = At
    F[..., 0:3, 12:15] = -Jr * dt
    F[..., 3:6, 0:3] = -0.5 * aW * dt2
    F[..., 3:6, 6:9] = I3 * dt
    F[..., 3:6, 9:12] = -0.5 * R * dt2
    F[..., 6:9, 0:3] = -aW * dt
    F[..., 6:9, 9:12] = -R * dt
    return F


def step_noise(Jr, R, dt, dt2, params: ImuParams):
    """Per-step discrete noise Q (..., 15, 15) (continuous PSD / dt, mapped
    by B); ``dt``/``dt2`` broadcast against the (..., 3, 3) blocks."""
    dtype = R.dtype
    dt_safe = torch.where(dt > 0, dt, torch.ones_like(dt))  # masked rows
    sg = params.gyro_cov.to(dtype) / dt_safe
    sa = params.accel_cov.to(dtype) / dt_safe
    RsaRt = R @ sa @ _T(R)
    Q = torch.zeros(*R.shape[:-2], 15, 15, dtype=dtype, device=R.device)
    Q[..., 0:3, 0:3] = Jr @ sg @ _T(Jr) * dt2
    Q[..., 3:6, 3:6] = (0.25 * RsaRt * dt2 * dt2
                        + params.integration_cov.to(dtype) * dt)
    Q[..., 6:9, 6:9] = RsaRt * dt2
    q_pv = 0.5 * RsaRt * dt2 * dt
    Q[..., 3:6, 6:9] = q_pv
    Q[..., 6:9, 3:6] = _T(q_pv)
    Q[..., 9:12, 9:12] = params.bias_acc_cov.to(dtype) * dt
    Q[..., 12:15, 12:15] = params.bias_omega_cov.to(dtype) * dt
    return Q


def _step(state: PreintState, acc, gyr, dt, params: ImuParams):
    ba = state.bias_hat[..., :3]
    bg = state.bias_hat[..., 3:]
    a = acc - ba
    w = (gyr - bg) * dt[..., None]

    A = so3.expmap(w)          # incremental rotation
    Jr = _right_jacobian(w)
    dR, dp, dv = state.dR, state.dp, state.dv
    aW = dR @ so3.hat(a)       # ΔR hat(a)
    dt2 = dt * dt
    s, s2 = dt[..., None, None], dt2[..., None, None]

    new_dR = dR @ A
    new_dv = dv + _mv(dR, a) * dt[..., None]
    new_dp = dp + dv * dt[..., None] + 0.5 * _mv(dR, a) * dt2[..., None]

    # bias Jacobians (first order)
    At = _T(A)
    new_H_R_bg = At @ state.H_R_bg - Jr * s
    new_H_v_ba = state.H_v_ba - dR * s
    new_H_v_bg = state.H_v_bg - aW @ state.H_R_bg * s
    new_H_p_ba = state.H_p_ba + state.H_v_ba * s - 0.5 * dR * s2
    new_H_p_bg = (state.H_p_bg + state.H_v_bg * s
                  - 0.5 * aW @ state.H_R_bg * s2)

    F = transition(At, Jr, aW, dR, s, s2)
    Q = step_noise(Jr, dR, s, s2, params)
    new_cov = F @ state.cov @ _T(F) + Q

    live = dt > 0

    def sel(n, o):
        return torch.where(live.reshape(live.shape + (1,) * (n.dim()
                                                            - live.dim())),
                           n, o)

    return PreintState(
        dR=sel(new_dR, dR), dp=sel(new_dp, dp), dv=sel(new_dv, dv),
        H_R_bg=sel(new_H_R_bg, state.H_R_bg),
        H_p_ba=sel(new_H_p_ba, state.H_p_ba),
        H_p_bg=sel(new_H_p_bg, state.H_p_bg),
        H_v_ba=sel(new_H_v_ba, state.H_v_ba),
        H_v_bg=sel(new_H_v_bg, state.H_v_bg),
        cov=sel(new_cov, state.cov),
        dt=state.dt + torch.clamp(dt, min=0.0),
        bias_hat=state.bias_hat,
    )


def _as(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def integrate_segment(state: PreintState, acc, gyr, dt,
                      params: ImuParams) -> PreintState:
    """Integrate a (possibly padded) window one measurement at a time.

    ``acc``/``gyr``: (..., N, 3); ``dt``: (..., N) with non-positive
    entries skipped. The parity oracle of ``parallel_preint``.
    """
    acc, gyr, dt = (_as(x, state.dR) for x in (acc, gyr, dt))
    for k in range(acc.shape[-2]):
        state = _step(state, acc[..., k, :], gyr[..., k, :], dt[..., k],
                      params)
    return state


def corrected_deltas(state: PreintState, bias_i):
    """Bias-corrected deltas for the factor / prediction.

    First-order update around ``bias_hat``:
      ΔR̃ = ΔR Exp(H_R_bg δbg),  Δṽ = Δv + H_v δb,  Δp̃ = Δp + H_p δb.
    """
    db = bias_i - state.bias_hat
    dba, dbg = db[..., :3], db[..., 3:]
    dR = state.dR @ so3.expmap(_mv(state.H_R_bg, dbg))
    dv = state.dv + _mv(state.H_v_ba, dba) + _mv(state.H_v_bg, dbg)
    dp = state.dp + _mv(state.H_p_ba, dba) + _mv(state.H_p_bg, dbg)
    return dR, dp, dv


def predict_navstate(state: PreintState, pose_i: se3.Pose, vel_i, bias_i,
                     gravity):
    """GTSAM ``PreintegrationBase::predict``: (X_i, v_i, b_i) -> (X_j, v_j)."""
    dR, dp, dv = corrected_deltas(state, bias_i)
    g = gravity.to(state.dR.dtype)
    t = state.dt[..., None]
    R_j = pose_i.R @ dR
    v_j = vel_i + g * t + _mv(pose_i.R, dv)
    p_j = pose_i.t + vel_i * t + 0.5 * g * t * t + _mv(pose_i.R, dp)
    return se3.Pose(R_j, p_j), v_j
