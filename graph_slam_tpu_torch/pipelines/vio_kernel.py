"""The per-record VIO step + host window helpers (port of
``pipelines/vio_kernel.py``).

A new frame's record is its window's preintegration (``_preintegrate``),
the NavState prediction, the optional chi2 rotation gate, the VO/IMU pose
selection and the value writes (``_vio_frame_kernel``), plus its between
and IMU rows (``online.between_row``/``imu_row``). The scan engine
preintegrates and writes the rows of every record up to the next
optimization at once, and runs only ``_vio_frame_kernel`` record by
record; the online engine's fast path runs the three for one record
(``_fused_vio_step``). The record's structure (is it a new frame, did its
VO edge fail, which slots) is known on the host from the log, so those
branches are Python; only the gate's verdict is data, and it stays a
tensor on the device (``torch.where``), so a record costs no host sync.
Both engines take their edges from ``_host_edges``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import se3, so3
from ..graph.online import between_row, imu_row
from ..imu import (ImuParams, ImuStream, find_index_at, init_preint,
                   integrate_segment, predict_navstate)
from ..io.vro_log import FAILED_INFO_SENTINEL

__all__ = ["_vio_frame_kernel", "_fused_vio_step", "_preintegrate",
           "_static_init", "_pad_window", "_host_edges",
           "_conjugate_edges_batch", "_expmap_batch"]


def _preintegrate(bias, imu_params: ImuParams, acc, gyr, dts):
    """Windows ``(..., W)`` integrated from the bias estimate ``bias``
    (``(..., 6)``; a batch of windows shares one leading shape)."""
    return integrate_segment(init_preint(bias, imu_params, dtype=bias.dtype,
                                         device=bias.device),
                             acc, gyr, dts, imu_params)


def _select(cond, a, b):
    """``a`` where ``cond`` else ``b``: a host branch for a Python bool, a
    device select for a tensor (the gate's verdict)."""
    if isinstance(cond, bool):
        return a if cond else b
    return torch.where(cond, a, b)


def _vio_frame_kernel(values, st, prev, meas_R, meas_t, failed, gi_vo, gj,
                      gravity, gate: bool, gate_thresh):
    """One new frame's estimate from its preintegrated window ``st`` and
    the feedback state ``prev = (R, t, vel, bias)``; writes frame ``gj``'s
    pose, velocity and bias in place.

    The VO initial estimate composes from the matched node ``gi_vo``'s
    pose; a failed edge takes the IMU prediction instead. ``failed`` is a
    host bool, or, with ``gate``, becomes a device bool: the edge also
    fails when its rotation disagrees with the IMU's beyond
    ``gate_thresh`` (chi2 under the preintegrated rotation covariance).

    Returns ``(est_R, est_t, pred_vel, failed)``; the new feedback state is
    ``(est_R, est_t, pred_vel, prev bias)``.
    """
    prev_R, prev_t, prev_vel, prev_bias = prev
    pred_pose, pred_vel = predict_navstate(st, se3.Pose(prev_R, prev_t),
                                           prev_vel, prev_bias, gravity)
    if gate:
        R_imu = prev_R.transpose(-1, -2) @ pred_pose.R
        e_R = so3.logmap(meas_R.transpose(-1, -2) @ R_imu)
        S_R = st.cov[:3, :3] + torch.eye(3, dtype=prev_t.dtype,
                                         device=prev_t.device) * 1e-12
        chi2 = e_R @ torch.linalg.solve_ex(S_R, e_R)[0]
        failed = (chi2 > gate_thresh) | failed

    if failed is True:
        est_R, est_t = pred_pose.R, pred_pose.t
    else:
        comp = se3.compose(se3.Pose(values.pose_R[gi_vo],
                                    values.pose_t[gi_vo]),
                           se3.Pose(meas_R, meas_t))
        est_R = _select(failed, pred_pose.R, comp.R)
        est_t = _select(failed, pred_pose.t, comp.t)

    values.pose_R[gj] = est_R
    values.pose_t[gj] = est_t
    values.vel[gj] = pred_vel
    values.bias[gj] = prev_bias
    for n in (values.num_poses, values.num_vels, values.num_biases):
        n.clamp_(min=gj + 1)
    return est_R, est_t, pred_vel, failed


def _fused_vio_step(og, imu_params: ImuParams, acc, gyr, dts, prev,
                    meas_R, meas_t, sqrt_info, robust_kind, robust_k, failed,
                    gi, gj, bt_slot, imu_slot, gravity, gate: bool,
                    gate_thresh):
    """One new frame of the online engine's fast path (no plane stack):
    the window ``(acc, gyr, dts)`` preintegrated from the feedback bias,
    ``_vio_frame_kernel`` for frame ``gj`` matched to ``gi``, then its
    between row in slot ``bt_slot`` and its IMU row ``gj - 1 -> gj`` in
    ``imu_slot``, all in ``og`` in place.

    The between row is written with ``active = ~failed``: a sentinel or
    gated edge spends its slot and adds no residual, and with ``gate`` the
    verdict stays on the device, so nothing is read back. Returns
    ``(est_R, est_t, pred_vel)``.
    """
    st = _preintegrate(prev[3], imu_params, acc, gyr, dts)
    est_R, est_t, pred_vel, failed = _vio_frame_kernel(
        og.values, st, prev, meas_R, meas_t, failed, gi, gj, gravity, gate,
        gate_thresh)
    between_row(og.graph.between, bt_slot, gi, gj, meas_R, meas_t,
                sqrt_info, robust_kind, robust_k, active=~failed
                if isinstance(failed, torch.Tensor) else not failed)
    imu_row(og.graph.imu, imu_slot, gj - 1, gj, st.dR, st.dp, st.dv,
            st.H_R_bg, st.H_p_ba, st.H_p_bg, st.H_v_ba, st.H_v_bg,
            st.bias_hat, st.dt, gravity, st.cov)
    return est_R, est_t, pred_vel


def _static_init(imu: ImuStream, t0: float, imu_params: ImuParams,
                 n_samples: int = 0):
    """Startup gravity/bias initialization from the static window
    (``initFromImu`` + static bias estimation).

    The static window is everything before the first image's sync point
    (``n_samples=0``); a log that starts at the sync point falls back to
    the first 200 samples (1 s at VN100 rate). Returns ``(R0, bias0)`` in
    numpy: the gravity-aligned first-node rotation and the (ba, bg) prior
    bias.
    """
    from ..imu.streams import gravity_aligning_rotation, static_bias_estimate

    n = n_samples
    if n <= 0:
        idx = find_index_at(imu.t, t0)
        n = idx if idx > 0 else min(len(imu.t), 200)
    g_mag = float(np.linalg.norm(imu_params.gravity.detach().cpu().numpy()))
    bias0, g_dir = static_bias_estimate(imu, n, gravity_mag=g_mag)
    return gravity_aligning_rotation(g_dir), bias0


def _pad_window(acc, gyr, n, dt_nom, max_window):
    """Fixed-shape measurement window (masked rows have dt=0).

    An EMPTY window (non-advancing image timestamp) gets one zero-motion
    step: an all-zero ``dt`` vector makes the preintegration covariance
    singular and the IMU row's whitening Cholesky NaN.
    """
    acc_p = np.zeros((max_window, 3))
    gyr_p = np.zeros((max_window, 3))
    dt_p = np.zeros(max_window)
    k = min(n, max_window)
    acc_p[:k] = acc[:k]
    gyr_p[:k] = gyr[:k]
    dt_p[:k] = dt_nom
    if k == 0:
        dt_p[0] = dt_nom
    return acc_p, gyr_p, dt_p


def _host_edges(log, u2c):
    """Every VRO edge camera -> body at once on the host, in float64:
    ``(R, t, sqrt_info, valid)`` by record. The sqrt-information of the
    valid rows comes from one batched Cholesky of the conjugated
    information; a sentinel row (a failed edge) gets the identity fakeOdo
    and an identity sqrt-information."""
    valid = np.asarray(log.info[:, 0, 0] != FAILED_INFO_SENTINEL)
    xi = torch.as_tensor(np.asarray(log.xi, np.float64))
    if u2c is not None:
        uR = u2c.R.detach().cpu().double()
        ut = u2c.t.detach().cpu().double()
        R, t = _conjugate_edges_batch(xi, uR, ut)
        Ad = se3.adjoint(se3.Pose(uR, ut)).numpy()
        info = np.einsum("ab,kbc,dc->kad", Ad,
                         np.asarray(log.info, np.float64), Ad)
    else:
        R, t = _expmap_batch(xi)
        info = np.asarray(log.info, np.float64)
    R = R.numpy().copy()
    t = t.numpy().copy()
    S = np.tile(np.eye(6), (len(log), 1, 1))
    if valid.any():
        S[valid] = np.transpose(np.linalg.cholesky(info[valid]), (0, 2, 1))
    R[~valid] = np.eye(3)
    t[~valid] = 0.0
    return R, t, S, valid


def _conjugate_edges_batch(xi, uR, ut):
    """All VRO edges camera->body at once: ``U Exp(xi) U^-1`` per row."""
    T = se3.expmap(xi)
    u = se3.Pose(uR, ut)
    P = se3.compose(se3.compose(u, T), se3.inverse(u))
    return P.R, P.t


def _expmap_batch(xi):
    T = se3.expmap(xi)
    return T.R, T.t
