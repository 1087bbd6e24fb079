"""The per-record VIO step + host window helpers (port of
``pipelines/vio_kernel.py``).

A new frame's record is its window's preintegration (``_preintegrate``),
the NavState prediction, the optional chi2 rotation gate, the VO/IMU pose
selection and the value writes (``_vio_frame_kernel``), plus its between
and IMU rows (``online.between_row``/``imu_row``). The scan engine
preintegrates and writes the rows of every record up to the next
optimization at once, and runs only ``_vio_frame_kernel`` record by
record. The reference's one-record ``_fused_vio_step`` is not ported:
only the online engine (ROADMAP queue 1) calls it. The record's structure
(is it a new frame, did its VO edge fail, which slots) is known on the
host from the log, so those branches are Python; only the gate's verdict
is data, and it stays a tensor on the device (``torch.where``), so a
record costs no host sync.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import se3, so3
from ..imu import (ImuParams, ImuStream, find_index_at, init_preint,
                   integrate_segment, predict_navstate)

__all__ = ["_vio_frame_kernel", "_preintegrate", "_static_init",
           "_pad_window", "_conjugate_edges_batch", "_expmap_batch"]


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


def _conjugate_edges_batch(xi, uR, ut):
    """All VRO edges camera->body at once: ``U Exp(xi) U^-1`` per row."""
    T = se3.expmap(xi)
    u = se3.Pose(uR, ut)
    P = se3.compose(se3.compose(u, T), se3.inverse(u))
    return P.R, P.t


def _expmap_batch(xi):
    T = se3.expmap(xi)
    return T.R, T.t
