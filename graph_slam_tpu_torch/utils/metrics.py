"""Trajectory accuracy metrics: ATE RMSE with SE(3)/Sim(3)-style alignment
— a copy of ``graph_slam_tpu/utils/metrics.py`` (numpy only; copied, not
imported, because importing any ``graph_slam_tpu`` module imports jax).

BASELINE.md's accuracy target is "ATE RMSE parity with the gtsam reference
trajectory". Standard evaluation: rigidly align the estimate to the ground
truth (closed-form Umeyama on the positions), then RMSE of the residual
translations. Also provides RPE (relative pose error) over a fixed frame
delta — the drift metric.
"""

from __future__ import annotations

import numpy as np

__all__ = ["align_umeyama", "ate_rmse", "rpe", "ate_stats", "rpe_stats",
           "ate_rot_mean_deg"]


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Closed-form alignment est -> gt. Returns (R, t, s)."""
    est = np.asarray(est, float)
    gt = np.asarray(gt, float)
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    E = est - mu_e
    G = gt - mu_g
    S = G.T @ E / len(est)
    U, D, Vt = np.linalg.svd(S)
    W = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        W[2, 2] = -1.0
    R = U @ W @ Vt
    if with_scale:
        var_e = (E * E).sum() / len(est)
        s = float(np.trace(np.diag(D) @ W) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray, align: bool = True,
             with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE over positions (N, 3)."""
    est_t = np.asarray(est_t, float)
    gt_t = np.asarray(gt_t, float)
    if align:
        R, t, s = align_umeyama(est_t, gt_t, with_scale)
        est_t = (s * (R @ est_t.T)).T + t
    d = est_t - gt_t
    return float(np.sqrt((d * d).sum(axis=1).mean()))


def _error_stats(errors: np.ndarray) -> dict:
    """Benchmark-style summary of per-pose translational errors (the TUM
    evaluate_ate.py / evaluate_rpe.py report fields)."""
    e = np.asarray(errors, float)
    return {
        "rmse": float(np.sqrt((e * e).mean())),
        "mean": float(e.mean()),
        "median": float(np.median(e)),
        "std": float(e.std()),
        "min": float(e.min()),
        "max": float(e.max()),
        "n": int(len(e)),
    }


def ate_stats(est_t: np.ndarray, gt_t: np.ndarray, align: bool = True,
              with_scale: bool = False):
    """Full absolute-trajectory-error report.

    Returns ``(stats_dict, est_aligned (N, 3))`` where stats has
    rmse/mean/median/std/min/max/n of the per-pose position errors after
    the (optional) closed-form alignment, plus the applied scale.
    """
    est_t = np.asarray(est_t, float)
    gt_t = np.asarray(gt_t, float)
    s = 1.0
    if align:
        R, t, s = align_umeyama(est_t, gt_t, with_scale)
        est_t = (s * (R @ est_t.T)).T + t
    d = np.linalg.norm(est_t - gt_t, axis=1)
    stats = _error_stats(d)
    stats["scale"] = float(s)
    return stats, est_t


def ate_rot_mean_deg(est_R: np.ndarray, est_t: np.ndarray,
                     gt_R: np.ndarray, gt_t: np.ndarray) -> float:
    """Mean geodesic rotation error (degrees) after rotation alignment.

    The rotational half of the ATE report. The global alignment rotation
    is the rotation average ``proj_SO3(sum_k gt_R_k est_R_k^T)`` — NOT
    the position-Umeyama rotation: for short or near-straight
    trajectories the position fit leaves the rotation about the path
    axis unconstrained, inflating a sub-millidegree rotational error to
    several degrees (measured 9.43 deg vs 0.0006 deg on the 30-frame
    bench scenario). ``est_t``/``gt_t`` are accepted for signature
    stability but the alignment uses rotations only.
    """
    est_R = np.asarray(est_R, float)
    gt_R = np.asarray(gt_R, float)
    S = np.einsum("kij,klj->il", gt_R, est_R)   # sum_k gt_R_k est_R_k^T
    U, _, Vt = np.linalg.svd(S)
    W = np.eye(3)
    W[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R_a = U @ W @ Vt
    E = np.einsum("kji,jl,klm->kim", gt_R, R_a, est_R)
    tr = np.clip((np.trace(E, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(tr)).mean())


def rpe_stats(est_t: np.ndarray, gt_t: np.ndarray, delta: int = 1) -> dict:
    """Full relative-pose-error (drift) report over a fixed frame delta."""
    est_t = np.asarray(est_t, float)
    gt_t = np.asarray(gt_t, float)
    de = est_t[delta:] - est_t[:-delta]
    dg = gt_t[delta:] - gt_t[:-delta]
    d = np.linalg.norm(de - dg, axis=1)
    stats = _error_stats(d)
    stats["delta"] = int(delta)
    return stats


def rpe(est_t: np.ndarray, gt_t: np.ndarray, delta: int = 1) -> float:
    """Relative (drift) error RMSE: per-delta displacement differences."""
    est_t = np.asarray(est_t, float)
    gt_t = np.asarray(gt_t, float)
    de = est_t[delta:] - est_t[:-delta]
    dg = gt_t[delta:] - gt_t[:-delta]
    d = de - dg
    return float(np.sqrt((d * d).sum(axis=1).mean()))
