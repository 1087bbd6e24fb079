"""Plane-consistency evaluation of VO edges — ``test_plane_check_vo`` twin
(port of ``pipelines/plane_check.py``).

Reference (``gtsam/test_plane_check_vo.cpp``): for each VO edge, extract
planes in both frames, match by normal angle (< 10 deg) and distance
offset (<= 0.2) after transforming through the VO estimate, and score the
worst matched pair by the Mahalanobis distance of the plane error under
the propagated covariances (``computePlaneDis`` ``:383-445``,
``computePlaneNodeDis`` ``:328-379``). Output lines:
``id_to id_from num_matches err err_raw``.

The tangent Jacobians of the plane transform and of the error chart are
forward-mode autodiff (``torch.func.jacfwd``) of the port's
``oriented_plane`` functions, as the reference takes them with
``jax.jacfwd``. The functions take host arrays and compute on ``device``
(``None``: the card) in ``dtype``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jacfwd

from ..core import se3
from ..device import resolve
from ..io.vro_log import VROLog
from ..planes import oriented_plane

__all__ = ["plane_pair_mahalanobis", "plane_set_consistency",
           "check_vo_edges"]

_COS10 = math.cos(10.0 * math.pi / 180.0)


def _transform_jacobians(plane, xi):
    """Jacobians of transform(plane, Exp(xi)) wrt (plane tangent, xi)."""
    T = se3.expmap(xi)
    base = oriented_plane.transform(plane, T.R, T.t)

    def f_plane(dp):
        p = oriented_plane.retract(plane, dp)
        out = oriented_plane.transform(p, T.R, T.t)
        return oriented_plane.local(base, out)

    def f_pose(dxi):
        T2 = se3.compose(T, se3.expmap(dxi))
        out = oriented_plane.transform(plane, T2.R, T2.t)
        return oriented_plane.local(base, out)

    Jp = jacfwd(f_plane)(torch.zeros_like(plane[:3]))
    Jt = jacfwd(f_pose)(torch.zeros_like(xi))
    return base, Jp, Jt


def _error_jacobians(pa, pb):
    """e = local(pa, pb) and its Jacobians wrt both planes' tangents."""
    e = oriented_plane.local(pa, pb)

    def fa(d):
        return oriented_plane.local(oriented_plane.retract(pa, d), pb)

    def fb(d):
        return oriented_plane.local(pa, oriented_plane.retract(pb, d))

    zero = torch.zeros_like(pa[:3])
    return e, jacfwd(fa)(zero), jacfwd(fb)(zero)


def plane_pair_mahalanobis(plane_i, cov_i, plane_j, cov_j, xi_ij, S_ij, *,
                           device=None, dtype=torch.float64):
    """computePlaneDis: Mahalanobis distance of (transform(p_i, T_ij), p_j).

    ``cov_*`` are (3,3) tangent covariances; ``S_ij`` the 6x6 VO pose
    covariance. Returns (mahalanobis, raw_sq_error).
    """
    dev = resolve(device)

    def t(x):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    pred, Jp, Jt = _transform_jacobians(t(plane_i), t(xi_ij))
    S_pred = Jt @ t(S_ij) @ Jt.T + Jp @ t(cov_i) @ Jp.T
    e, Ja, Jb = _error_jacobians(pred, t(plane_j))
    S_e = Ja @ S_pred @ Ja.T + Jb @ t(cov_j) @ Jb.T
    m = e @ torch.linalg.solve(S_e, e)
    return float(m), float(e @ e)


def plane_set_consistency(planes_i, covs_i, planes_j, covs_j, xi_ij, S_ij,
                          cos_thresh: float = _COS10,
                          d_thresh: float = 0.2, *, device=None,
                          dtype=torch.float64):
    """computePlaneNodeDis: match planes through the VO transform, return
    (num_matches, max_mahalanobis, raw_err_of_max)."""
    dev = resolve(device)
    T = se3.expmap(torch.as_tensor(np.asarray(xi_ij), device=dev).to(dtype))
    n_match = 0
    err = 0.0
    err_raw = 0.0
    for i, pi in enumerate(planes_i):
        pred = oriented_plane.transform(
            torch.as_tensor(np.asarray(pi), device=dev).to(dtype), T.R,
            T.t).cpu().numpy()
        for j, pj in enumerate(planes_j):
            cosa = float(np.dot(pred[:3], np.asarray(pj)[:3]))
            if abs(cosa) < cos_thresh:
                continue
            sign = -1.0 if cosa < 0 else 1.0
            if abs(sign * pred[3] - pj[3]) > d_thresh:
                continue
            n_match += 1
            m, raw = plane_pair_mahalanobis(pi, covs_i[i], pj, covs_j[j],
                                            xi_ij, S_ij, device=dev,
                                            dtype=dtype)
            if m > err:
                err, err_raw = m, raw
            break
    return n_match, err, err_raw


def check_vo_edges(log: VROLog, plane_provider, out_path: str | None = None,
                   *, device=None, dtype=torch.float64):
    """Score every valid VO edge by plane consistency.

    ``plane_provider(seq_id) -> (planes (P,4) list, covs (P,3,3) list)``.
    Returns rows of (id_to, id_from, num, err, err_raw); optionally writes
    the reference's log format.
    """
    dev = resolve(device)
    rows = []
    valid = log.valid
    for k in range(len(log)):
        if not valid[k]:
            continue
        pi, ci = plane_provider(int(log.id_from[k]))
        pj, cj = plane_provider(int(log.id_to[k]))
        S_ij = np.linalg.inv(log.info[k])
        n, err, err_raw = plane_set_consistency(pi, ci, pj, cj, log.xi[k],
                                                S_ij, device=dev,
                                                dtype=dtype)
        rows.append((int(log.id_to[k]), int(log.id_from[k]), n, err,
                     err_raw))
    if out_path:
        with open(out_path, "w") as f:
            for r in rows:
                f.write(f"{r[0]} {r[1]} {r[2]} {r[3]!r} {r[4]!r}\n")
    return rows
