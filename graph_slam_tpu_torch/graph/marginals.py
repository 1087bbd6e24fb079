"""Marginal covariances from the optimized graph (port of
``graph/marginals.py``).

GTSAM ``Marginals(graph, estimate, CHOLESKY)``: assemble the dense Hessian
at the estimate (``graph.assemble``), factor it once by Cholesky, and read
the requested block of its inverse by triangular solves against unit
columns. Where the Hessian is not positive definite the covariance is NaN,
as the reference's Cholesky gives, with no host sync.
"""

from __future__ import annotations

import torch

from .assemble import assemble_dense
from .factors import FactorGraph
from .variables import VariableArena, layout_of

__all__ = ["marginal_covariance_cols", "pose_marginal", "plane_marginal",
           "joint_marginal", "pose_marginals_all"]


def _cov_columns(H, cols):
    """Columns of H^-1 at ``cols`` (D, w) from one Cholesky."""
    L, info = torch.linalg.cholesky_ex(H)
    E = torch.zeros(H.shape[0], cols.shape[0], dtype=H.dtype,
                    device=H.device)
    E[cols, torch.arange(cols.shape[0], device=H.device)] = 1.0
    Y = torch.linalg.solve_triangular(L, E, upper=False)
    X = torch.linalg.solve_triangular(L.T, Y, upper=True)
    return torch.where(info == 0, X, torch.full_like(X, float("nan")))


def marginal_covariance_cols(graph: FactorGraph, values: VariableArena,
                             cols):
    """(w, w) marginal covariance of the tangent slots ``cols``."""
    H, _ = assemble_dense(graph, values)
    return _cov_columns(H, cols)[cols, :]


def _slots(values, off, width, idx):
    return off + width * idx + torch.arange(width,
                                            device=values.pose_t.device)


def pose_marginal(graph: FactorGraph, values: VariableArena, idx: int):
    """6x6 marginal covariance of pose ``idx`` (tangent = (omega, v))."""
    lay = layout_of(values)
    return marginal_covariance_cols(graph, values,
                                    _slots(values, lay.pose_off, 6, idx))


def plane_marginal(graph: FactorGraph, values: VariableArena, idx: int):
    """3x3 marginal covariance of plane landmark ``idx``."""
    lay = layout_of(values)
    return marginal_covariance_cols(graph, values,
                                    _slots(values, lay.plane_off, 3, idx))


def joint_marginal(graph: FactorGraph, values: VariableArena, cols):
    """Joint marginal over an arbitrary tangent slot selection."""
    return marginal_covariance_cols(
        graph, values, torch.as_tensor(cols, device=values.pose_t.device))


def pose_marginals_all(graph: FactorGraph, values: VariableArena, n: int):
    """(n, 6, 6) marginal covariances of poses 0..n-1 from ONE Cholesky,
    reused for all 6n unit-column solves; the diagonal 6x6 blocks of the
    joint pose covariance are gathered."""
    lay = layout_of(values)
    H, _ = assemble_dense(graph, values)
    cols = lay.pose_off + torch.arange(n * 6, device=H.device)
    B = _cov_columns(H, cols)[cols, :]            # (6n, 6n) joint
    idx = torch.arange(n, device=H.device)
    return B.reshape(n, 6, n, 6)[idx, :, idx, :]
