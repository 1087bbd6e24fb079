"""Typed factor tables: struct-of-arrays, padded, masked (port of
``graph/factors.py``).

One NamedTuple of tensors per factor type. Every row carries its variable
indices, measurement, square-root information, robust parameters and an
``active`` mask. Error convention matches GTSAM: factor error =
0.5 * ||whitened||^2 (or the Huber loss of the whitened norm).

Ported: ``PriorPoseTable`` and ``BetweenPoseTable`` with their closed-form
linearizations. The other six tables exist with their fields so a
``FactorGraph`` has the reference's shape; they must have capacity 0, and
``total_error``/``linearize_blocks`` raise ``NotImplementedError`` on one
that does not.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from ..device import resolve
from ..noise.models import ROBUST_HUBER, huber_weight
from .variables import VariableArena, layout_of

__all__ = [
    "PriorPoseTable",
    "BetweenPoseTable",
    "PriorVec3Table",
    "PriorVec6Table",
    "PlaneTable",
    "ImuTable",
    "ProjectionTable",
    "PriorPointTable",
    "FactorGraph",
    "total_error",
    "linearize_blocks",
]

Tensor = torch.Tensor


class PriorPoseTable(NamedTuple):
    """PriorFactor<Pose3> rows."""

    idx: Tensor        # (F,) int64 pose slot
    mean_R: Tensor     # (F, 3, 3)
    mean_t: Tensor     # (F, 3)
    sqrt_info: Tensor  # (F, 6, 6)
    robust_kind: Tensor  # (F,) int64
    robust_k: Tensor     # (F,)
    active: Tensor       # (F,) bool


class BetweenPoseTable(NamedTuple):
    """BetweenFactor<Pose3> rows (VO edges and loop closures)."""

    i: Tensor
    j: Tensor
    meas_R: Tensor
    meas_t: Tensor
    sqrt_info: Tensor  # (F, 6, 6)
    robust_kind: Tensor
    robust_k: Tensor
    active: Tensor


class PriorVec3Table(NamedTuple):
    idx: Tensor
    mean: Tensor
    sqrt_info: Tensor
    robust_kind: Tensor
    robust_k: Tensor
    active: Tensor


class PriorVec6Table(NamedTuple):
    idx: Tensor
    mean: Tensor
    sqrt_info: Tensor
    robust_kind: Tensor
    robust_k: Tensor
    active: Tensor


class PlaneTable(NamedTuple):
    pose_idx: Tensor
    plane_idx: Tensor
    meas: Tensor
    sqrt_info: Tensor
    robust_kind: Tensor
    robust_k: Tensor
    active: Tensor


class ImuTable(NamedTuple):
    i: Tensor
    j: Tensor
    dR: Tensor
    dp: Tensor
    dv: Tensor
    H_R_bg: Tensor
    H_p_ba: Tensor
    H_p_bg: Tensor
    H_v_ba: Tensor
    H_v_bg: Tensor
    bias_hat: Tensor
    dt: Tensor
    gravity: Tensor
    sqrt_info: Tensor
    robust_kind: Tensor
    robust_k: Tensor
    active: Tensor


class ProjectionTable(NamedTuple):
    pose_idx: Tensor
    point_idx: Tensor
    uv: Tensor
    cal: Tensor
    body_R: Tensor
    body_t: Tensor
    sqrt_info: Tensor
    robust_kind: Tensor
    robust_k: Tensor
    active: Tensor


class PriorPointTable(NamedTuple):
    idx: Tensor
    mean: Tensor
    sqrt_info: Tensor
    robust_kind: Tensor
    robust_k: Tensor
    active: Tensor


class FactorGraph(NamedTuple):
    prior_pose: PriorPoseTable
    between: BetweenPoseTable
    prior_vel: PriorVec3Table
    prior_bias: PriorVec6Table
    plane: PlaneTable
    imu: ImuTable
    projection: ProjectionTable
    prior_point: PriorPointTable


# The ROADMAP item that ports each table that is not ported yet.
_NOT_PORTED = {
    "prior_vel": "B (VIO scan engine)",
    "prior_bias": "B (VIO scan engine)",
    "imu": "B (VIO scan engine)",
    "plane": "C (plane rescue)",
    "projection": "D (bundle adjustment)",
    "prior_point": "D (bundle adjustment)",
}


def _check_ported(graph: FactorGraph):
    for name, item in _NOT_PORTED.items():
        if getattr(graph, name)[0].shape[0]:
            raise NotImplementedError(
                f"factor table {name!r} is not ported yet (ROADMAP item "
                f"{item}); only prior_pose and between tables may be "
                f"non-empty")


# ---------------------------------------------------------------------------
# Generic per-row machinery


def _robust_scale(r, kind, k):
    """sqrt(weight) for the whitened residual norm, GTSAM robust semantics."""
    d = torch.linalg.norm(r, dim=-1)
    w = torch.where(kind == ROBUST_HUBER, huber_weight(d, k),
                    torch.ones_like(d))
    return torch.sqrt(w)


def _row_loss(r, kind, k):
    """Factor error: 0.5 d^2 (Gaussian) or Huber loss of whitened norm d."""
    d2 = torch.sum(r * r, dim=-1)
    d = torch.sqrt(torch.where(d2 > 0, d2, torch.zeros_like(d2)))
    quad = 0.5 * d2
    hub = torch.where(d <= k, quad, k * (d - 0.5 * k))
    return torch.where(kind == ROBUST_HUBER, hub, quad)


def _whiten(S, e):
    return (S @ e[..., None])[..., 0]


def _prior_pose_residual(values: VariableArena, table: PriorPoseTable):
    X = se3.Pose(values.pose_R[table.idx], values.pose_t[table.idx])
    return se3.local(se3.Pose(table.mean_R, table.mean_t), X)


def _between_parts(values: VariableArena, table: BetweenPoseTable):
    Xi = se3.Pose(values.pose_R[table.i], values.pose_t[table.i])
    Xj = se3.Pose(values.pose_R[table.j], values.pose_t[table.j])
    h = se3.between(Xi, Xj)
    return h, se3.local(se3.Pose(table.meas_R, table.meas_t), h)


def _table_loss(table, e):
    r = _whiten(table.sqrt_info, e)
    losses = _row_loss(r, table.robust_kind, table.robust_k)
    return torch.sum(torch.where(table.active, losses,
                                 torch.zeros_like(losses)))


def _prior_pose_lin(values: VariableArena, table: PriorPoseTable):
    """Closed-form linearization of PriorFactor<Pose3>.

    e = Log(m^-1 X); under the expmap retract, de/d(delta) = Jr^-1(e).
    """
    e = _prior_pose_residual(values, table)
    J = table.sqrt_info @ se3.right_jacobian_inverse(e)
    r = _whiten(table.sqrt_info, e)
    s = _robust_scale(r, table.robust_kind, table.robust_k)
    mask = table.active.to(r.dtype) * s
    return r * mask[:, None], J * mask[:, None, None]


def _between_lin(values: VariableArena, table: BetweenPoseTable):
    """Closed-form linearization of BetweenFactor<Pose3>.

    h = Xi^-1 Xj, e = Log(m^-1 h):
      de/d(delta_j) =  Jr^-1(e)
      de/d(delta_i) = -Jr^-1(e) Ad(h^-1)
    """
    h, e = _between_parts(values, table)
    Jri = se3.right_jacobian_inverse(e)
    Ji = -Jri @ se3.adjoint(se3.inverse(h))
    S = table.sqrt_info
    r = _whiten(S, e)
    J = torch.cat([S @ Ji, S @ Jri], dim=-1)  # (F, 6, 12)
    s = _robust_scale(r, table.robust_kind, table.robust_k)
    mask = table.active.to(r.dtype) * s
    return r * mask[:, None], J * mask[:, None, None]


def total_error(graph: FactorGraph, values: VariableArena):
    """GTSAM ``NonlinearFactorGraph::error``: sum of factor losses (0-d)."""
    _check_ported(graph)
    e = torch.zeros((), dtype=values.pose_t.dtype, device=values.pose_t.device)
    if graph.prior_pose.idx.shape[0]:
        e = e + _table_loss(graph.prior_pose,
                            _prior_pose_residual(values, graph.prior_pose))
    if graph.between.i.shape[0]:
        e = e + _table_loss(graph.between,
                            _between_parts(values, graph.between)[1])
    return e


def linearize_blocks(graph: FactorGraph, values: VariableArena):
    """Whitened, robust-weighted, masked (r, J, cols) per factor type.

    Returns a list of blocks ``(r: (F, e), J: (F, e, td), cols: (F, td))``
    with ``cols`` indexing the global tangent layout.
    """
    _check_ported(graph)
    lay = layout_of(values)
    blocks = []
    if graph.prior_pose.idx.shape[0]:
        r, J = _prior_pose_lin(values, graph.prior_pose)
        blocks.append((r, J, lay.pose_cols(graph.prior_pose.idx)))
    if graph.between.i.shape[0]:
        r, J = _between_lin(values, graph.between)
        cols = torch.cat([lay.pose_cols(graph.between.i),
                          lay.pose_cols(graph.between.j)], dim=-1)
        blocks.append((r, J, cols))
    return blocks


# ---------------------------------------------------------------------------
# Empty tables


_FLOAT_SHAPES = {
    PriorVec3Table: {"mean": (3,), "sqrt_info": (3, 3)},
    PriorVec6Table: {"mean": (6,), "sqrt_info": (6, 6)},
    PlaneTable: {"meas": (4,), "sqrt_info": (3, 3)},
    ImuTable: {"dR": (3, 3), "dp": (3,), "dv": (3,), "H_R_bg": (3, 3),
               "H_p_ba": (3, 3), "H_p_bg": (3, 3), "H_v_ba": (3, 3),
               "H_v_bg": (3, 3), "bias_hat": (6,), "dt": (),
               "gravity": (3,), "sqrt_info": (15, 15)},
    ProjectionTable: {"uv": (2,), "cal": (9,), "body_R": (3, 3),
                      "body_t": (3,), "sqrt_info": (2, 2)},
    PriorPointTable: {"mean": (3,), "sqrt_info": (3, 3)},
}


def empty_table(table_type, *, dtype=torch.float64, device=None):
    """A capacity-0 table of one of the six types not ported yet."""
    device = resolve(device)
    shapes = _FLOAT_SHAPES[table_type]
    fields = {}
    for name in table_type._fields:
        if name == "active":
            fields[name] = torch.zeros(0, dtype=torch.bool, device=device)
        elif name == "robust_k" or name in shapes:
            fields[name] = torch.zeros(0, *shapes.get(name, ()), dtype=dtype,
                                       device=device)
        else:
            fields[name] = torch.zeros(0, dtype=torch.int64, device=device)
    return table_type(**fields)
