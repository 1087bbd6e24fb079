"""Typed factor tables: struct-of-arrays, padded, masked (port of
``graph/factors.py``).

One NamedTuple of tensors per factor type. Every row carries its variable
indices, measurement, square-root information, robust parameters and an
``active`` mask. Error convention matches GTSAM: factor error =
0.5 * ||whitened||^2 (or the Huber loss of the whitened norm).

Every table of the reference is ported, each linearized in closed form:
the pose prior and between tables, the velocity, bias and point priors
(J = S), the CombinedImuFactor table (30 columns), the OrientedPlane3Factor
table (9 columns) and the Cal3DS2 projection table (9 columns: pose, then
point, through both of ``project_point``'s clamps). The tests hold each
Jacobian to ``torch.func.jacfwd`` and to the reference's autodiff Jacobian.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3, so3
from ..device import resolve
from ..noise.models import ROBUST_HUBER, huber_weight
from ..planes import oriented_plane
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
    "empty_table",
    "empty_graph",
    "TABLE_TYPES",
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
    """OrientedPlane3Factor rows: ``meas`` is the plane observed in the body
    frame of pose ``pose_idx``; the prediction transforms the world
    landmark ``plane_idx`` into that frame."""

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


def _mv(A, x):
    """Batched matrix-vector product ``A @ x`` (whitening: ``S @ e``)."""
    return (A @ x[..., None])[..., 0]


def _prior_pose_residual(values: VariableArena, table: PriorPoseTable):
    X = se3.Pose(values.pose_R[table.idx], values.pose_t[table.idx])
    return se3.local(se3.Pose(table.mean_R, table.mean_t), X)


def _between_parts(values: VariableArena, table: BetweenPoseTable):
    Xi = se3.Pose(values.pose_R[table.i], values.pose_t[table.i])
    Xj = se3.Pose(values.pose_R[table.j], values.pose_t[table.j])
    h = se3.between(Xi, Xj)
    return h, se3.local(se3.Pose(table.meas_R, table.meas_t), h)


def _table_loss(table, e):
    r = _mv(table.sqrt_info, e)
    losses = _row_loss(r, table.robust_kind, table.robust_k)
    return torch.sum(torch.where(table.active, losses,
                                 torch.zeros_like(losses)))


def _prior_pose_lin(values: VariableArena, table: PriorPoseTable):
    """Closed-form linearization of PriorFactor<Pose3>.

    e = Log(m^-1 X); under the expmap retract, de/d(delta) = Jr^-1(e).
    """
    e = _prior_pose_residual(values, table)
    J = table.sqrt_info @ se3.right_jacobian_inverse(e)
    r = _mv(table.sqrt_info, e)
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
    r = _mv(S, e)
    J = torch.cat([S @ Ji, S @ Jri], dim=-1)  # (F, 6, 12)
    s = _robust_scale(r, table.robust_kind, table.robust_k)
    mask = table.active.to(r.dtype) * s
    return r * mask[:, None], J * mask[:, None, None]


def _prior_vec_lin(table, x):
    """Closed-form linearization of a vector prior: e = x + delta - mean,
    so J = S exactly."""
    r = _mv(table.sqrt_info, x[table.idx] - table.mean)
    s = _robust_scale(r, table.robust_kind, table.robust_k)
    mask = table.active.to(r.dtype) * s
    return r * mask[:, None], table.sqrt_info * mask[:, None, None]


class _ImuRows(NamedTuple):
    """The states and measurement fields one IMU row reads, gathered."""

    Ri: Tensor
    ti: Tensor
    vi: Tensor
    bi: Tensor
    Rj: Tensor
    tj: Tensor
    vj: Tensor
    bj: Tensor
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


def _imu_rows(values: VariableArena, table: ImuTable) -> _ImuRows:
    i, j = table.i, table.j
    return _ImuRows(
        values.pose_R[i], values.pose_t[i], values.vel[i], values.bias[i],
        values.pose_R[j], values.pose_t[j], values.vel[j], values.bias[j],
        table.dR, table.dp, table.dv, table.H_R_bg, table.H_p_ba,
        table.H_p_bg, table.H_v_ba, table.H_v_bg, table.bias_hat, table.dt,
        table.gravity)


class _ImuParts(NamedTuple):
    """The residual at the gathered states and what its Jacobian reuses."""

    e: Tensor       # (..., 15) [r_R, r_p, r_v, r_ba, r_bg]
    E: Tensor       # (..., 3, 3) dR~^T Ri^T Rj, r_R = Log(E)
    phi: Tensor     # (..., 3) H_R_bg dbg, dR~ = dR Exp(phi)
    RiT: Tensor     # (..., 3, 3)
    a_p: Tensor     # (..., 3) tj - ti - vi T - g T^2 / 2
    a_v: Tensor     # (..., 3) vj - vi - g T


def _imu_parts(g: _ImuRows) -> _ImuParts:
    """CombinedImuFactor residual (Forster) at the gathered states, with
    bias-corrected deltas by first-order Jacobians around ``bias_hat``."""
    db = g.bi - g.bias_hat
    dba, dbg = db[..., :3], db[..., 3:]
    phi = _mv(g.H_R_bg, dbg)
    dR = g.dR @ so3.expmap(phi)
    dv = g.dv + _mv(g.H_v_ba, dba) + _mv(g.H_v_bg, dbg)
    dp = g.dp + _mv(g.H_p_ba, dba) + _mv(g.H_p_bg, dbg)

    T = g.dt[..., None]
    RiT = g.Ri.transpose(-1, -2)
    E = dR.transpose(-1, -2) @ (RiT @ g.Rj)
    a_p = g.tj - g.ti - g.vi * T - 0.5 * g.gravity * T * T
    a_v = g.vj - g.vi - g.gravity * T
    e = torch.cat([so3.logmap(E), _mv(RiT, a_p) - dp, _mv(RiT, a_v) - dv,
                   g.bj - g.bi], dim=-1)
    return _ImuParts(e, E, phi, RiT, a_p, a_v)


def _imu_residual(g: _ImuRows, delta):
    """The IMU residual at the tangent step ``delta`` (..., 30), ordered
    X_i, v_i, b_i, X_j, v_j, b_j (poses by the expmap retraction)."""
    Xi = se3.retract(se3.Pose(g.Ri, g.ti), delta[..., 0:6])
    Xj = se3.retract(se3.Pose(g.Rj, g.tj), delta[..., 15:21])
    return _imu_parts(g._replace(
        Ri=Xi.R, ti=Xi.t, vi=g.vi + delta[..., 6:9],
        bi=g.bi + delta[..., 9:15], Rj=Xj.R, tj=Xj.t,
        vj=g.vj + delta[..., 21:24], bj=g.bj + delta[..., 24:30])).e


def _imu_jacobian(g: _ImuRows, p: _ImuParts):
    """Closed-form (F, 15, 30) Jacobian of the IMU residual at delta = 0.

    With r_R = Log(E) and Jr^-1 its inverse right Jacobian, under the
    expmap retractions (rotation perturbed on the right, translation by
    R v):
      d r_R / d w_i = -Jr^-1 Rj^T Ri,   d r_R / d w_j = Jr^-1,
      d r_R / d bg  = -Jr^-1 E^T Jr(phi) H_R_bg;
      d r_p / d w_i = [Ri^T a_p]x, d r_p / d v_i = -I, d r_p / d vel_i =
      -Ri^T T, d r_p / d v_j = Ri^T Rj, d r_p / d b_i = -H_p;
      d r_v / d w_i = [Ri^T a_v]x, d r_v / d vel_i = -Ri^T,
      d r_v / d vel_j = Ri^T, d r_v / d b_i = -H_v;
      d r_b / d b_i = -I, d r_b / d b_j = I.
    ``tests/test_torch_imu.py`` holds it to ``torch.func.jacfwd`` of
    ``_imu_residual`` and to the reference's autodiff Jacobian.
    """
    Jri = so3.left_jacobian_inverse(-p.e[..., 0:3])
    T = g.dt[..., None, None]
    I3 = torch.eye(3, dtype=T.dtype, device=T.device)
    J = torch.zeros(*p.e.shape[:-1], 15, 30, dtype=T.dtype, device=T.device)
    J[..., 0:3, 0:3] = -Jri @ g.Rj.transpose(-1, -2) @ g.Ri
    J[..., 0:3, 12:15] = (-Jri @ p.E.transpose(-1, -2)
                          @ so3.left_jacobian(-p.phi) @ g.H_R_bg)
    J[..., 0:3, 15:18] = Jri
    J[..., 3:6, 0:3] = so3.hat(_mv(p.RiT, p.a_p))
    J[..., 3:6, 3:6] = -I3
    J[..., 3:6, 6:9] = -p.RiT * T
    J[..., 3:6, 9:12] = -g.H_p_ba
    J[..., 3:6, 12:15] = -g.H_p_bg
    J[..., 3:6, 18:21] = p.RiT @ g.Rj
    J[..., 6:9, 0:3] = so3.hat(_mv(p.RiT, p.a_v))
    J[..., 6:9, 6:9] = -p.RiT
    J[..., 6:9, 9:12] = -g.H_v_ba
    J[..., 6:9, 12:15] = -g.H_v_bg
    J[..., 6:9, 21:24] = p.RiT
    I6 = torch.eye(6, dtype=T.dtype, device=T.device)
    J[..., 9:15, 9:15] = -I6
    J[..., 9:15, 24:30] = I6
    return J


def _imu_lin(values: VariableArena, table: ImuTable):
    """Whitened IMU rows and their closed-form (F, 15, 30) Jacobians."""
    rows = _imu_rows(values, table)
    parts = _imu_parts(rows)
    S = table.sqrt_info
    r = _mv(S, parts.e)
    J = S @ _imu_jacobian(rows, parts)
    s = _robust_scale(r, table.robust_kind, table.robust_k)
    mask = table.active.to(r.dtype) * s
    return r * mask[:, None], J * mask[:, None, None]


class _PlaneRows(NamedTuple):
    """The pose, landmark and measurement one plane row reads, gathered."""

    R: Tensor      # (F, 3, 3)
    t: Tensor      # (F, 3)
    L: Tensor      # (F, 4) world landmark
    meas: Tensor   # (F, 4) body-frame observation


def _plane_rows(values: VariableArena, table: PlaneTable) -> _PlaneRows:
    return _PlaneRows(values.pose_R[table.pose_idx],
                      values.pose_t[table.pose_idx],
                      values.plane[table.plane_idx], table.meas)


def _plane_residual(g: _PlaneRows, delta):
    """``local(meas, transform(retract(L, delta_L), retract(X, delta_X)))``
    at the tangent step ``delta`` (..., 9), pose first."""
    X = se3.retract(se3.Pose(g.R, g.t), delta[..., :6])
    Lw = oriented_plane.retract(g.L, delta[..., 6:])
    return oriented_plane.local(g.meas,
                                oriented_plane.transform(Lw, X.R, X.t))


def _plane_jacobian(g: _PlaneRows):
    """Closed-form (F, 3, 9) Jacobian of the plane residual at delta = 0.

    The prediction p = (R^T n, d + n . t) moves, to first order, by
    dn_p = [n_p]x w + R^T B(n) xi_n and dd_p = n_p . v + t^T B(n) xi_n +
    xi_d (pose tangent (w, v), landmark tangent (xi_n, xi_d)). The chart
    at the measurement a is e_n = B(a)^T w(n_p) with w = (theta / s) perp,
    perp = n_p - c a, c = a . n_p, s = |perp|, theta = atan2(s, c), whose
    derivative is

        dw/dn_p = g (I - u u^T) P + u (c u^T P - s a^T) / (s^2 + c^2),

    g = theta / s, u = perp / s, P = I - a a^T; at coincident normals
    (s^2 below the chart's threshold, where w = perp) it is P. The
    ``oriented_plane.local`` form (atan2) keeps this finite there in
    float32, where an arccos derivative would be NaN.
    """
    n = g.L[..., :3]
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)   # retract(L, 0)
    BL = oriented_plane.basis(g.L[..., :3])
    RT = g.R.transpose(-1, -2)
    n_p = _mv(RT, n)
    a = g.meas[..., :3]
    c = torch.clamp(torch.sum(a * n_p, dim=-1), -1.0, 1.0)
    perp = n_p - c[..., None] * a
    s2 = torch.sum(perp * perp, dim=-1)
    ok = s2 > torch.finfo(c.dtype).tiny ** 0.5
    s = torch.sqrt(torch.where(ok, s2, torch.ones_like(s2)))
    theta = torch.atan2(torch.where(ok, s, torch.zeros_like(s)), c)
    gs = (theta / s)[..., None, None]
    u = perp / s[..., None]
    eye = torch.eye(3, dtype=c.dtype, device=c.device)
    P = eye - a[..., :, None] * a[..., None, :]
    uuT = u[..., :, None] * u[..., None, :]
    uTP = (u[..., None, :] @ P)[..., 0, :]
    tail = (c[..., None] * uTP - s[..., None] * a) \
        / (s2 + c * c)[..., None]
    Dw = gs * ((eye - uuT) @ P) + u[..., :, None] * tail[..., None, :]
    Dw = torch.where(ok[..., None, None], Dw, P)
    En = oriented_plane.basis(a).transpose(-1, -2) @ Dw    # (F, 2, 3)
    RTB = RT @ BL                                          # (F, 3, 2)
    J = torch.zeros(*c.shape, 3, 9, dtype=c.dtype, device=c.device)
    J[..., 0:2, 0:3] = En @ so3.hat(n_p)
    J[..., 0:2, 6:8] = En @ RTB
    J[..., 2, 3:6] = n_p
    J[..., 2, 6:8] = (g.t[..., None, :] @ BL)[..., 0, :]
    J[..., 2, 8] = 1.0
    return J


def _plane_lin(values: VariableArena, table: PlaneTable):
    """Whitened plane rows and their closed-form (F, 3, 9) Jacobians."""
    rows = _plane_rows(values, table)
    zero = torch.zeros(*table.meas.shape[:-1], 9, dtype=rows.t.dtype,
                       device=rows.t.device)
    S = table.sqrt_info
    r = _mv(S, _plane_residual(rows, zero))
    J = S @ _plane_jacobian(rows)
    s = _robust_scale(r, table.robust_kind, table.robust_k)
    mask = table.active.to(r.dtype) * s
    return r * mask[:, None], J * mask[:, None, None]


def _projection_parts(values: VariableArena, table: ProjectionTable):
    """(pose R, body-frame point p_b, camera-frame point p_cam) per row:
    the sensor pose is T_ws = X * body_P_sensor, p_cam = T_ws^-1 q."""
    R = values.pose_R[table.pose_idx]
    t = values.pose_t[table.pose_idx]
    q = values.point[table.point_idx]
    T_ws = se3.compose(se3.Pose(R, t), se3.Pose(table.body_R, table.body_t))
    return R, se3.transform_to(se3.Pose(R, t), q), se3.transform_to(T_ws, q)


def _projection_error_vec(values: VariableArena, table: ProjectionTable):
    """Pixel reprojection error project(T_ws^-1 q) - uv (unwhitened)."""
    from ..vision.cal3ds2 import Cal3DS2, project_point

    p_cam = _projection_parts(values, table)[2]
    return project_point(Cal3DS2.from_rows(table.cal), p_cam) - table.uv


def _projection_lin(values: VariableArena, table: ProjectionTable):
    """Whitened projection rows and their closed-form (F, 2, 9) Jacobians.

    Under X' = X Exp(xi), xi = (w, v), the body-frame point moves by
    d p_b = [p_b]x w - v, and under q' = q + dq by R^T dq; p_cam =
    B_R^T (p_b - B_t). With D = d uv / d p_cam from
    ``project_point_jacobian``: J_pose = D B_R^T [[p_b]x, -I],
    J_point = D B_R^T R^T.
    """
    from ..vision.cal3ds2 import Cal3DS2, project_point_jacobian

    R, p_b, p_cam = _projection_parts(values, table)
    uv, D = project_point_jacobian(Cal3DS2.from_rows(table.cal), p_cam)
    Db = D @ table.body_R.transpose(-1, -2)              # d uv / d p_b
    J = torch.cat([Db @ so3.hat(p_b), -Db, Db @ R.transpose(-1, -2)],
                  dim=-1)
    S = table.sqrt_info
    r = _mv(S, uv - table.uv)
    s = _robust_scale(r, table.robust_kind, table.robust_k)
    mask = table.active.to(r.dtype) * s
    return r * mask[:, None], (S @ J) * mask[:, None, None]


def total_error(graph: FactorGraph, values: VariableArena):
    """GTSAM ``NonlinearFactorGraph::error``: sum of factor losses (0-d)."""
    e = torch.zeros((), dtype=values.pose_t.dtype, device=values.pose_t.device)
    if graph.prior_pose.idx.shape[0]:
        e = e + _table_loss(graph.prior_pose,
                            _prior_pose_residual(values, graph.prior_pose))
    if graph.between.i.shape[0]:
        e = e + _table_loss(graph.between,
                            _between_parts(values, graph.between)[1])
    for name, x in (("prior_vel", values.vel), ("prior_bias", values.bias),
                    ("prior_point", values.point)):
        tb = getattr(graph, name)
        if tb.idx.shape[0]:
            e = e + _table_loss(tb, x[tb.idx] - tb.mean)
    if graph.plane.pose_idx.shape[0]:
        rows = _plane_rows(values, graph.plane)
        zero = torch.zeros(*graph.plane.meas.shape[:-1], 9,
                           dtype=rows.t.dtype, device=rows.t.device)
        e = e + _table_loss(graph.plane, _plane_residual(rows, zero))
    if graph.imu.i.shape[0]:
        e = e + _table_loss(graph.imu,
                            _imu_parts(_imu_rows(values, graph.imu)).e)
    if graph.projection.pose_idx.shape[0]:
        e = e + _table_loss(graph.projection,
                            _projection_error_vec(values, graph.projection))
    return e


def linearize_blocks(graph: FactorGraph, values: VariableArena):
    """Whitened, robust-weighted, masked (r, J, cols) per factor type.

    Returns a list of blocks ``(r: (F, e), J: (F, e, td), cols: (F, td))``
    with ``cols`` indexing the global tangent layout.
    """
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
    if graph.prior_vel.idx.shape[0]:
        r, J = _prior_vec_lin(graph.prior_vel, values.vel)
        blocks.append((r, J, lay.vel_cols(graph.prior_vel.idx)))
    if graph.prior_bias.idx.shape[0]:
        r, J = _prior_vec_lin(graph.prior_bias, values.bias)
        blocks.append((r, J, lay.bias_cols(graph.prior_bias.idx)))
    if graph.plane.pose_idx.shape[0]:
        r, J = _plane_lin(values, graph.plane)
        cols = torch.cat([lay.pose_cols(graph.plane.pose_idx),
                          lay.plane_cols(graph.plane.plane_idx)], dim=-1)
        blocks.append((r, J, cols))
    if graph.imu.i.shape[0]:
        r, J = _imu_lin(values, graph.imu)
        i, j = graph.imu.i, graph.imu.j
        cols = torch.cat([lay.pose_cols(i), lay.vel_cols(i), lay.bias_cols(i),
                          lay.pose_cols(j), lay.vel_cols(j), lay.bias_cols(j)],
                         dim=-1)
        blocks.append((r, J, cols))
    if graph.projection.pose_idx.shape[0]:
        r, J = _projection_lin(values, graph.projection)
        cols = torch.cat([lay.pose_cols(graph.projection.pose_idx),
                          lay.point_cols(graph.projection.point_idx)], dim=-1)
        blocks.append((r, J, cols))
    if graph.prior_point.idx.shape[0]:
        r, J = _prior_vec_lin(graph.prior_point, values.point)
        blocks.append((r, J, lay.point_cols(graph.prior_point.idx)))
    return blocks


# ---------------------------------------------------------------------------
# Empty tables


_FLOAT_SHAPES = {
    PriorPoseTable: {"mean_R": (3, 3), "mean_t": (3,), "sqrt_info": (6, 6)},
    BetweenPoseTable: {"meas_R": (3, 3), "meas_t": (3,), "sqrt_info": (6, 6)},
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
_ROTATIONS = ("mean_R", "meas_R", "dR", "body_R")
# each FactorGraph field's table type, in field order
TABLE_TYPES = dict(zip(FactorGraph._fields, _FLOAT_SHAPES))


def empty_table(table_type, cap: int = 0, *, dtype=torch.float64,
                device=None):
    """A table of ``cap`` inactive rows with the reference's benign
    defaults: identity rotations, unit ``dt`` and robust ``k``, the plane
    measurement (0, 0, 1, 0), unit focal lengths, zero sqrt-information."""
    device = resolve(device)
    shapes = _FLOAT_SHAPES[table_type]
    fields = {}
    for name in table_type._fields:
        if name == "active":
            fields[name] = torch.zeros(cap, dtype=torch.bool, device=device)
        elif name in _ROTATIONS:
            fields[name] = torch.eye(3, dtype=dtype, device=device).repeat(
                cap, 1, 1)
        elif name in ("robust_k", "dt"):
            fields[name] = torch.ones(cap, dtype=dtype, device=device)
        elif name in shapes:
            fields[name] = torch.zeros((cap, *shapes[name]), dtype=dtype,
                                       device=device)
        else:
            fields[name] = torch.zeros(cap, dtype=torch.int64, device=device)
    if table_type is PlaneTable:
        fields["meas"][:, 2] = 1.0
    if table_type is ProjectionTable:
        fields["cal"][:, :2] = 1.0
    return table_type(**fields)


def empty_graph(prior_pose_cap=0, between_cap=0, prior_vel_cap=0,
                prior_bias_cap=0, plane_cap=0, imu_cap=0, projection_cap=0,
                prior_point_cap=0, *, dtype=torch.float64,
                device=None) -> FactorGraph:
    """A ``FactorGraph`` of empty tables at the given capacities, on
    ``device`` (``None``: the CUDA card)."""
    device = resolve(device)
    caps = (prior_pose_cap, between_cap, prior_vel_cap, prior_bias_cap,
            plane_cap, imu_cap, projection_cap, prior_point_cap)
    return FactorGraph(*(empty_table(typ, cap, dtype=dtype, device=device)
                         for typ, cap in zip(TABLE_TYPES.values(), caps)))
