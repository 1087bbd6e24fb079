"""Host-side graph construction: append factors, freeze to padded tables
(port of ``graph/builder.py``).

Callers add variables and factors one by one in numpy; ``build()`` freezes
them into the ``FactorGraph`` + ``VariableArena`` of tensors on the
requested device and dtype. Capacities round up to buckets, or follow the
capacity arguments, by the reference's rules, so graphs keep the
reference's padded shapes. Every variable kind (poses, velocities, biases,
planes, points) and every factor table of the reference is built here.

Rows are kept per table as dicts and frozen column by column with one
numpy conversion each, so a graph of ~10^6 rows freezes in seconds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from .factors import TABLE_TYPES, FactorGraph, empty_table
from .variables import VariableArena

__all__ = ["GraphBuilder", "round_up"]

# the PreintState fields an IMU row copies as they are
_IMU_FIELDS = ("dR", "dp", "dv", "H_R_bg", "H_p_ba", "H_p_bg", "H_v_ba",
               "H_v_bg", "bias_hat")


def round_up(n: int, bucket: int = 64) -> int:
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def _sqrt_info(dim, sqrt_info=None, sigmas=None, information=None,
               covariance=None, sigma=None):
    if sqrt_info is not None:
        return np.asarray(sqrt_info, np.float64)
    if sigmas is not None:
        return np.diag(1.0 / np.asarray(sigmas, np.float64))
    if sigma is not None:
        return np.eye(dim) / float(sigma)
    if information is not None:
        info = np.asarray(information, np.float64)
        return np.linalg.cholesky(info).T
    if covariance is not None:
        cov = np.asarray(covariance, np.float64)
        return np.linalg.cholesky(np.linalg.inv(cov)).T
    raise ValueError("one of sqrt_info/sigmas/sigma/information/covariance "
                     "required")


def _as_Rt(pose):
    """Accept an (R, t) pair, a 4x4 matrix, or an object with .R and .t."""
    if hasattr(pose, "R") and hasattr(pose, "t"):
        return np.asarray(pose.R, np.float64), np.asarray(pose.t, np.float64)
    if isinstance(pose, (tuple, list)) and len(pose) == 2:
        return np.asarray(pose[0], np.float64), np.asarray(pose[1], np.float64)
    pose = np.asarray(pose, np.float64)
    if pose.shape == (4, 4):
        return pose[:3, :3], pose[:3, 3]
    raise ValueError(f"cannot interpret pose with shape {pose.shape}")


class _Table:
    """One factor table's rows before ``build``: single rows as dicts, and
    blocks of rows as column arrays (``_add_rows``), in the order added."""

    def __init__(self, table_type):
        self.table_type = table_type
        self.blocks = []     # (n, {field: (n, ...) array})
        self.rows = []       # dicts not yet in a block

    def __len__(self):
        return sum(n for n, _ in self.blocks) + len(self.rows)

    def _flush(self):
        if self.rows:
            cols = {f: np.asarray([r[f] for r in self.rows])
                    for f in self.rows[0] if f != "robust"}
            rb = [r["robust"] for r in self.rows]
            cols["robust_kind"] = np.array([0 if k is None else 1
                                            for k in rb])
            cols["robust_k"] = np.array([1.0 if k is None else float(k)
                                         for k in rb])
            self.blocks.append((len(self.rows), cols))
            self.rows = []

    def add_block(self, n, cols):
        self._flush()
        self.blocks.append((n, cols))

    def freeze(self, cap, device, dtype):
        """Padded table of capacity ``cap``: the rows first, then
        ``empty_table``'s inactive defaults."""
        self._flush()
        out = {f: t.numpy().copy() for f, t in zip(
            self.table_type._fields,
            empty_table(self.table_type, cap, device="cpu"))}
        r0 = 0
        for n, cols in self.blocks:
            for f, a in cols.items():
                out[f][r0:r0 + n] = a
            r0 += n
        out["active"][:r0] = True

        def up(a):
            t = torch.as_tensor(a, device=device)
            return t.to(dtype) if t.is_floating_point() else t

        return self.table_type(**{f: up(a) for f, a in out.items()})


def _cal9(cal):
    """A Cal3DS2-like object (fx, fy, s, u0/cx, v0/cy, k1, k2, p1, p2) or a
    packed tuple (zero-filled to 9) -> (9,) float64."""
    if hasattr(cal, "fx"):
        def f(x):
            return float(x.item() if isinstance(x, torch.Tensor) else x)

        return np.array([f(cal.fx), f(cal.fy), f(getattr(cal, "s", 0.0)),
                         f(getattr(cal, "u0", getattr(cal, "cx", 0.0))),
                         f(getattr(cal, "v0", getattr(cal, "cy", 0.0))),
                         f(cal.k1), f(cal.k2), f(cal.p1), f(cal.p2)])
    c = np.asarray(cal, np.float64)
    return np.concatenate([c, np.zeros(9 - c.shape[0])]) \
        if c.shape[0] < 9 else c


class GraphBuilder:
    def __init__(self):
        self._poses: list[tuple[np.ndarray, np.ndarray]] = []
        self._vels: list[np.ndarray] = []
        self._biases: list[np.ndarray] = []
        self._planes: list[np.ndarray] = []
        self._points: list[np.ndarray] = []
        self._tables = {name: _Table(typ) for name, typ in TABLE_TYPES.items()}

    # -- variables -----------------------------------------------------
    def add_pose(self, pose) -> int:
        self._poses.append(_as_Rt(pose))
        return len(self._poses) - 1

    def set_pose(self, idx: int, pose):
        self._poses[idx] = _as_Rt(pose)

    def add_vel(self, v) -> int:
        self._vels.append(np.asarray(v, np.float64))
        return len(self._vels) - 1

    def add_bias(self, b) -> int:
        self._biases.append(np.asarray(b, np.float64))
        return len(self._biases) - 1

    def add_plane(self, plane4) -> int:
        """A plane landmark (n, d); the normal is scaled to unit length."""
        p = np.asarray(plane4, np.float64)
        self._planes.append(p / np.linalg.norm(p[:3]))
        return len(self._planes) - 1

    def add_point(self, p) -> int:
        self._points.append(np.asarray(p, np.float64))
        return len(self._points) - 1

    def _add_points(self, pts):
        """Many point landmarks at once, (N, 3), in the next N slots."""
        self._points.extend(np.asarray(pts, np.float64))

    @property
    def num_poses(self) -> int:
        return len(self._poses)

    def pose(self, idx: int):
        return self._poses[idx]

    # -- factors --------------------------------------------------------
    def _add(self, name, **row):
        self._tables[name].rows.append(row)

    def _add_rows(self, name, n, robust=None, **cols):
        """``n`` rows of table ``name`` at once from (n, ...) column arrays
        (a field left out keeps ``empty_table``'s value), none robust
        unless ``robust`` is set."""
        cols = {f: np.asarray(v) for f, v in cols.items()}
        cols["robust_kind"] = np.full(n, 0 if robust is None else 1)
        cols["robust_k"] = np.full(n, 1.0 if robust is None
                                   else float(robust))
        self._tables[name].add_block(n, cols)

    def add_prior_pose(self, idx: int, pose, robust=None, **noise):
        R, t = _as_Rt(pose)
        self._add("prior_pose", idx=idx, mean_R=R, mean_t=t,
                  sqrt_info=_sqrt_info(6, **noise), robust=robust)

    def add_between(self, i: int, j: int, pose, robust=None, **noise):
        R, t = _as_Rt(pose)
        self._add("between", i=i, j=j, meas_R=R, meas_t=t,
                  sqrt_info=_sqrt_info(6, **noise), robust=robust)

    def add_prior_vel(self, idx: int, mean, robust=None, **noise):
        self._add("prior_vel", idx=idx, mean=np.asarray(mean, np.float64),
                  sqrt_info=_sqrt_info(3, **noise), robust=robust)

    def add_prior_bias(self, idx: int, mean, robust=None, **noise):
        self._add("prior_bias", idx=idx, mean=np.asarray(mean, np.float64),
                  sqrt_info=_sqrt_info(6, **noise), robust=robust)

    def add_plane_factor(self, pose_idx: int, plane_idx: int, meas4,
                         robust=None, **noise):
        """OrientedPlane3Factor row: ``meas4`` is the plane seen in the body
        frame of ``pose_idx`` (normal scaled to unit length)."""
        m = np.asarray(meas4, np.float64)
        self._add("plane", pose_idx=pose_idx, plane_idx=plane_idx,
                  meas=m / np.linalg.norm(m[:3]),
                  sqrt_info=_sqrt_info(3, **noise), robust=robust)

    def add_imu_factor(self, i: int, j: int, preint, gravity, robust=None,
                       cov=None):
        """CombinedImuFactor row from a ``PreintState`` (tensors or numpy).

        ``gravity``: (3,) world gravity vector (from ``ImuParams``).
        ``cov`` overrides the preintegrated covariance if given; whitening is
        the inverse Cholesky factor of the 15x15 covariance.
        """
        def host(x):
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu()
            return np.asarray(x, np.float64)

        C = host(cov if cov is not None else preint.cov)
        C = 0.5 * (C + C.T)
        row = {f: host(getattr(preint, f)) for f in _IMU_FIELDS}
        row.update(i=i, j=j, dt=float(host(preint.dt)), gravity=host(gravity),
                   sqrt_info=np.linalg.inv(np.linalg.cholesky(C)),
                   robust=robust)
        self._add("imu", **row)

    def add_projection_factor(self, pose_idx: int, point_idx: int, uv,
                              cal, body_pose=None, sigma=1.0, robust=None):
        """GenericProjectionFactor<Pose3, Point3, Cal3DS2> row: ``cal`` is a
        Cal3DS2-like object (``Cal3DS2``, ``CameraIntrinsics``) or a 9-tuple
        (fx, fy, s, u0, v0, k1, k2, p1, p2); ``body_pose`` the body ->
        sensor extrinsic (identity if None); ``sigma`` the pixel sigma."""
        bR, bt = (np.eye(3), np.zeros(3)) if body_pose is None \
            else _as_Rt(body_pose)
        self._add("projection", pose_idx=pose_idx, point_idx=point_idx,
                  uv=np.asarray(uv, np.float64), cal=_cal9(cal), body_R=bR,
                  body_t=bt, sqrt_info=np.eye(2) / float(sigma),
                  robust=robust)

    def add_prior_point(self, idx: int, mean, robust=None, **noise):
        self._add("prior_point", idx=idx, mean=np.asarray(mean, np.float64),
                  sqrt_info=_sqrt_info(3, **noise), robust=robust)

    # -- freeze ----------------------------------------------------------
    def build(self, pose_cap=None, vel_cap=None, bias_cap=None,
              plane_cap=None, point_cap=None, factor_caps=None,
              bucket: int = 64, *, device=None, dtype=torch.float64):
        """Freeze to ``(FactorGraph, VariableArena)`` on ``device``/``dtype``
        (``device=None``: the CUDA card).

        Capacities follow the reference: a variable kind's given capacity is
        raised to its count (at least 1), else its count rounds up to the
        bucket; the pose arena always holds at least one slot and the other
        arenas have capacity ``*_cap or 0`` when nothing was added. A factor
        table has capacity 0 when empty and not named in ``factor_caps``,
        else ``factor_caps[name]`` (or the bucket-rounded count), raised to
        its count. Index, kind and count fields are int64 (torch's index
        type), masks bool, everything else ``dtype``.
        """
        device = resolve(device)
        fc = factor_caps or {}

        def up(x):
            return torch.as_tensor(np.asarray(x), device=device).to(dtype)

        def cap_for(n, given):
            if given is not None:
                return max(given, max(n, 1))
            return round_up(max(n, 1), bucket)

        def arena(rows, width, given, fill=None):
            cap = cap_for(len(rows), given) if rows else (given or 0)
            out = np.zeros((cap, width))
            if fill is not None:
                out[:] = fill
            if rows:
                out[:len(rows)] = np.asarray(rows).reshape(-1, width)
            return up(out)

        n = len(self._poses)
        cap = cap_for(n, pose_cap)
        pose_R = np.tile(np.eye(3), (cap, 1, 1))
        pose_t = np.zeros((cap, 3))
        if n:
            pose_R[:n] = np.asarray([R for R, _ in self._poses])
            pose_t[:n] = np.asarray([t for _, t in self._poses])

        def count(k):
            return torch.tensor(k, dtype=torch.int64, device=device)

        values = VariableArena(
            pose_R=up(pose_R), pose_t=up(pose_t),
            vel=arena(self._vels, 3, vel_cap),
            bias=arena(self._biases, 6, bias_cap),
            plane=arena(self._planes, 4, plane_cap,
                        fill=np.array([0.0, 0.0, 1.0, 0.0])),
            point=arena(self._points, 3, point_cap),
            num_poses=count(n), num_vels=count(len(self._vels)),
            num_biases=count(len(self._biases)),
            num_planes=count(len(self._planes)),
            num_points=count(len(self._points)),
        )

        def table_cap(name, n):
            if n == 0 and name not in fc:
                return 0
            return max(fc.get(name) or round_up(n, bucket), n)

        graph = FactorGraph(*(
            t.freeze(table_cap(name, len(t)), device, dtype)
            for name, t in self._tables.items()))
        return graph, values
