"""Host-side graph construction: append factors, freeze to padded tables
(port of ``graph/builder.py``).

Callers add variables and factors one by one in numpy; ``build()`` freezes
them into the ``FactorGraph`` + ``VariableArena`` of tensors on the
requested device and dtype. Capacities round up to buckets, as in the
reference, so graphs keep the reference's padded shapes.

Ported: poses, velocities and biases with their priors, between factors
and CombinedImuFactor rows. Planes, points and their factors are not
ported yet (ROADMAP items C-D).
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


def _freeze(table_type, rows, bucket, device, dtype):
    """Padded table from row dicts keyed by field name (plus ``robust``):
    capacity 0 when empty, else the bucket-rounded count; padding rows keep
    ``empty_table``'s inactive defaults. numpy builds the columns in
    float64 and each is cast once on upload."""
    n = len(rows)
    cap = round_up(n, bucket) if n else 0
    cols = {f: t.numpy().copy() for f, t in zip(
        table_type._fields, empty_table(table_type, cap, device="cpu"))}
    for r, row in enumerate(rows):
        for f, v in row.items():
            if f != "robust":
                cols[f][r] = v
            elif v is not None:
                cols["robust_kind"][r], cols["robust_k"][r] = 1, float(v)
    cols["active"][:n] = True

    def up(a):
        t = torch.as_tensor(a, device=device)
        return t.to(dtype) if t.is_floating_point() else t

    return table_type(**{f: up(a) for f, a in cols.items()})


class GraphBuilder:
    def __init__(self):
        self._poses: list[tuple[np.ndarray, np.ndarray]] = []
        self._vels: list[np.ndarray] = []
        self._biases: list[np.ndarray] = []
        self._rows = {name: [] for name in TABLE_TYPES}

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

    @property
    def num_poses(self) -> int:
        return len(self._poses)

    def pose(self, idx: int):
        return self._poses[idx]

    # -- factors --------------------------------------------------------
    def add_prior_pose(self, idx: int, pose, robust=None, **noise):
        R, t = _as_Rt(pose)
        self._rows["prior_pose"].append(dict(
            idx=idx, mean_R=R, mean_t=t, sqrt_info=_sqrt_info(6, **noise),
            robust=robust))

    def add_between(self, i: int, j: int, pose, robust=None, **noise):
        R, t = _as_Rt(pose)
        self._rows["between"].append(dict(
            i=i, j=j, meas_R=R, meas_t=t, sqrt_info=_sqrt_info(6, **noise),
            robust=robust))

    def add_prior_vel(self, idx: int, mean, robust=None, **noise):
        self._rows["prior_vel"].append(dict(
            idx=idx, mean=np.asarray(mean, np.float64),
            sqrt_info=_sqrt_info(3, **noise), robust=robust))

    def add_prior_bias(self, idx: int, mean, robust=None, **noise):
        self._rows["prior_bias"].append(dict(
            idx=idx, mean=np.asarray(mean, np.float64),
            sqrt_info=_sqrt_info(6, **noise), robust=robust))

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
        self._rows["imu"].append(row)

    # -- freeze ----------------------------------------------------------
    def build(self, bucket: int = 64, *, device=None, dtype=torch.float64):
        """Freeze to ``(FactorGraph, VariableArena)`` on ``device``/``dtype``
        (``device=None``: the CUDA card).

        Index, kind and count fields are int64 (torch's index type), masks
        are bool, everything else ``dtype``. The pose arena holds at least
        one bucket; the velocity and bias arenas have capacity 0 when no
        such variable was added.
        """
        device = resolve(device)

        def up(x):
            return torch.as_tensor(np.asarray(x), device=device).to(dtype)

        def arena(rows, width):
            cap = round_up(len(rows), bucket) if rows else 0
            out = np.zeros((cap, width))
            out[:len(rows)] = np.reshape(rows, (-1, width))
            return up(out)

        n = len(self._poses)
        cap = round_up(max(n, 1), bucket)
        pose_R = np.tile(np.eye(3), (cap, 1, 1))
        pose_t = np.zeros((cap, 3))
        for i, (R, t) in enumerate(self._poses):
            pose_R[i], pose_t[i] = R, t

        def count(k):
            return torch.tensor(k, dtype=torch.int64, device=device)

        values = VariableArena(
            pose_R=up(pose_R), pose_t=up(pose_t), vel=arena(self._vels, 3),
            bias=arena(self._biases, 6),
            plane=torch.zeros(0, 4, dtype=dtype, device=device),
            point=torch.zeros(0, 3, dtype=dtype, device=device),
            num_poses=count(n), num_vels=count(len(self._vels)),
            num_biases=count(len(self._biases)), num_planes=count(0),
            num_points=count(0),
        )
        graph = FactorGraph(*(
            _freeze(typ, self._rows[name], bucket, device, dtype)
            for name, typ in TABLE_TYPES.items()))
        return graph, values
