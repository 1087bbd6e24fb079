"""Host-side graph construction: append factors, freeze to padded tables
(port of ``graph/builder.py``).

Callers add poses, pose priors and between factors one by one in numpy;
``build()`` freezes them into the ``FactorGraph`` + ``VariableArena`` of
tensors on the requested device and dtype. Capacities round up to buckets,
as in the reference, so graphs keep the reference's padded shapes.

Ported: poses, ``add_prior_pose`` and ``add_between``. Velocities, biases,
planes, points and their factors are not ported yet (ROADMAP items B-D).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from .factors import (BetweenPoseTable, FactorGraph, ImuTable, PlaneTable,
                      PriorPointTable, PriorPoseTable, PriorVec3Table,
                      PriorVec6Table, ProjectionTable, empty_table)
from .variables import VariableArena

__all__ = ["GraphBuilder", "round_up"]


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


class GraphBuilder:
    def __init__(self):
        self._poses: list[tuple[np.ndarray, np.ndarray]] = []
        self._prior_pose: list[dict] = []
        self._between: list[dict] = []

    # -- variables -----------------------------------------------------
    def add_pose(self, pose) -> int:
        self._poses.append(_as_Rt(pose))
        return len(self._poses) - 1

    def set_pose(self, idx: int, pose):
        self._poses[idx] = _as_Rt(pose)

    @property
    def num_poses(self) -> int:
        return len(self._poses)

    def pose(self, idx: int):
        return self._poses[idx]

    # -- factors --------------------------------------------------------
    def add_prior_pose(self, idx: int, pose, robust=None, **noise):
        R, t = _as_Rt(pose)
        self._prior_pose.append(dict(a=idx, R=R, t=t, S=_sqrt_info(6, **noise),
                                     robust=robust))

    def add_between(self, i: int, j: int, pose, robust=None, **noise):
        R, t = _as_Rt(pose)
        self._between.append(dict(a=i, b=j, R=R, t=t, S=_sqrt_info(6, **noise),
                                  robust=robust))

    # -- freeze ----------------------------------------------------------
    def build(self, bucket: int = 64, *, device=None, dtype=torch.float64):
        """Freeze to ``(FactorGraph, VariableArena)`` on ``device``/``dtype``
        (``device=None``: the CUDA card).

        Index, kind and count fields are int64 (torch's index type), masks
        are bool, everything else ``dtype``; numpy builds the padded arrays
        in float64 and each is cast once on upload.
        """
        device = resolve(device)

        def up(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), device=device).to(dt)

        n = len(self._poses)
        cap = round_up(max(n, 1), bucket)
        pose_R = np.tile(np.eye(3), (cap, 1, 1))
        pose_t = np.zeros((cap, 3))
        for i, (R, t) in enumerate(self._poses):
            pose_R[i], pose_t[i] = R, t

        def count(k):
            return torch.tensor(k, dtype=torch.int64, device=device)

        def zeros(*shape):
            return torch.zeros(*shape, dtype=dtype, device=device)

        values = VariableArena(
            pose_R=up(pose_R), pose_t=up(pose_t), vel=zeros(0, 3),
            bias=zeros(0, 6), plane=zeros(0, 4), point=zeros(0, 3),
            num_poses=count(n), num_vels=count(0), num_biases=count(0),
            num_planes=count(0), num_points=count(0),
        )

        def freeze(rows):
            """Padded columns of a pose-factor table: capacity 0 when empty,
            else the bucket-rounded count; padding rows are inactive
            identities with zero sqrt-information."""
            k = len(rows)
            c = round_up(k, bucket) if k else 0
            a = np.zeros(c, np.int64)
            b = np.zeros(c, np.int64)
            R = np.tile(np.eye(3), (c, 1, 1))
            t = np.zeros((c, 3))
            S = np.zeros((c, 6, 6))
            kind = np.zeros(c, np.int64)
            kval = np.ones(c)
            for r, row in enumerate(rows):
                a[r], b[r] = row["a"], row.get("b", 0)
                R[r], t[r], S[r] = row["R"], row["t"], row["S"]
                if row["robust"] is not None:
                    kind[r], kval[r] = 1, float(row["robust"])
            active = np.arange(c) < k
            return (up(a, torch.int64), up(b, torch.int64), up(R), up(t),
                    up(S), up(kind, torch.int64), up(kval),
                    up(active, torch.bool))

        idx, _, R, t, S, kind, kval, active = freeze(self._prior_pose)
        prior_pose = PriorPoseTable(idx, R, t, S, kind, kval, active)
        i, j, R, t, S, kind, kval, active = freeze(self._between)
        between = BetweenPoseTable(i, j, R, t, S, kind, kval, active)

        def empty(typ):
            return empty_table(typ, dtype=dtype, device=device)

        graph = FactorGraph(
            prior_pose=prior_pose, between=between,
            prior_vel=empty(PriorVec3Table), prior_bias=empty(PriorVec6Table),
            plane=empty(PlaneTable), imu=empty(ImuTable),
            projection=empty(ProjectionTable),
            prior_point=empty(PriorPointTable),
        )
        return graph, values
