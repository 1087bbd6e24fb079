"""Fixed extrinsic transforms: world<->origin and IMU<->camera (port of
``core/extrinsics.py``).

Both rotations are composed as ``RzRyRx(a, 0, c) @ RzRyRx(pitch, 0, 0)``
with the reference's angle choices; the pitch compensates the camera's
mounting tilt. Each function builds its pose on ``device`` (``None``: the
CUDA card).
"""

from __future__ import annotations

import math

import torch

from ..device import resolve
from . import se3, so3

__all__ = ["world_to_original", "camera_to_imu", "camera_to_imu_translation"]

_HALF_PI = math.pi / 2.0


def _composed(a: float, c: float, pitch_rad: float, dtype, device) -> se3.Pose:
    def s(x):
        return torch.tensor(x, dtype=dtype, device=device)

    R_g2b = so3.rzryrx(s(a), s(0.0), s(c))
    R_b2o = so3.rzryrx(s(pitch_rad), s(0.0), s(0.0))
    return se3.Pose(R_g2b @ R_b2o, torch.zeros(3, dtype=dtype, device=device))


def world_to_original(pitch_rad: float = 0.0, *, dtype=torch.float64,
                      device=None) -> se3.Pose:
    """T_w2o: camera-optical frame (z forward, y down) -> z-up world frame."""
    return _composed(-_HALF_PI, -_HALF_PI, pitch_rad, dtype, resolve(device))


def camera_to_imu(pitch_rad: float = 0.0, *, dtype=torch.float64,
                  device=None) -> se3.Pose:
    """T_u2c: camera optical frame -> IMU body frame (x fwd, y right, z down)."""
    return _composed(_HALF_PI, _HALF_PI, pitch_rad, dtype, resolve(device))


def camera_to_imu_translation(px, py, pz, *, dtype=torch.float64,
                              device=None) -> se3.Pose:
    """Translation-only camera->IMU extrinsic (the RS435 variant)."""
    device = resolve(device)
    return se3.Pose(torch.eye(3, dtype=dtype, device=device),
                    torch.tensor([px, py, pz], dtype=dtype, device=device))
