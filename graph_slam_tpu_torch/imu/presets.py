"""IMU noise presets: VN-100 @200Hz and raw MEMS @100Hz (port of
``imu/presets.py``).

- VN-100: gyro noise density 0.0035 deg/s/sqrt(Hz), accel 0.14 mg/sqrt(Hz),
  gyro bias stability 10 deg/hr * sqrt(fps), accel bias 0.04 mg * sqrt(fps),
  integration error 1e-4, initial bias uncertainty 1e-3.
- MEMS: 3.6 deg ARW -> sigma D2R(3.6)/60, accel 0.1/60, integration 1e-4,
  bias RW 1e-8, init 1e-5; raw integer LSB conversions gyro ``i*80/1092``
  deg/s and accel ``i*0.002522*9.81`` m/s^2.

Each preset builds its tensors on ``device`` (``None``: the CUDA card).
"""

from __future__ import annotations

import math

import torch

from ..device import resolve
from .preintegration import ImuParams

__all__ = ["vn100_params", "mems_params", "VN100_DT", "MEMS_DT",
           "mems_gyro_lsb_to_rad", "mems_accel_lsb_to_ms2"]

_G = 9.81
VN100_DT = 1.0 / 200.0
MEMS_DT = 1.0 / 100.0


def _d2r(d):
    return d * math.pi / 180.0


def _params(acc_var, gyr_var, bacc_var, bgyr_var, init_var, gravity, dtype,
            device) -> ImuParams:
    device = resolve(device)

    def iso(v, n=3):
        return torch.eye(n, dtype=dtype, device=device) * v

    return ImuParams(
        accel_cov=iso(acc_var), gyro_cov=iso(gyr_var),
        integration_cov=iso(1e-4), bias_acc_cov=iso(bacc_var),
        bias_omega_cov=iso(bgyr_var), bias_acc_omega_init=iso(init_var, 6),
        gravity=torch.tensor(gravity, dtype=dtype, device=device))


def vn100_params(fps: float = 200.0, gravity=(0.0, 0.0, -_G), *,
                 dtype=torch.float64, device=None) -> ImuParams:
    accel_noise_sigma = 0.14e-3 * _G
    gyro_noise_sigma = _d2r(0.0035)
    accel_bias_rw_sigma = (0.04e-3 * _G) * math.sqrt(fps)
    gyro_bias_rw_sigma = (_d2r(10.0) / 3600.0) * math.sqrt(fps)
    return _params(accel_noise_sigma**2, gyro_noise_sigma**2,
                   accel_bias_rw_sigma**2, gyro_bias_rw_sigma**2, 1e-3,
                   gravity, dtype, device)


def mems_params(gravity=(0.0, 0.0, -_G), *, dtype=torch.float64,
                device=None) -> ImuParams:
    gyro_sigma = _d2r(3.6) / 60.0   # angular random walk
    accel_sigma = 0.1 / 60.0        # spec approximation
    return _params(accel_sigma**2, gyro_sigma**2, 1e-8, 1e-8, 1e-5, gravity,
                   dtype, device)


def mems_gyro_lsb_to_rad(i):
    """Raw integer gyro LSB -> rad/s."""
    return (i * 80.0 / 1092.0) * math.pi / 180.0


def mems_accel_lsb_to_ms2(i):
    """Raw integer accel LSB -> m/s^2."""
    return i * 0.002522 * _G
