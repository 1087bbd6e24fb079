"""Gyro -> Euler-angle dead reckoning, the CGyroEuler twin (port of
``imu/euler.py``).

Reference (``gtsam/gyro_euler.{h,cpp}``): integer gyro readings are
bias-corrected with a static pre-sync window (``gyro_euler.cpp:51-66``)
and integrated through the body-rate -> Euler-rate transform
(``:85-114``). The reference's ``lax.scan`` is a host loop of one small
step a sample here, with torch's own sine and cosine (the reference's
``core/trig.py`` exists for the TPU's and XLA CPU's inexact float64
trigonometry).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve

__all__ = ["gyro_bias_from_static", "body_rates_to_euler_rates",
           "integrate_euler"]


def gyro_bias_from_static(gyr, n_static: int):
    """Bias = mean body rate over the static pre-sync samples."""
    return np.asarray(gyr)[:n_static].mean(axis=0)


def body_rates_to_euler_rates(rpy, w):
    """Body angular velocity -> (roll, pitch, yaw) rates (tensors).

    [dphi, dtheta, dpsi] = E(roll, pitch) @ w with the standard ZYX
    kinematic matrix (gyro_euler.cpp:85-114).
    """
    r, p = rpy[..., 0], rpy[..., 1]
    sr, cr = torch.sin(r), torch.cos(r)
    sp, cp = torch.sin(p), torch.cos(p)
    tp = sp / cp
    E = torch.stack([
        torch.stack([torch.ones_like(r), sr * tp, cr * tp], dim=-1),
        torch.stack([torch.zeros_like(r), cr, -sr], dim=-1),
        torch.stack([torch.zeros_like(r), sr / cp, cr / cp], dim=-1),
    ], dim=-2)
    return (E @ w[..., None])[..., 0]


def integrate_euler(gyr, dt, bias=None, rpy0=None, *, device=None,
                    dtype=torch.float64):
    """Dead-reckon (roll, pitch, yaw) over a gyro stream.

    gyr: (N, 3) rad/s; dt: scalar or (N,). Tensors stay on their device;
    host arrays go to ``device`` (``None``: the card) in ``dtype``.
    Returns (N, 3) Euler angles.
    """
    def t(x, dev):
        if isinstance(x, torch.Tensor):
            return x.to(dev, dtype)
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    dev = gyr.device if isinstance(gyr, torch.Tensor) else resolve(device)
    gyr = t(gyr, dev)
    n = gyr.shape[0]
    dt = torch.broadcast_to(t(dt, dev), (n,))
    if bias is not None:
        gyr = gyr - t(bias, dev)
    rpy = torch.zeros(3, dtype=dtype, device=dev) if rpy0 is None \
        else t(rpy0, dev)
    out = []
    for k in range(n):
        rpy = rpy + body_rates_to_euler_rates(rpy, gyr[k]) * dt[k]
        out.append(rpy)
    return torch.stack(out) if out else gyr.new_zeros((0, 3))
