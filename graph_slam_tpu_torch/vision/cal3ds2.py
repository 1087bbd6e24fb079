"""Cal3DS2 camera model: pinhole + radial-tangential distortion (port of
``vision/cal3ds2.py``).

GTSAM ``Cal3DS2`` semantics. Every function broadcasts over leading batch
axes; a ``Cal3DS2`` whose fields are (F,) tensors is F cameras at once.

``project_point_jacobian`` is the closed-form derivative of
``project_point`` with respect to the camera-frame point, through both of
its clamps: zero through a clamped depth, the radius scale's own
derivative beyond a normalized radius of 100. The clamp is taken on the
squared radius, so the derivative is finite on the optical axis, where
the reference's autodiff through ``norm`` at 0 is NaN.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve

__all__ = ["Cal3DS2", "uncalibrate", "project_point",
           "project_point_jacobian"]

Tensor = torch.Tensor

_Z_MIN = 1e-6      # depth clamp
_RAD_MAX = 100.0   # normalized-radius clamp


class Cal3DS2(NamedTuple):
    """Intrinsics: (fx, fy, s, u0, v0, k1, k2, p1, p2) tensors."""

    fx: Tensor
    fy: Tensor
    s: Tensor
    u0: Tensor
    v0: Tensor
    k1: Tensor
    k2: Tensor
    p1: Tensor
    p2: Tensor

    @classmethod
    def make(cls, fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, s=0.0,
             *, dtype=torch.float64, device=None):
        device = resolve(device)

        def a(v):
            return torch.as_tensor(v, dtype=dtype, device=device)

        return cls(a(fx), a(fy), a(s), a(cx), a(cy), a(k1), a(k2), a(p1),
                   a(p2))

    @classmethod
    def from_rows(cls, cal: Tensor) -> "Cal3DS2":
        """(..., 9) packed rows (a projection table's ``cal``) -> Cal3DS2."""
        return cls(*cal.unbind(-1))


def uncalibrate(K: Cal3DS2, p):
    """Normalized image point (x, y) -> distorted pixel (u, v).

    GTSAM Cal3DS2::uncalibrate: radial (1 + k1 r^2 + k2 r^4) + tangential.
    """
    x, y = p[..., 0], p[..., 1]
    xy = x * y
    xx = x * x
    yy = y * y
    r2 = xx + yy
    g = 1.0 + K.k1 * r2 + K.k2 * r2 * r2
    dx = 2.0 * K.p1 * xy + K.p2 * (r2 + 2.0 * xx)
    dy = 2.0 * K.p2 * xy + K.p1 * (r2 + 2.0 * yy)
    px = g * x + dx
    py = g * y + dy
    u = K.fx * px + K.s * py + K.u0
    v = K.fy * py + K.v0
    return torch.stack([u, v], dim=-1)


def _normalized(p_cam):
    """The clamped normalized point and what its derivative needs:
    (n, z_ok, zs, r2, far), n = (x, y) / max(z, 1e-6) scaled to a radius of
    at most 100."""
    z = p_cam[..., 2]
    z_ok = z > _Z_MIN
    zs = torch.where(z_ok, z, torch.full_like(z, _Z_MIN))
    n = p_cam[..., :2] / zs[..., None]
    r2 = torch.sum(n * n, dim=-1)
    far = r2 > _RAD_MAX * _RAD_MAX
    scale = torch.where(far, _RAD_MAX / torch.sqrt(torch.where(
        far, r2, torch.ones_like(r2))), torch.ones_like(r2))
    return n * scale[..., None], z_ok, zs, r2, far


def project_point(K: Cal3DS2, p_cam):
    """Camera-frame 3D point -> pixel, with the depth clamped at 1e-6 (the
    factor masks cheirality failures) and the normalized radius at 100 (a
    point driven behind a camera by one bad step stays finite in float32)."""
    return uncalibrate(K, _normalized(p_cam)[0])


def project_point_jacobian(K: Cal3DS2, p_cam):
    """(uv (..., 2), d uv / d p_cam (..., 2, 3)) of ``project_point``."""
    m, z_ok, zs, r2, far = _normalized(p_cam)
    x, y = m[..., 0], m[..., 1]
    mr2 = x * x + y * y
    g = 1.0 + K.k1 * mr2 + K.k2 * mr2 * mr2
    dg = K.k1 + 2.0 * K.k2 * mr2          # dg / d(r^2)
    px_x = g + 2.0 * x * x * dg + 2.0 * K.p1 * y + 6.0 * K.p2 * x
    px_y = 2.0 * x * y * dg + 2.0 * K.p1 * x + 2.0 * K.p2 * y
    py_x = 2.0 * x * y * dg + 2.0 * K.p2 * y + 2.0 * K.p1 * x
    py_y = g + 2.0 * y * y * dg + 2.0 * K.p2 * x + 6.0 * K.p1 * y
    D = torch.stack([
        torch.stack([K.fx * px_x + K.s * py_x, K.fx * px_y + K.s * py_y], -1),
        torch.stack([K.fy * py_x, K.fy * py_y], -1)], -2)   # d uv / d m

    # d m / d n: identity inside the radius clamp, 100/r (I - u u^T) beyond
    eye2 = torch.eye(2, dtype=m.dtype, device=m.device)
    n = p_cam[..., :2] / zs[..., None]
    r2s = torch.where(far, r2, torch.ones_like(r2))
    c = (_RAD_MAX / torch.sqrt(r2s))[..., None, None]
    Dm = torch.where(far[..., None, None],
                     c * (eye2 - n[..., :, None] * n[..., None, :]
                          / r2s[..., None, None]), eye2)
    # d n / d p_cam, zero through a clamped depth
    inv_z = 1.0 / zs
    dz = torch.where(z_ok, -inv_z, torch.zeros_like(inv_z))
    zero = torch.zeros_like(inv_z)
    Dn = torch.stack([
        torch.stack([inv_z, zero, dz * n[..., 0]], -1),
        torch.stack([zero, inv_z, dz * n[..., 1]], -1)], -2)
    return uncalibrate(K, m), D @ Dm @ Dn
