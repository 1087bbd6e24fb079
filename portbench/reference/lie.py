"""SO(3) and SE(3) in plain torch for the benchmark's references.

Tangent order (omega, v), rotation first; a pose is (R, t) and moves by
``X * Exp(xi)``. Every function is smooth at the identity under forward
differentiation: small angles take Taylor series, and the closed forms
see a safe argument there ("double where"), so the references take their
Jacobians by forward differentiation of the residuals (``linearize``)
instead of closed forms of their own.
"""

from __future__ import annotations

import math

import torch

_SERIES_TH2 = 0.01   # theta^2 below which the Taylor series are taken


def _series(x, coefs):
    out = torch.full_like(x, coefs[-1])
    for a in coefs[-2::-1]:
        out = out * x + a
    return out


# in powers of theta^2, five terms each (truncation < 1e-19 at 0.01)
_A = [(-1) ** k / math.factorial(2 * k + 1) for k in range(5)]
_B = [(-1) ** k / math.factorial(2 * k + 2) for k in range(5)]
_C = [(-1) ** k / math.factorial(2 * k + 3) for k in range(5)]
_D = [1 / 12, 1 / 720, 1 / 30240, 1 / 1209600, 1 / 47900160]
# theta / sin(theta) in powers of sin^2, for sin^2 below 1e-4
_F = [1.0, 1 / 6, 3 / 40, 5 / 112, 35 / 1152]


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _coeffs(th2):
    """(sin th / th, (1 - cos th) / th^2, (th - sin th) / th^3)."""
    small = th2 < _SERIES_TH2
    s2 = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(s2)
    a = torch.where(small, _series(th2, _A), torch.sin(th) / th)
    b = torch.where(small, _series(th2, _B), (1.0 - torch.cos(th)) / s2)
    c = torch.where(small, _series(th2, _C),
                    (th - torch.sin(th)) / (s2 * th))
    return a, b, c


def so3_exp(w):
    W = hat(w)
    a, b, _ = _coeffs(torch.sum(w * w, -1))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_left_jacobian(w):
    W = hat(w)
    _, b, c = _coeffs(torch.sum(w * w, -1))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + b[..., None, None] * W + c[..., None, None] * (W @ W)


def so3_log(R):
    """Rotation vector of R; loses digits near pi (the residuals here are
    small rotations)."""
    s = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                           R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    cos = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
    n2 = torch.sum(s * s, -1)          # sin(theta)^2
    small = (n2 < 1e-4) & (cos > 0)
    safe = torch.where(small, torch.ones_like(n2), n2)
    sn = torch.sqrt(safe)
    f = torch.where(small, _series(n2, _F), torch.atan2(sn, cos) / sn)
    return f[..., None] * s


def so3_left_jacobian_inverse(w):
    """Jl(w)^-1 = I - W/2 + (1/th^2 - (1 + cos)/(2 th sin)) W^2."""
    W = hat(w)
    th2 = torch.sum(w * w, -1)
    small = th2 < _SERIES_TH2
    s2 = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(s2)
    d = torch.where(small, _series(th2, _D),
                    1.0 / s2 - (1.0 + torch.cos(th)) / (2.0 * th
                                                         * torch.sin(th)))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye - 0.5 * W + d[..., None, None] * (W @ W)


def mv(A, x):
    return (A @ x[..., None])[..., 0]


def compose(Ra, ta, Rb, tb):
    return Ra @ Rb, mv(Ra, tb) + ta


def inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -mv(Rt, t)


def se3_exp(xi):
    w, v = xi[..., :3], xi[..., 3:]
    return so3_exp(w), mv(so3_left_jacobian(w), v)


def se3_log(R, t):
    w = so3_log(R)
    return torch.cat([w, mv(so3_left_jacobian_inverse(w), t)], -1)


def retract(R, t, xi):
    """X * Exp(xi)."""
    Re, te = se3_exp(xi)
    return compose(R, t, Re, te)


def linearize(fn, width, *rows):
    """Residuals (F, m) and Jacobians (F, m, width) of ``fn(xi, *rows)`` at
    xi = 0, xi (F, width) one tangent per row, by forward-mode
    differentiation: one pass per tangent direction, all rows at once."""
    import torch.autograd.forward_ad as fwAD

    x0 = rows[0]
    xi = torch.zeros(x0.shape[0], width, dtype=x0.dtype, device=x0.device)
    cols = []
    with fwAD.dual_level():
        for k in range(width):
            e = torch.zeros_like(xi)
            e[:, k] = 1.0
            r, dr = fwAD.unpack_dual(fn(fwAD.make_dual(xi, e), *rows))
            cols.append(dr)
    return r, torch.stack(cols, -1)
