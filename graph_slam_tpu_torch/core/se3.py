"""SE(3) Lie-group operations on torch tensors (port of ``core/se3.py``).

Tangent ordering is GTSAM's: ``xi = (omega, v)``, rotation first. Poses are
stored struct-of-arrays as ``Pose(R, t)`` with ``R: (..., 3, 3)`` and
``t: (..., 3)``; every function broadcasts over the leading batch axes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import so3
from ..device import resolve

__all__ = ["Pose", "identity", "from_matrix", "to_matrix", "compose",
           "inverse", "expmap", "logmap", "adjoint", "transform_from",
           "transform_to", "between", "retract", "local",
           "left_jacobian_inverse", "right_jacobian_inverse"]


class Pose(NamedTuple):
    """SE(3) element(s): rotation matrix block and translation block."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    def __matmul__(self, other: "Pose") -> "Pose":
        return compose(self, other)

    def inv(self) -> "Pose":
        return inverse(self)

    @property
    def batch_shape(self):
        return self.t.shape[:-1]


def identity(batch_shape=(), *, dtype=torch.float64, device=None) -> Pose:
    device = resolve(device)
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
    return Pose(R.clone(), torch.zeros(*batch_shape, 3, dtype=dtype,
                                       device=device))


def from_matrix(T) -> Pose:
    """(..., 4, 4) homogeneous matrices -> Pose (views of ``T``)."""
    return Pose(T[..., :3, :3], T[..., :3, 3])


def to_matrix(p: Pose):
    """Pose -> (..., 4, 4) homogeneous matrices."""
    top = torch.cat([p.R, p.t[..., :, None]], dim=-1)
    bottom = torch.zeros(*p.t.shape[:-1], 1, 4, dtype=p.t.dtype,
                         device=p.t.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def _mv(A, x):
    """Batched matrix-vector product ``A @ x``."""
    return (A @ x[..., None])[..., 0]


def compose(a: Pose, b: Pose) -> Pose:
    return Pose(a.R @ b.R, _mv(a.R, b.t) + a.t)


def inverse(p: Pose) -> Pose:
    Rt = p.R.transpose(-1, -2)
    return Pose(Rt, -_mv(Rt, p.t))


def between(a: Pose, b: Pose) -> Pose:
    """GTSAM ``a.between(b) = a^-1 * b``."""
    return compose(inverse(a), b)


def transform_from(p: Pose, pt):
    """Body -> world point transform (GTSAM ``transform_from``)."""
    return _mv(p.R, pt) + p.t


def transform_to(p: Pose, pt):
    """World -> body point transform (GTSAM ``transform_to``)."""
    return _mv(p.R.transpose(-1, -2), pt - p.t)


def expmap(xi) -> Pose:
    """SE(3) exponential: ``xi = (omega, v)`` -> Pose (Pose3::Expmap)."""
    w = xi[..., :3]
    v = xi[..., 3:]
    return Pose(so3.expmap(w), _mv(so3.left_jacobian(w), v))


def logmap(p: Pose):
    """SE(3) logarithm: Pose -> ``(omega, v)`` (Pose3::Logmap)."""
    w = so3.logmap(p.R)
    v = _mv(so3.left_jacobian_inverse(w), p.t)
    return torch.cat([w, v], dim=-1)


def retract(p: Pose, xi) -> Pose:
    """Manifold retraction ``p * Expmap(xi)``."""
    return compose(p, expmap(xi))


def local(p: Pose, q: Pose):
    """Chart inverse: ``Logmap(p^-1 q)``."""
    return logmap(between(p, q))


# Taylor coefficients in theta^2 of Q's three scalars (k = 0..6):
#   c1 = (theta - sin)/theta^3            = sum (-1)^k theta^2k / (2k+3)!
#   c2 = (theta^2 + 2 cos - 2)/(2 theta^4) = sum (-1)^k theta^2k / (2k+4)!
#   c3 = (2 theta - 3 sin + theta cos)/(2 theta^5)
#                                         = sum (-1)^k (k+1) theta^2k / (2k+5)!
_Q_SERIES = tuple(
    tuple((-1) ** k * (k + 1 if c == 3 else 1) / math.factorial(2 * k + 2 + c)
          for k in range(7))
    for c in (1, 2, 3))
# below this theta^2 the closed forms cancel: c2's and c3's numerators are
# differences of O(1) terms, so their error grows as eps / theta^4 (4e-14
# at theta = 0.2, 1e-12 at 0.1, 8470 instead of 1/120 in c3 at 1e-5);
# the series, seven terms, is exact to rounding up to theta = 0.5
# (truncation < 1e-17 there), and the closed forms beyond (< 1e-15)
_Q_SERIES_MAX_THETA2 = 0.25


def _q_coeffs(theta2):
    """(c1, c2, c3) of Barfoot's Q at squared angle ``theta2``: the Taylor
    series below ``_Q_SERIES_MAX_THETA2``, the closed forms above."""
    small = theta2 <= _Q_SERIES_MAX_THETA2
    one = torch.ones_like(theta2)
    theta = torch.sqrt(torch.where(small, one, theta2))
    th2 = torch.where(small, one, theta2)
    s, c = torch.sin(theta), torch.cos(theta)
    closed = ((theta - s) / (th2 * theta),
              (th2 + 2.0 * c - 2.0) / (2.0 * th2 * th2),
              (2.0 * theta - 3.0 * s + theta * c) / (2.0 * th2 * th2 * theta))
    out = []
    for coefs, exact in zip(_Q_SERIES, closed):
        series = torch.full_like(theta2, coefs[-1])
        for a in coefs[-2::-1]:
            series = series * theta2 + a
        out.append(torch.where(small, series, exact))
    return tuple(out)


def _q_left(xi):
    """Barfoot's Q matrix of the SE(3) left Jacobian (eq. 7.86).

    Its coefficients come from ``_q_coeffs``. The reference takes the
    closed forms down to theta^2 = 1e-12 and loses precision between
    theta = 1e-6 and ~1e-2; this port does not copy that.
    """
    w = xi[..., :3]
    v = xi[..., 3:]
    W = so3.hat(w)
    V = so3.hat(v)
    c1, c2, c3 = _q_coeffs(torch.sum(w * w, dim=-1))
    WV = W @ V
    VW = V @ W
    WVW = WV @ W
    W2 = W @ W
    c1 = c1[..., None, None]
    c2 = c2[..., None, None]
    c3 = c3[..., None, None]
    return (0.5 * V + c1 * (WV + VW + W @ VW)
            + c2 * (W2 @ V + V @ W2 - 3.0 * WVW)
            + c3 * (WVW @ W + W @ WVW))


def left_jacobian_inverse(xi):
    """Inverse SE(3) left Jacobian (6x6), tangent ordering (omega, v)."""
    Jli = so3.left_jacobian_inverse(xi[..., :3])
    Q = _q_left(xi)
    top = torch.cat([Jli, torch.zeros_like(Jli)], dim=-1)
    bot = torch.cat([-Jli @ Q @ Jli, Jli], dim=-1)
    return torch.cat([top, bot], dim=-2)


def right_jacobian_inverse(xi):
    """Inverse SE(3) right Jacobian: Jr^-1(xi) = Jl^-1(-xi)."""
    return left_jacobian_inverse(-xi)


def adjoint(p: Pose):
    """GTSAM ``Pose3::AdjointMap``: ``[[R, 0], [hat(t) R, R]]``."""
    Z = torch.zeros_like(p.R)
    tR = so3.hat(p.t) @ p.R
    top = torch.cat([p.R, Z], dim=-1)
    bot = torch.cat([tR, p.R], dim=-1)
    return torch.cat([top, bot], dim=-2)
