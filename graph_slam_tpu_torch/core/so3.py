"""SO(3) Lie-group operations on torch tensors (port of ``core/so3.py``).

Conventions match GTSAM 4.0 ``Rot3``. All functions broadcast over
leading batch dimensions. Small-angle branches use the same Taylor guards
and thresholds as the JAX reference, selected with ``torch.where``.

``graph_slam_tpu/core/trig.py`` is not ported: it exists because XLA's CPU
float64 ``sin``/``cos`` are only ~1e-8 accurate. ``torch.sin``/``torch.cos``
are accurate to rounding, which the parity tests check; ``1 - cos`` keeps
the cancellation-free form ``2 sin^2(x/2)``.
"""

from __future__ import annotations

import torch

__all__ = [
    "hat",
    "vee",
    "expmap",
    "logmap",
    "left_jacobian",
    "left_jacobian_inverse",
    "quat_to_matrix",
    "matrix_to_quat",
    "rzryrx",
    "rpy",
]

_SMALL = 1e-10  # theta^2 threshold below which Taylor expansions are used


def _one_minus_cos(x):
    s = torch.sin(0.5 * x)
    return 2.0 * s * s


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        *like.shape[:-1], 3, 3)


def hat(w):
    """3-vector -> skew-symmetric matrix, so3 hat operator."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    """Skew-symmetric matrix -> 3-vector (inverse of :func:`hat`)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta2):
    """Return (sin(t)/t, (1-cos(t))/t^2) with Taylor guards."""
    big = theta2 > _SMALL
    theta = torch.sqrt(torch.where(big, theta2, torch.ones_like(theta2)))
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, _one_minus_cos(theta) / theta2, 0.5 - theta2 / 24.0)
    return a, b


def expmap(w):
    """SO(3) exponential map (Rodrigues): angle-axis -> rotation matrix."""
    theta2 = torch.sum(w * w, dim=-1)
    a, b = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    return _eye3(w) + a[..., None, None] * W + b[..., None, None] * W2


def logmap(R):
    """SO(3) logarithm: rotation matrix -> angle-axis 3-vector.

    Same branches as the reference: a Taylor form near 0, the generic
    ``theta / (2 sin theta)`` scaling, and an axis-from-diagonal form near pi.
    """
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin2_theta = 0.25 * torch.sum(v * v, dim=-1)
    use_taylor = cos_theta > 1.0 - 1e-6
    near_pi = cos_theta < -1.0 + 1e-7
    cos_safe = torch.where(use_taylor | near_pi, torch.zeros_like(cos_theta),
                           cos_theta)
    theta_g = torch.arccos(cos_safe)
    scale_g = theta_g / (2.0 * torch.sin(theta_g))
    scale_t = 0.5 + sin2_theta / 12.0 + sin2_theta * sin2_theta * (7.0 / 720.0)
    scale = torch.where(use_taylor, scale_t, scale_g)
    w_generic = scale[..., None] * v
    theta = torch.arccos(cos_theta)

    # near pi: R + I = 2 a a^T, so |a_i| = sqrt((R_ii + 1) / 2); signs from
    # the off-diagonals anchored at the largest component
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    k = torch.argmax(axis_abs, dim=-1)
    s01 = (R[..., 0, 1] + R[..., 1, 0]) * 0.5
    s02 = (R[..., 0, 2] + R[..., 2, 0]) * 0.5
    s12 = (R[..., 1, 2] + R[..., 2, 1]) * 0.5
    ax, ay, az = axis_abs[..., 0], axis_abs[..., 1], axis_abs[..., 2]
    cand_x = torch.stack([ax, torch.sign(s01) * ay, torch.sign(s02) * az], -1)
    cand_y = torch.stack([torch.sign(s01) * ax, ay, torch.sign(s12) * az], -1)
    cand_z = torch.stack([torch.sign(s02) * ax, torch.sign(s12) * ay, az], -1)
    cand = torch.stack([cand_x, cand_y, cand_z], dim=-2)
    idx = k[..., None, None].expand(*k.shape, 1, 3)
    axis = torch.gather(cand, -2, idx)[..., 0, :]
    sgn = torch.where(torch.sum(axis * v, dim=-1) < 0.0, -1.0, 1.0).to(R.dtype)
    w_pi = theta[..., None] * axis * sgn[..., None]

    return torch.where(near_pi[..., None], w_pi, w_generic)


def left_jacobian(w):
    """SO(3) left Jacobian J_l(w)."""
    theta2 = torch.sum(w * w, dim=-1)
    big = theta2 > _SMALL
    theta = torch.sqrt(torch.where(big, theta2, torch.ones_like(theta2)))
    W = hat(w)
    W2 = W @ W
    b = torch.where(big, _one_minus_cos(theta) / theta2, 0.5 - theta2 / 24.0)
    c = torch.where(big, (theta - torch.sin(theta)) / (theta2 * theta),
                    1.0 / 6.0 - theta2 / 120.0)
    return _eye3(w) + b[..., None, None] * W + c[..., None, None] * W2


def left_jacobian_inverse(w):
    """Inverse of the SO(3) left Jacobian (closed form)."""
    theta2 = torch.sum(w * w, dim=-1)
    big = theta2 > _SMALL
    theta = torch.sqrt(torch.where(big, theta2, torch.ones_like(theta2)))
    W = hat(w)
    W2 = W @ W
    half_theta = 0.5 * theta
    cot_term = torch.where(
        big,
        (1.0 - 0.5 * theta * torch.cos(half_theta) / torch.sin(half_theta))
        / theta2,
        1.0 / 12.0 + theta2 / 720.0,
    )
    return _eye3(w) - 0.5 * W + cot_term[..., None, None] * W2


def quat_to_matrix(q):
    """Quaternion (w, x, y, z) -> rotation matrix (GTSAM ``Rot3`` order)."""
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    q = q / torch.where(n > 0, n, torch.ones_like(n))
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(R):
    """Rotation matrix -> quaternion (w, x, y, z), w >= 0 (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20],
                     dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21],
                     dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22],
                     dim=-1)
    scores = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
         1.0 - m00 - m11 + m22], dim=-1)
    k = torch.argmax(scores, dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)
    q = torch.gather(cand, -2, k[..., None, None].expand(*k.shape, 1, 4))
    q = q[..., 0, :]
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    q = q / torch.where(n > 0, n, torch.ones_like(n))
    return torch.where(q[..., :1] < 0, -q, q)


def rzryrx(roll, pitch, yaw):
    """GTSAM ``Rot3::RzRyRx(roll, pitch, yaw)`` = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    sr, cr = torch.sin(roll), torch.cos(roll)
    sp, cp = torch.sin(pitch), torch.cos(pitch)
    sy, cy = torch.sin(yaw), torch.cos(yaw)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr,
                         cy * sp * cr + sy * sr], dim=-1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr,
                         sy * sp * cr - cy * sr], dim=-1),
            torch.stack([-sp, cp * sr, cp * cr], dim=-1),
        ],
        dim=-2,
    )


def rpy(R):
    """Rotation matrix -> (roll, pitch, yaw), inverse of :func:`rzryrx`."""
    pitch = -torch.arcsin(torch.clamp(R[..., 2, 0], -1.0, 1.0))
    roll = torch.arctan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.arctan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)
