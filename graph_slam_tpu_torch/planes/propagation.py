"""IMU-predicted plane propagation across frames — the tracking-loss rescue
(port of ``planes/propagation.py``).

When visual odometry fails, the previous frame's planes are carried into
the new frame with the predicted relative pose:

1. ``propagated_distance_variance`` (the reference's ``computeSdj``) gives
   the membership gate of each plane;
2. every current pixel is tested against the predicted plane
   (``dis^2 <= max(S_dj, 0.014^2)``);
3. the seed inverse-warps the previous plane mask (bilinear gather);
4. the 4-neighbour intensity-gated region grow runs ``grow_steps`` steps —
   ``region_grow``, the hand-written kernel on CUDA;
5. the grown plane is refit (least squares) with its tangent covariance,
   and accepted when it keeps >= ``keep_ratio`` of the previous support.

Everything is computed in ``depth.dtype``. The smoothness gates use a
wrapping ``roll`` (as the reference does) while the grow's shifts are
zero-filled.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CameraIntrinsics
from ..core import se3
from . import oriented_plane
from .extraction import fit_plane_lsq, plane_tangent_cov
from .region_grow import region_grow

__all__ = ["propagated_distance_variance", "propagate_plane",
           "propagate_planes", "PropagationResult"]


class PropagationResult(NamedTuple):
    plane: torch.Tensor   # (..., 4) refit plane in the new camera frame
    cov: torch.Tensor     # (..., 3, 3) tangent covariance
    mask: torch.Tensor    # (..., H, W) membership after region grow
    count: torch.Tensor   # (...,) inlier count
    ok: torch.Tensor      # (...,) bool — propagation accepted


def propagated_distance_variance(plane_i, S_ni, S_di, T_ij: se3.Pose, S_tij):
    """Variance of the plane distance in the predicted frame (computeSdj).

    S_dj = S_di + n^T S_t n + ((I - n n^T) t)^T S_ni ((I - n n^T) t),
    batched over leading plane axes of ``plane_i``/``S_ni``/``S_di``.
    """
    n = plane_i[..., :3]
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    proj = eye - n[..., :, None] * n[..., None, :]
    D = (proj @ T_ij.t[..., None])[..., 0]
    return (S_di + torch.einsum("...i,ij,...j->...", n, S_tij, n)
            + torch.einsum("...i,...ij,...j->...", D, S_ni, D))


def _bilinear(img, u, v):
    """Bilinear sample of (..., H, W) images at float (H', W') coords;
    out-of-bounds taps read 0."""
    h, w = img.shape[-2:]
    u0f = torch.floor(u)
    v0f = torch.floor(v)
    du = u - u0f
    dv = v - v0f
    u0 = u0f.to(torch.int64)
    v0 = v0f.to(torch.int64)

    def at(vv, uu):
        ok = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
        val = img[..., vv.clamp(0, h - 1), uu.clamp(0, w - 1)]
        return torch.where(ok, val, torch.zeros_like(val))

    return ((1 - du) * (1 - dv) * at(v0, u0) + du * (1 - dv) * at(v0, u0 + 1)
            + (1 - du) * dv * at(v0 + 1, u0) + du * dv * at(v0 + 1, u0 + 1))


def _frame_geometry(K: CameraIntrinsics, T_ij: se3.Pose, intensity, depth,
                    z_min, z_max, intensity_tol):
    """Per-frame work shared by all planes: back-projected points, depth
    range mask, inverse-warp coordinates and the four smoothness gates."""
    dtype, dev = depth.dtype, depth.device
    h, w = depth.shape
    vv, uu = torch.meshgrid(torch.arange(h, dtype=dtype, device=dev),
                            torch.arange(w, dtype=dtype, device=dev),
                            indexing="ij")
    pts = torch.stack([(uu - K.cx) * depth / K.fx, (vv - K.cy) * depth / K.fy,
                       depth], dim=-1)                        # (H, W, 3)
    z_ok = (depth > z_min) & (depth < z_max)

    p_prev = se3.transform_from(T_ij, pts)
    zp = torch.where(p_prev[..., 2] > 1e-6, p_prev[..., 2],
                     torch.full_like(p_prev[..., 2], 1e-6))
    up = K.fx * p_prev[..., 0] / zp + K.cx
    vp = K.fy * p_prev[..., 1] / zp + K.cy

    img = intensity.to(dtype)

    def smooth(shifted):
        return torch.abs(img - shifted) <= intensity_tol

    gates = (smooth(torch.roll(img, 1, dims=1)),
             smooth(torch.roll(img, -1, dims=1)),
             smooth(torch.roll(img, 1, dims=0)),
             smooth(torch.roll(img, -1, dims=0)))
    return pts, z_ok, up, vp, gates


def propagate_planes(K: CameraIntrinsics, planes_i, S_ni, S_di, prev_masks,
                     prev_counts, T_ij: se3.Pose, S_tij, intensity, depth,
                     grow_steps: int = 64, z_min: float = 0.1,
                     z_max: float = 5.0, keep_ratio: float = 0.7,
                     intensity_tol: float = 5.0,
                     sigma_z: float = 0.014) -> PropagationResult:
    """Carry all P planes of the previous frame into the current one.

    Args: ``planes_i (P, 4)`` in the previous camera frame, normal
    covariances ``S_ni (P, 3, 3)``, distance variances ``S_di (P,)``,
    ``prev_masks (P, H, W)`` bool, ``prev_counts (P,)``; ``T_ij`` the
    current frame's pose in the previous one (``p_prev = T_ij * p_cur``)
    with translation covariance ``S_tij (3, 3)``; ``intensity``/``depth``
    (H, W) of the current frame, depth in meters. All on one device.
    Returns a ``PropagationResult`` with a leading plane axis.
    """
    plane_j = oriented_plane.transform(planes_i, T_ij.R, T_ij.t)   # (P, 4)
    S_dj = propagated_distance_variance(planes_i, S_ni, S_di, T_ij, S_tij)
    gate = torch.clamp(S_dj, min=0.014 * 0.014)                     # (P,)

    pts, z_ok, up, vp, gates = _frame_geometry(K, T_ij, intensity, depth,
                                               z_min, z_max, intensity_tol)
    dis = (torch.einsum("hwi,pi->phw", pts, plane_j[:, :3])
           + plane_j[:, 3, None, None])
    member = (dis * dis <= gate[:, None, None]) & z_ok[None]
    seed = (_bilinear(prev_masks.to(depth.dtype), up, vp) > 0.25) & member

    mask = region_grow(seed, member, *gates, steps=grow_steps)
    count = torch.sum(mask, dim=(1, 2))
    ok = count >= keep_ratio * prev_counts

    flat_pts = pts.reshape(-1, 3)
    flat_m = mask.reshape(mask.shape[0], -1)
    plane_fit = fit_plane_lsq(flat_pts, flat_m)
    cov = plane_tangent_cov(plane_fit, flat_pts, flat_m, sigma_z)
    plane_out = torch.where(ok[:, None], plane_fit, plane_j)
    return PropagationResult(plane=plane_out, cov=cov, mask=mask, count=count,
                             ok=ok)


def propagate_plane(K: CameraIntrinsics, plane_i, S_ni, S_di, prev_mask,
                    prev_count, T_ij: se3.Pose, S_tij, intensity, depth,
                    grow_steps: int = 64, z_min: float = 0.1,
                    z_max: float = 5.0, keep_ratio: float = 0.7,
                    intensity_tol: float = 5.0,
                    sigma_z: float = 0.014) -> PropagationResult:
    """Carry one plane into the current frame: ``propagate_planes`` with
    P = 1 (``plane_i (4,)``, ``S_ni (3, 3)``, scalar ``S_di``/``prev_count``,
    ``prev_mask (H, W)``); results without the plane axis."""
    def one(x):
        if not isinstance(x, torch.Tensor):    # a number: float64 or int64
            x = torch.as_tensor(x, dtype=torch.float64 if isinstance(
                x, float) else torch.int64)
        return x.to(depth.device).reshape(1)

    res = propagate_planes(
        K, plane_i[None], S_ni[None], one(S_di), prev_mask[None],
        one(prev_count), T_ij, S_tij,
        intensity, depth, grow_steps=grow_steps, z_min=z_min, z_max=z_max,
        keep_ratio=keep_ratio, intensity_tol=intensity_tol, sigma_z=sigma_z)
    return PropagationResult(*(x[0] for x in res))
