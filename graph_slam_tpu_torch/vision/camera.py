"""Camera model utilities: depth backprojection and point clouds (port of
``vision/camera.py``).

Intensity + depth images -> camera-frame 3D points (+ gray color), batched.
Tensors stay on their device; numpy images go to ``device`` (``None``: the
CUDA card).
"""

from __future__ import annotations

import torch

from ..config import CameraIntrinsics
from ..device import resolve

__all__ = ["backproject", "depth_to_cloud", "cloud_from_images"]


def _tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=resolve(device))


def backproject(K: CameraIntrinsics, u, v, z):
    """Pixel (u, v) + depth z (tensors) -> camera-frame 3D point (pinhole)."""
    x = (u - K.cx) * z / K.fx
    y = (v - K.cy) * z / K.fy
    return torch.stack([x, y, z], dim=-1)


def depth_to_cloud(K: CameraIntrinsics, depth, skip: int = 1,
                   z_min: float = 0.05, z_max: float = 10.0, *,
                   device=None):
    """Dense (H, W) depth in meters -> ((N, 3) points, (N,) validity mask),
    on the grid subsampled by ``skip``."""
    d = _tensor(depth, device)[::skip, ::skip]
    h, w = d.shape
    vs = torch.arange(0, h, dtype=d.dtype, device=d.device) * skip
    us = torch.arange(0, w, dtype=d.dtype, device=d.device) * skip
    uu, vv = torch.meshgrid(us, vs, indexing="xy")
    z = d.reshape(-1)
    pts = backproject(K, uu.reshape(-1), vv.reshape(-1), z)
    return pts, (z > z_min) & (z < z_max)


def cloud_from_images(K: CameraIntrinsics, intensity, depth, skip: int = 1,
                      z_min: float = 0.05, z_max: float = 10.0, *,
                      device=None):
    """(points, colors, mask) from an intensity + depth image pair."""
    pts, valid = depth_to_cloud(K, depth, skip, z_min, z_max, device=device)
    inten = _tensor(intensity, device)[::skip, ::skip].reshape(-1)
    return pts, torch.stack([inten, inten, inten], dim=-1), valid
