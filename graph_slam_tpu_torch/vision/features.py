"""Sparse feature frontend: Harris corners + normalized-patch descriptors
(port of ``vision/features.py``).

The in-repo stand-in for the external SIFT frontend
(``CSparseFeatureVO::featureExtraction``, SURVEY.md §3.1 hot loop): a
Harris detector is three convolutions and elementwise math, and
normalized image patches matched with one matmul give keypoints,
descriptors and their 3D lift.

Everything has a fixed shape: exactly ``max_features`` keypoints a frame,
invalid slots masked. The convolutions are cuDNN cross-correlations with
zero padding (``lax.conv_general_dilated`` with ``"SAME"``), run with TF32
off inside ``no_tf32()`` (torch lets cuDNN use TF32 by default); nothing
process-wide is changed. The top-k is a stable descending sort, so ties go
to the lower index as XLA's ``top_k`` sends them.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import CameraIntrinsics
from ..device import resolve, upload
from .camera import backproject

__all__ = ["FeatureFrame", "harris_corners", "extract_features",
           "no_tf32", "stack_frames"]


class FeatureFrame(NamedTuple):
    """CCameraNode equivalent: keypoints + descriptors + 3D lift + mask."""

    uv: torch.Tensor     # (M, 2) pixel coordinates, float32
    desc: torch.Tensor   # (M, D) L2-normalized descriptors, float32
    pts3: torch.Tensor   # (M, 3) camera-frame 3D points, float32
    valid: torch.Tensor  # (M,) bool


def stack_frames(frames) -> FeatureFrame:
    """Feature frames -> one ``FeatureFrame`` with a leading frame axis."""
    return FeatureFrame(*(torch.stack(f) for f in zip(*frames)))


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions in full float32 for the block: torch's
    ``cudnn.allow_tf32`` is True by default. The other cuDNN switches keep
    their values; all are restored after."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def image(x, device=None, dtype=torch.float32):
    """An image (tensor or host array) as a ``dtype`` tensor: a tensor
    stays on its device, a host array goes to ``device`` (``None``: the
    card)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return upload(x, resolve(device), dtype)


def conv2(img, kernel):
    """``lax.conv_general_dilated(..., padding="SAME")`` of one (H, W)
    image with an odd (kh, kw) kernel: cross-correlation, zero padding."""
    with no_tf32():
        return F.conv2d(img[None, None], kernel[None, None].to(img.dtype),
                        padding="same")[0, 0]


def _box(img, size=5):
    k = torch.ones((size, size), dtype=img.dtype,
                   device=img.device) / (size * size)
    return conv2(img, k)


def topk_stable(x, k):
    """(values, indices) of the ``k`` largest of the last axis of ``x``,
    ties to the lower index (XLA's ``top_k`` rule)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def harris_corners(img, max_features: int = 256, k: float = 0.04,
                   nms_size: int = 5):
    """Harris response + local-max NMS + top-k of an (H, W) image tensor.
    Returns (uv (M, 2) float32, score (M,))."""
    img = img.to(torch.float32)
    sx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                      dtype=torch.float32, device=img.device) / 8.0
    gx = conv2(img, sx)
    gy = conv2(img, sx.T)
    Ixx = _box(gx * gx)
    Iyy = _box(gy * gy)
    Ixy = _box(gx * gy)
    det = Ixx * Iyy - Ixy * Ixy
    tr = Ixx + Iyy
    resp = det - k * tr * tr
    # non-maximum suppression: keep pixels equal to their local max (the
    # window's padding is -inf, as reduce_window's "SAME")
    local_max = F.max_pool2d(resp[None, None], nms_size, stride=1,
                             padding=nms_size // 2)[0, 0]
    neg_inf = torch.full_like(resp, -torch.inf)
    resp = torch.where(resp >= local_max, resp, neg_inf)
    # suppress borders (patch extraction window)
    h, w = resp.shape
    border = 12
    inside = torch.zeros_like(resp, dtype=torch.bool)
    inside[border:h - border, border:w - border] = True
    resp = torch.where(inside, resp, neg_inf)

    score, idx = topk_stable(resp.reshape(-1), max_features)
    uv = torch.stack([idx % w, idx // w], dim=-1).to(torch.float32)
    return uv, score


def extract_features(K: CameraIntrinsics, intensity, depth,
                     max_features: int = 256, patch: int = 16,
                     min_response: float = 1e-6,
                     z_min: float = 0.05, z_max: float = 10.0, *,
                     device=None) -> FeatureFrame:
    """featureExtraction equivalent: corners + patch descriptors + 3D lift.

    ``depth`` in meters. Keypoints with invalid depth or weak response are
    masked out (fixed shapes). Tensors stay on their device; host arrays
    go to ``device`` (``None``: the card).
    """
    img = image(intensity, device)
    depth = image(depth, img.device)
    uv, score = harris_corners(img, max_features=max_features)

    # each patch's corner as lax.dynamic_slice takes it: a negative start
    # counts from the end, then the start is clamped into the image (the
    # -inf slots of the top-k are the first pixels, u - 8 < 0 there)
    h, w = img.shape
    half = patch // 2
    ui = uv[:, 0].to(torch.int64)
    vi = uv[:, 1].to(torch.int64)

    def start(i, n):
        i = torch.where(i < 0, i + n, i)
        return torch.clamp(i, 0, n - patch)

    u0 = start(ui - half, w)
    v0 = start(vi - half, h)
    off = torch.arange(patch, device=img.device)
    rows = (v0[:, None] + off)[:, :, None]
    cols = (u0[:, None] + off)[:, None, :]
    p = img[rows, cols]                                    # (M, P, P)
    p = p - torch.mean(p, dim=(1, 2), keepdim=True)
    n = torch.sqrt(torch.sum(p * p, dim=(1, 2), keepdim=True))
    desc = (p / torch.where(n > 1e-8, n, torch.ones_like(n))).reshape(
        len(uv), -1)

    z = depth[vi, ui]
    pts3 = backproject(K, uv[:, 0], uv[:, 1], z)
    valid = (z > z_min) & (z < z_max) & (score > min_response)
    return FeatureFrame(uv=uv, desc=desc, pts3=pts3, valid=valid)
