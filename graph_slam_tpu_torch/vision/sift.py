"""DoG/SIFT-class scale- and rotation-invariant features (port of
``vision/sift.py``).

The reference's frontend is SIFT (``CSparseFeatureVO::
featureExtraction``, SURVEY.md §3.1 hot loop); this is the JAX package's
fixed-shape restructuring of it, on torch:

- the Gaussian scale space is separable cuDNN convolutions (zero padding,
  TF32 off inside ``features.no_tf32``), octaves by factor-2
  subsampling;
- DoG extrema are one 3x3x3 max and min pool a scale (``F.max_pool3d``,
  padded with -inf as ``reduce_window`` pads), edge rejection by the 2x2
  Hessian ratio with wrapping differences (``torch.roll``, as
  ``jnp.roll``), and ONE global top-k over every octave and scale (a
  stable sort: ties to the lower index, as XLA's ``top_k``);
- orientation and the 4x4x8 descriptor sample a rotated, scale-normalized
  grid by bilinear interpolation from the per-octave gradient stacks: the
  reference's ``lax.switch`` over octaves is a loop over the static octave
  list, each keypoint taking its own octave's samples;
- the histograms are sums of one-hot products, so their float sums have a
  fixed order on every device (a CUDA ``index_add_`` adds in whatever
  order its atomics land, which could move the orientation's argmax).
  The orientation histogram is float64, as the reference's is under x64
  (its sample grid is a float64 ``linspace`` there), the descriptor's
  float32.

The result is a ``FeatureFrame``, a drop-in for the Harris frontend.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import CameraIntrinsics
from .camera import backproject
from .features import FeatureFrame, image, no_tf32, topk_stable

__all__ = ["SiftKeypoints", "dog_keypoints", "sift_features"]

_N_SPATIAL = 4          # descriptor spatial cells per axis
_N_ORI = 8              # descriptor orientation bins
_DESC_DIM = _N_SPATIAL * _N_SPATIAL * _N_ORI   # 128
_GRID = 16              # sampling grid per axis (SIFT's standard 16x16)
_ORI_BINS = 36


class SiftKeypoints(NamedTuple):
    uv: torch.Tensor         # (M, 2) pixel coords in the ORIGINAL image
    sigma: torch.Tensor      # (M,) absolute scale (pixels in original image)
    octave: torch.Tensor     # (M,) int64
    scale_idx: torch.Tensor  # (M,) int64 in-octave DoG scale index
    score: torch.Tensor      # (M,) |DoG| response
    valid: torch.Tensor      # (M,) bool


def _gauss_kernel(sigma: float, dtype, device):
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _blur(img, sigma: float):
    """Separable Gaussian blur (two 1-D convolutions, zero padding)."""
    if sigma <= 0:
        return img
    k = _gauss_kernel(sigma, img.dtype, img.device)
    r = (k.shape[0] - 1) // 2
    with no_tf32():
        v = F.conv2d(img[None, None], k.view(1, 1, -1, 1), padding=(r, 0))
        return F.conv2d(v, k.view(1, 1, 1, -1), padding=(0, r))[0, 0]


def _pyramid(img, n_octaves: int, s: int, sigma0: float):
    """Per octave: gaussian stack (s+3, H, W) and its DoG (s+2, H, W)."""
    k = 2.0 ** (1.0 / s)
    octaves = []
    base = _blur(img, math.sqrt(max(sigma0 ** 2 - 0.25, 0.01)))
    for _ in range(n_octaves):
        gs = [base]
        sig_prev = sigma0
        for i in range(1, s + 3):
            sig_total = sigma0 * k ** i
            sig_extra = math.sqrt(max(sig_total ** 2 - sig_prev ** 2, 1e-6))
            gs.append(_blur(gs[-1], sig_extra))
            sig_prev = sig_total
        g = torch.stack(gs)                     # (s+3, H, W)
        octaves.append((g, g[1:] - g[:-1]))     # DoG (s+2, H, W)
        base = gs[s][::2, ::2]                  # next octave seed (2*sigma0)
    return octaves


def _extrema_response(dog, contrast_thresh: float, edge_thresh: float):
    """(s, H, W) candidate response: |DoG| where a 26-neighbor extremum,
    contrast- and edge-gated; -inf elsewhere. ``dog`` is (s+2, H, W)."""
    # 3x3x3 max/min over (scale, y, x), padded with -inf / +inf
    mx = F.max_pool3d(dog[None, None], 3, stride=1, padding=1)[0, 0]
    mn = -F.max_pool3d(-dog[None, None], 3, stride=1, padding=1)[0, 0]
    is_ext = (dog >= mx) | (dog <= mn)

    def roll(x, dy, dx):
        return torch.roll(x, shifts=(dy, dx), dims=(1, 2))

    # edge rejection: ratio of principal curvatures of the DoG map
    dxx = roll(dog, 0, -1) + roll(dog, 0, 1) - 2 * dog
    dyy = roll(dog, -1, 0) + roll(dog, 1, 0) - 2 * dog
    dxy = (roll(dog, -1, -1) + roll(dog, 1, 1)
           - roll(dog, -1, 1) - roll(dog, 1, -1)) * 0.25
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_thresh
    edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)
    resp = torch.abs(dog)
    ok = is_ext & edge_ok & (resp > contrast_thresh)
    resp = torch.where(ok, resp, torch.full_like(resp, -torch.inf))
    # interior scales only (need neighbors above and below)
    resp = resp[1:-1]
    # border suppression (descriptor window support)
    h, w = dog.shape[1:]
    b = 8
    out = torch.full_like(resp, -torch.inf)
    out[:, b:h - b, b:w - b] = resp[:, b:h - b, b:w - b]
    return out


def _keypoints(octs, max_features: int, s: int, sigma0: float,
               contrast_thresh: float, edge_thresh: float) -> SiftKeypoints:
    """The global top-k over the responses of every octave and scale."""
    scores, us, vs, sigmas, octis, sidxs = [], [], [], [], [], []
    k = 2.0 ** (1.0 / s)
    for o, (_, dog) in enumerate(octs):
        resp = _extrema_response(dog, contrast_thresh, edge_thresh)
        S, H, W = resp.shape
        scores.append(resp.reshape(-1))
        lin = torch.arange(S * H * W, device=dog.device)
        si = lin // (H * W)
        yy = (lin % (H * W)) // W
        xx = lin % W
        step = float(2 ** o)
        us.append(xx.to(torch.float32) * step)
        vs.append(yy.to(torch.float32) * step)
        # absolute scale of DoG level si+1 (interior offset)
        sigmas.append(sigma0 * step * k ** (si.to(torch.float32) + 1.0))
        octis.append(torch.full((S * H * W,), o, dtype=torch.int64,
                                device=dog.device))
        sidxs.append(si + 1)

    top, idx = topk_stable(torch.cat(scores), max_features)

    def pick(xs):
        return torch.cat(xs)[idx]

    return SiftKeypoints(uv=torch.stack([pick(us), pick(vs)], -1),
                         sigma=pick(sigmas), octave=pick(octis),
                         scale_idx=pick(sidxs), score=top,
                         valid=torch.isfinite(top))


def dog_keypoints(img, max_features: int = 256, n_octaves: int = 4,
                  s: int = 3, sigma0: float = 1.6,
                  contrast_thresh: float = 0.015,
                  edge_thresh: float = 10.0) -> SiftKeypoints:
    """Scale-space keypoints of an (H, W) image tensor: one global top-k
    over all octaves and scales."""
    img = img.to(torch.float32)
    img = img / torch.clamp(torch.max(img), min=1e-6)
    octs = _pyramid(img, n_octaves, s, sigma0)
    return _keypoints(octs, max_features, s, sigma0, contrast_thresh,
                      edge_thresh)


def _bilinear_corners(m, x, y):
    """The reference's ``_bilinear`` up to the lookups: float coords
    (x, y) clamped into the (S, H, W) stack ``m``'s image, their top-left
    corner (x0, y0) and fractions (fx, fy)."""
    _, h, w = m.shape
    x = torch.clamp(x, 0.0, w - 1.001)
    y = torch.clamp(y, 0.0, h - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    return x0, y0, fx, fy


def _sample_grads(grads, kp_octave, kp_scale_idx, x_full, y_full, pts):
    """Gradient (gx, gy) of every keypoint at its ``pts`` (M, G, 2;
    offsets in octave pixels around the keypoint), each from its own
    octave's stacks: a loop over the static octave list with a mask."""
    step = 2.0 ** kp_octave.to(torch.float32)
    xs = (x_full / step)[:, None] + pts[..., 0]
    ys = (y_full / step)[:, None] + pts[..., 1]
    si = kp_scale_idx[:, None]
    out_x = out_y = None
    for o, (gx, gy) in enumerate(grads):
        x0, y0, fx, fy = _bilinear_corners(gx, xs, ys)
        vals = []
        for m in (gx, gy):
            v00 = m[si, y0, x0]
            v01 = m[si, y0, x0 + 1]
            v10 = m[si, y0 + 1, x0]
            v11 = m[si, y0 + 1, x0 + 1]
            vals.append((1 - fy) * ((1 - fx) * v00 + fx * v01)
                        + fy * ((1 - fx) * v10 + fx * v11))
        sel = (kp_octave == o)[:, None]
        if out_x is None:
            out_x, out_y = vals
        else:
            out_x = torch.where(sel, vals[0], out_x)
            out_y = torch.where(sel, vals[1], out_y)
    return out_x, out_y


def _grad_stacks(octs):
    """Per octave: (gx, gy) stacks over the gaussian images, (s+3, H, W),
    central differences that wrap at the borders (``jnp.roll``)."""
    out = []
    for g, _ in octs:
        gx = (torch.roll(g, -1, 2) - torch.roll(g, 1, 2)) * 0.5
        gy = (torch.roll(g, -1, 1) - torch.roll(g, 1, 1)) * 0.5
        out.append((gx, gy))
    return out


def _histogram(bins, weights, n_bins):
    """(M, n_bins) sums of ``weights`` (M, G) into ``bins`` (M, G): a
    one-hot product summed over G, in a fixed order on every device."""
    oh = F.one_hot(bins, n_bins).to(weights.dtype)
    return torch.sum(oh * weights[..., None], dim=1)


def _orientation(grads, kp, window: float = 4.5):
    """Dominant gradient orientation from a 36-bin weighted histogram, in
    float64 (see the module docstring)."""
    dev = kp.uv.device
    g = torch.linspace(-1.0, 1.0, _GRID, dtype=torch.float64, device=dev)
    gy, gxx = torch.meshgrid(g, g, indexing="ij")
    unit = torch.stack([gxx.reshape(-1), gy.reshape(-1)], -1)   # (G, 2)

    step = 2.0 ** kp.octave.to(torch.float32)
    sig_o = kp.sigma / step                      # in-octave scale
    pts = unit * (window * sig_o)[:, None, None]  # (M, G, 2) float64
    gx, gy_ = _sample_grads(grads, kp.octave, kp.scale_idx,
                            kp.uv[:, 0], kp.uv[:, 1], pts)
    mag = torch.sqrt(gx * gx + gy_ * gy_)
    wgt = mag * torch.exp(-0.5 * torch.sum(unit * unit, -1) / (0.5 ** 2))
    ang = torch.arctan2(gy_, gx)                 # [-pi, pi]
    bin_f = (ang + math.pi) / (2 * math.pi) * _ORI_BINS
    b0 = torch.floor(bin_f).to(torch.int64) % _ORI_BINS
    fb = bin_f - torch.floor(bin_f)
    hist = (_histogram(b0, wgt * (1 - fb), _ORI_BINS)
            + _histogram((b0 + 1) % _ORI_BINS, wgt * fb, _ORI_BINS))
    # smooth the histogram once (circular)
    hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    peak = torch.argmax(hist, dim=-1)            # first maximum
    return ((peak.to(torch.float32) + 0.5) / _ORI_BINS * 2 * math.pi
            - math.pi)


def _descriptors(grads, kp, theta, window: float = 6.0):
    """4x4x8 gradient histograms on a rotated, scale-normalized grid."""
    dev = kp.uv.device
    g = (torch.arange(_GRID, dtype=torch.float32, device=dev) + 0.5) \
        / _GRID * 2 - 1
    gy, gxx = torch.meshgrid(g, g, indexing="ij")
    unit = torch.stack([gxx.reshape(-1), gy.reshape(-1)], -1)   # (G, 2)
    # spatial cell coordinates in [0, 4)
    cell_f = (unit + 1.0) * 0.5 * _N_SPATIAL                  # (G, 2)

    step = 2.0 ** kp.octave.to(torch.float32)
    sig_o = kp.sigma / step
    c, s_ = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    us = unit * (window * sig_o)[:, None, None]               # (M, G, 2)
    # (unit * window * sig_o) @ R.T with R = [[c, -s], [s, c]]
    pts = torch.stack([us[..., 0] * c + us[..., 1] * -s_,
                       us[..., 0] * s_ + us[..., 1] * c], -1)
    gx, gy_ = _sample_grads(grads, kp.octave, kp.scale_idx,
                            kp.uv[:, 0], kp.uv[:, 1], pts)
    mag = torch.sqrt(gx * gx + gy_ * gy_)
    wgt = mag * torch.exp(-0.5 * torch.sum(unit * unit, -1) / (0.6 ** 2))
    ang = torch.arctan2(gy_, gx) - theta[:, None]
    obin_f = torch.remainder(ang + 2 * math.pi, 2 * math.pi) \
        / (2 * math.pi) * _N_ORI
    ob0 = torch.floor(obin_f).to(torch.int64) % _N_ORI
    fo = obin_f - torch.floor(obin_f)

    # trilinear soft-binning: bilinear over the 4x4 spatial cells, linear
    # over orientation
    cf = cell_f - 0.5
    c0 = torch.floor(cf).to(torch.int64)
    fc = cf - c0
    hist = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            cy = torch.clamp(c0[:, 1] + dy, 0, _N_SPATIAL - 1)
            cx = torch.clamp(c0[:, 0] + dx, 0, _N_SPATIAL - 1)
            wsp = (torch.abs(1 - dy - fc[:, 1])
                   * torch.abs(1 - dx - fc[:, 0]) * wgt)
            cell = ((cy * _N_SPATIAL + cx) * _N_ORI)[None]
            hist = hist + _histogram(cell + ob0, wsp * (1 - fo), _DESC_DIM)
            hist = hist + _histogram(cell + (ob0 + 1) % _N_ORI, wsp * fo,
                                     _DESC_DIM)
    d = hist / torch.clamp(torch.linalg.norm(hist, dim=-1, keepdim=True),
                           min=1e-8)
    d = torch.clamp(d, max=0.2)                  # SIFT illumination clip
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                           min=1e-8)


def sift_features(K: CameraIntrinsics, intensity, depth,
                  max_features: int = 256, n_octaves: int = 4, s: int = 3,
                  sigma0: float = 1.6, contrast_thresh: float = 0.015,
                  edge_thresh: float = 10.0,
                  z_min: float = 0.05, z_max: float = 10.0, *,
                  device=None) -> FeatureFrame:
    """SIFT-class drop-in for ``extract_features``: DoG keypoints +
    rotation/scale-invariant 128-d descriptors + 3D lift, fixed shapes.
    Tensors stay on their device; host arrays go to ``device`` (``None``:
    the card)."""
    img = image(intensity, device)
    img = img / torch.clamp(torch.max(img), min=1e-6)
    depth = image(depth, img.device)
    # dog_keypoints' own normalization is the identity on a normalized
    # image, so one pyramid serves the keypoints and the descriptors
    octs = _pyramid(img, n_octaves, s, sigma0)
    kp = _keypoints(octs, max_features, s, sigma0, contrast_thresh,
                    edge_thresh)
    grads = _grad_stacks(octs)
    theta = _orientation(grads, kp)
    desc = _descriptors(grads, kp, theta)

    h, w = depth.shape
    u = torch.clamp(kp.uv[:, 0].to(torch.int64), 0, w - 1)
    v = torch.clamp(kp.uv[:, 1].to(torch.int64), 0, h - 1)
    z = depth[v, u]
    pts3 = backproject(K, kp.uv[:, 0], kp.uv[:, 1], z)
    valid = kp.valid & (z > z_min) & (z < z_max)
    zero = torch.zeros((), dtype=torch.float32, device=img.device)
    return FeatureFrame(uv=torch.where(kp.valid[:, None], kp.uv, zero),
                        desc=torch.where(kp.valid[:, None], desc, zero),
                        pts3=torch.where(valid[:, None], pts3, zero),
                        valid=valid)
