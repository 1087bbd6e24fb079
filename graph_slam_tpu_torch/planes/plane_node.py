"""Node-level plane orchestration: the CPlaneNode container and the rescue's
plane prediction (port of ``planes/plane_node.py``).

A frame owns a small set of planes (parameters, tangent covariance, pixel
support masks, landmark ids), kept on the host in numpy as in the
reference. The rescue carries every plane of the previous frame into the
new one through the IMU-predicted relative pose (``propagate_planes``, whose
flood fill is the CUDA region grow on the card), and when less than half
the frame is covered extracts fresh planes from the rest of the cloud,
merging those that overlap a carried plane and carrying landmark ids.

The prediction is enqueued before its results are read
(``predict_plane_node_start``) and read once (``predict_plane_node_finish``:
one host sync for all of them). The reference runs the fresh extraction
under ``lax.cond`` on the device's coverage test; here the start reads that
test (one host sync, right after the propagation's refit has synced on its
``eigh`` status) and enqueues the extraction only when the test allows it.
An extraction costs a 512-hypothesis RANSAC per plane and two ``eigh``
refits per plane, each of which reads its status back, so skipping it
where the reference skips it saves more than the read costs. The RANSAC
draw of a fresh extraction is keyed by a tuple of ints
(``extraction.hypothesis_uniforms``).

``predict_plane_node`` is the synchronous form from a body-frame relative
pose: start and finish at once, or a fresh extraction when there is no
previous plane.

Precision: the reference computes the refits in the frame's dtype (float32
for rendered frames, inside a float64 run) and promotes where they meet
the float64 poses. Here a whole prediction runs in one dtype, the estimated
pose's (the VIO arena's): the frames are cast to it on upload. On float64
frames the two agree to rounding; on float32 frames the port's planes are
the float64 refit of the same pixels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import CameraIntrinsics
from ..core import se3
from ..device import resolve, to_host, upload
from .association import transform_plane_cov
from .extraction import PlaneDetection, extract_planes, hypothesis_uniforms
from .propagation import propagate_planes

__all__ = ["PlaneNodeDetection", "extract_plane_node",
           "extract_plane_nodes_batch", "predict_plane_node",
           "predict_plane_node_start", "predict_plane_node_finish"]

_N_HYP = 512
# bytes of one batch's (frames x hypotheses x pixels) distance tensor
_BATCH_DIST_BYTES = 2 << 30


@dataclasses.dataclass
class PlaneNodeDetection:
    """Per-frame plane set (CPlaneNode equivalent), camera frame, numpy.

    ``landmark_ids[k] == -1`` marks a plane not yet associated to a
    landmark.
    """

    params: np.ndarray        # (P, 4) — (n, d) unit-normal planes
    cov: np.ndarray           # (P, 3, 3) tangent covariance [basis(2), d]
    masks: np.ndarray         # (P, H, W) bool pixel support
    counts: np.ndarray        # (P,) inlier counts
    landmark_ids: np.ndarray  # (P,) int64, -1 = unassociated

    def __len__(self) -> int:
        return int(self.params.shape[0])


def _backproject_frame(K: CameraIntrinsics, depth, z_min=0.1, z_max=5.0):
    """Dense inverse projection of a depth image -> (H*W, 3) points + valid,
    in ``depth.dtype``."""
    h, w = depth.shape
    vv, uu = torch.meshgrid(
        torch.arange(h, dtype=depth.dtype, device=depth.device),
        torch.arange(w, dtype=depth.dtype, device=depth.device),
        indexing="ij")
    x = (uu - K.cx) * depth / K.fx
    y = (vv - K.cy) * depth / K.fy
    pts = torch.stack([x, y, depth], dim=-1).reshape(-1, 3)
    valid = ((depth > z_min) & (depth < z_max)).reshape(-1)
    return pts, valid


def _selected(det, sel, h, w) -> PlaneNodeDetection:
    """The host detection of rows ``sel`` of a (host) ``PlaneDetection``."""
    return PlaneNodeDetection(
        params=det.params[sel], cov=det.cov[sel],
        masks=det.inlier[sel].reshape(len(sel), h, w),
        counts=det.count[sel],
        landmark_ids=np.full(len(sel), -1, np.int64))


def extract_plane_node(key, K: CameraIntrinsics, depth, **kw
                       ) -> Optional[PlaneNodeDetection]:
    """Fresh plane segmentation of one host frame
    (CPlaneNode::extractPlanes), its draw keyed by the int tuple ``key``:
    ``extract_plane_nodes_batch`` of that frame alone, with its keywords.
    Returns None when no plane reaches ``min_support``."""
    return extract_plane_nodes_batch([key], K, [depth], **kw)[0]


def extract_plane_nodes_batch(keys, K: CameraIntrinsics, depths,
                              max_planes: int = 4, min_support: int = 300,
                              dist_thresh: float = 0.02,
                              sigma_z: float = 0.014, z_min: float = 0.1,
                              z_max: float = 5.0, *, device=None,
                              dtype=None):
    """Fresh plane segmentation of many frames in batches: the frames whose
    (frames x 512 x H*W) distance tensor fits in 2 GiB go in one
    ``extract_planes`` call, in ``dtype`` (default: the frames'). Returns a
    list of ``PlaneNodeDetection | None``, one per frame: the planes that
    reach ``min_support``, or None where none does.
    """
    device = resolve(device)
    depths = np.stack([np.asarray(d) for d in depths])
    n_frames, h, w = depths.shape
    item = depths.itemsize if dtype is None else dtype.itemsize
    per = max(1, _BATCH_DIST_BYTES // (_N_HYP * h * w * item))
    out = []
    for lo in range(0, n_frames, per):
        d = upload(depths[lo:lo + per], device, dtype)
        pts, valid = zip(*(_backproject_frame(K, x, z_min, z_max)
                           for x in d))
        u = upload(np.stack([hypothesis_uniforms(k, max_planes, _N_HYP)
                             for k in keys[lo:lo + per]]), device)
        det = to_host(extract_planes(u, torch.stack(pts), torch.stack(valid),
                                     max_planes=max_planes,
                                     dist_thresh=dist_thresh,
                                     min_support=min_support,
                                     sigma_z=sigma_z))
        for f in range(len(d)):
            sel = np.nonzero(det.valid[f])[0]
            out.append(_selected(PlaneDetection(*(x[f] for x in det)), sel,
                                 h, w) if len(sel) else None)
    return out


def _tangent_to_nv_cov(plane, cov3):
    """Split a (2+1) tangent covariance into (S_n 3x3, S_d scalar) through
    the Unit3 basis (GTSAM ``Unit3::basis`` axis choice), in numpy."""
    n = np.asarray(plane[:3], np.float64)
    ax, ay, az = abs(n[0]), abs(n[1]), abs(n[2])
    axis = np.array([1.0, 0.0, 0.0]) if (az >= ax and az >= ay) \
        else np.array([0.0, 0.0, 1.0])
    b1 = np.cross(n, axis)
    b1 = b1 / np.linalg.norm(b1)
    B = np.stack([b1, np.cross(n, b1)], axis=-1)
    S_n = B @ np.asarray(cov3)[:2, :2] @ B.T
    S_d = float(cov3[2, 2])
    return S_n, S_d


def _planes_overlap(new_plane, new_mask, new_count, kept: PlaneNodeDetection,
                    cos_thresh: float = np.cos(10.0 * np.pi / 180.0),
                    d_thresh: float = 0.2,
                    overlap_ratio: float = 0.3) -> bool:
    """mergeOverlappedPlanes test: a freshly extracted plane duplicates a
    propagated one when their pixel supports overlap or their parameters
    agree (normal angle < 10 deg and |delta d| <= 0.2, with sign flip)."""
    for k in range(len(kept)):
        inter = int(np.logical_and(new_mask, kept.masks[k]).sum())
        if new_count > 0 and inter / max(int(new_count), 1) > overlap_ratio:
            return True
        c = float(np.dot(new_plane[:3], kept.params[k][:3]))
        sign = -1.0 if c < 0 else 1.0
        if (c * sign >= cos_thresh
                and abs(sign * new_plane[3] - kept.params[k][3]) <= d_thresh):
            return True
    return False


def _propagate_extract_core(K: CameraIntrinsics, key, planes_i, S_ni, S_di,
                            prev_masks, prev_counts, T_cam: se3.Pose, S_tij,
                            intensity, depth, grow_steps: int, keep_ratio,
                            coverage_thresh, max_new_planes: int,
                            min_support, dist_thresh, sigma_z, z_min, z_max):
    """Propagation, then the extraction of the uncovered cloud (its draw
    keyed by ``key``) when the accepted planes cover at most
    ``coverage_thresh`` of the frame: the reference's ``lax.cond``, with
    the test read on the host (one sync). Returns the propagation and the
    extraction, None where the test skipped it."""
    res = propagate_planes(K, planes_i, S_ni, S_di, prev_masks, prev_counts,
                           T_cam, S_tij, intensity, depth,
                           grow_steps=grow_steps, z_min=z_min, z_max=z_max,
                           keep_ratio=keep_ratio, sigma_z=sigma_z)
    h, w = depth.shape
    num_added = torch.sum(torch.where(res.ok, res.count, 0))
    if not bool(num_added <= coverage_thresh * h * w):
        return res, None
    covered = torch.any(res.mask & res.ok[:, None, None], dim=0)
    pts, valid = _backproject_frame(K, depth, z_min, z_max)
    u = upload(hypothesis_uniforms(key, max_new_planes, _N_HYP),
               depth.device)
    fresh = extract_planes(u, pts, valid & ~covered.reshape(-1),
                           max_planes=max_new_planes,
                           dist_thresh=dist_thresh, min_support=min_support,
                           sigma_z=sigma_z)
    return res, fresh


def _rescue_predict_program(K: CameraIntrinsics, key, planes_i, S_ni, S_di,
                            prev_masks, prev_counts, pre_R, pre_t, est_R,
                            est_t, S66, u2c: Optional[se3.Pose], intensity,
                            depth, grow_steps: int, keep_ratio,
                            coverage_thresh, max_new_planes: int,
                            min_support, dist_thresh, sigma_z, z_min, z_max):
    """The whole rescue-side plane prediction on the device, from the VIO
    step's outputs (estimated pose, 6x6 pose covariance) as device tensors:
    the between pose, the u2c conjugation, the propagation, the
    coverage-gated extraction and the camera -> body projection of every
    candidate row (propagated and, where the extraction ran, fresh)."""
    T_body = se3.between(se3.Pose(pre_R, pre_t), se3.Pose(est_R, est_t))
    dt = est_R.dtype
    if u2c is not None:
        u2c = se3.Pose(u2c.R.to(dt), u2c.t.to(dt))
        u2c_inv = se3.inverse(u2c)
        T_cam = se3.compose(se3.compose(u2c_inv, T_body), u2c)
        Adj = se3.adjoint(u2c_inv)
        S_p = Adj @ S66 @ Adj.transpose(-1, -2)
    else:
        u2c_inv = se3.identity(dtype=dt, device=est_R.device)
        T_cam, S_p = T_body, S66
    res, fresh = _propagate_extract_core(
        K, key, planes_i, S_ni, S_di, prev_masks, prev_counts, T_cam,
        S_p[3:6, 3:6], intensity, depth, grow_steps, keep_ratio,
        coverage_thresh, max_new_planes, min_support, dist_thresh, sigma_z,
        z_min, z_max)
    pb_p, cb_p = transform_plane_cov(res.plane, res.cov, u2c_inv)
    pb_f = cb_f = None
    if fresh is not None:
        pb_f, cb_f = transform_plane_cov(fresh.params, fresh.cov, u2c_inv)
    return res, fresh, (pb_p, cb_p, pb_f, cb_f)


def _collect_prediction(prev: PlaneNodeDetection, res, fresh_raw,
                        h: int, w: int):
    """Host bookkeeping of a (host) propagation + extraction result:
    acceptance, landmark-id carry, overlap merge. Returns
    the detection (None when empty) and, per row, its source: ``(0, l)``
    for propagation row ``l``, ``(1, f)`` for fresh row ``f``."""
    kept_params, kept_cov, kept_masks, kept_counts, kept_lids = \
        [], [], [], [], []
    src: list = []
    for l in np.nonzero(res.ok)[0]:
        kept_params.append(res.plane[l])
        kept_cov.append(res.cov[l])
        kept_masks.append(res.mask[l])
        kept_counts.append(int(res.count[l]))
        kept_lids.append(int(prev.landmark_ids[l]))
        src.append((0, int(l)))

    kept = PlaneNodeDetection(
        params=np.asarray(kept_params).reshape(-1, 4),
        cov=np.asarray(kept_cov).reshape(-1, 3, 3),
        masks=np.asarray(kept_masks, bool).reshape(-1, h, w),
        counts=np.asarray(kept_counts, np.int64),
        landmark_ids=np.asarray(kept_lids, np.int64),
    )

    # fresh planes from the uncovered cloud (None when the coverage test
    # skipped the extraction)
    if fresh_raw is not None:
        sel = np.nonzero(fresh_raw.valid)[0]
        fresh = _selected(fresh_raw, sel, h, w) if len(sel) else None
        if fresh is not None:
            for f in range(len(fresh)):
                if _planes_overlap(fresh.params[f], fresh.masks[f],
                                   fresh.counts[f], kept):
                    continue
                kept.params = np.concatenate(
                    [kept.params, fresh.params[f:f + 1]])
                kept.cov = np.concatenate([kept.cov, fresh.cov[f:f + 1]])
                kept.masks = np.concatenate(
                    [kept.masks, fresh.masks[f:f + 1]])
                kept.counts = np.concatenate(
                    [kept.counts, fresh.counts[f:f + 1]])
                kept.landmark_ids = np.concatenate(
                    [kept.landmark_ids, np.asarray([-1], np.int64)])
                src.append((1, int(sel[f])))

    return (kept if len(kept) else None), src


def predict_plane_node_start(key, K: CameraIntrinsics,
                             prev: PlaneNodeDetection, pre_R, pre_t,
                             est_R, est_t, S66, intensity, depth,
                             u2c: Optional[se3.Pose] = None,
                             keep_ratio: float = 0.7,
                             coverage_thresh: float = 0.5,
                             max_new_planes: int = 4,
                             min_support: int = 300, grow_steps: int = 64,
                             z_min: float = 0.1, z_max: float = 5.0,
                             sigma_z: float = 0.014):
    """Enqueue the rescue-side plane prediction; its one read is the
    coverage test that decides whether the fresh extraction is enqueued.

    ``pre_R/pre_t/est_R/est_t/S66`` are device tensors (the VIO step's
    outputs); the host frame and ``prev``'s arrays go to their device, in
    their dtype.
    ``prev`` must be non-empty, and is captured by reference: its
    ``landmark_ids`` are read only at finish time, so a caller may resolve
    them in between. ``key`` keys the fresh extraction's draw. Finish with
    :func:`predict_plane_node_finish`.
    """
    dev, dt = est_R.device, est_R.dtype
    h, w = np.shape(depth)
    nv = [_tangent_to_nv_cov(prev.params[l], prev.cov[l])
          for l in range(len(prev))]
    res, fresh, tbody = _rescue_predict_program(
        K, key, upload(prev.params, dev, dt),
        upload(np.stack([s for s, _ in nv]), dev, dt),
        upload(np.asarray([d for _, d in nv]), dev, dt),
        upload(prev.masks, dev), upload(prev.counts, dev, dt), pre_R, pre_t,
        est_R, est_t, S66, u2c, upload(intensity, dev, dt),
        upload(depth, dev, dt),
        grow_steps, keep_ratio, coverage_thresh, max_new_planes,
        min_support, 0.02, sigma_z, z_min, z_max)
    return (prev, res, fresh, tbody, h, w)


def predict_plane_node_finish(handle):
    """Read a :func:`predict_plane_node_start` handle (one host sync; none
    if it was read already) and run the host bookkeeping.

    Returns ``(detection, (planes_body, covs_body))``, the camera -> body
    projections gathered into the detection's rows, or ``(None, None)``
    when nothing was predicted."""
    prev, res, fresh, tbody, h, w = handle
    res, fresh, tbody = to_host((res, fresh, tbody))
    det, src = _collect_prediction(prev, res, fresh, h, w)
    if det is None:
        return None, None
    pb_p, cb_p, pb_f, cb_f = tbody
    pbs = np.stack([(pb_p if k == 0 else pb_f)[i] for k, i in src])
    cbs = np.stack([(cb_p if k == 0 else cb_f)[i] for k, i in src])
    return det, (pbs, cbs)


def predict_plane_node(key, K: CameraIntrinsics,
                       prev: Optional[PlaneNodeDetection], T_body, S_pose,
                       intensity, depth, u2c: Optional[se3.Pose] = None,
                       keep_ratio: float = 0.7, coverage_thresh: float = 0.5,
                       max_new_planes: int = 4, min_support: int = 300,
                       grow_steps: int = 64, z_min: float = 0.1,
                       z_max: float = 5.0, sigma_z: float = 0.014, *,
                       device=None, dtype=torch.float64
                       ) -> Optional[PlaneNodeDetection]:
    """Carry the previous frame's planes into the current one
    (``CGraphGT::predictPlaneNode``), on ``device`` (``None``: the card)
    in ``dtype``.

    ``T_body`` is the current frame's pose in the previous one's body
    frame and ``S_pose`` its 6x6 covariance (numpy or tensors); ``u2c``
    conjugates both into the camera frame. The previous planes are
    propagated (the region grow), kept at ``keep_ratio`` of their support
    with their landmark ids, and the uncovered cloud extracted when they
    cover at most ``coverage_thresh`` of the frame:
    ``predict_plane_node_start`` from the identity to ``T_body``, then
    ``predict_plane_node_finish``. With no previous plane, the whole
    frame's fresh extraction. ``key`` keys the extraction's draw. Returns
    None when nothing is found.
    """
    device = resolve(device)

    def t(x):
        if isinstance(x, torch.Tensor):
            return x.to(device, dtype)
        return upload(np.asarray(x, np.float64), device, dtype)

    if prev is None or not len(prev):
        return extract_plane_node(key, K, depth, max_planes=max_new_planes,
                                  min_support=min_support, sigma_z=sigma_z,
                                  z_min=z_min, z_max=z_max, device=device,
                                  dtype=dtype)
    if u2c is not None:
        u2c = se3.Pose(t(u2c.R), t(u2c.t))
    ident = se3.identity(dtype=dtype, device=device)
    handle = predict_plane_node_start(
        key, K, prev, ident.R, ident.t, t(T_body.R), t(T_body.t), t(S_pose),
        intensity, depth, u2c=u2c, keep_ratio=keep_ratio,
        coverage_thresh=coverage_thresh, max_new_planes=max_new_planes,
        min_support=min_support, grow_steps=grow_steps, z_min=z_min,
        z_max=z_max, sigma_z=sigma_z)
    return predict_plane_node_finish(handle)[0]
