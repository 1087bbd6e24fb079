"""Offline BA + IMU pipeline, ``test_ba_imu_graph``'s twin (port of
``pipelines/ba_imu.py``).

The VIO replay's skeleton, but frames carry feature observations: matched
features become shared Point3 landmarks with a point prior at their first
triangulation and Cal3DS2 projection factors on every observing pose (the
global BA insertion), IMU factors optional, one batch optimization at the
end. Landmark bookkeeping is ``vision.TrackBook``.

The Schur solver is chosen by the arena's dtype: float64 runs the
normal-equations Schur (``ba_gn_optimize``), any other dtype the
square-root Schur (``ba_gn_optimize_sqrt``), whose normal equations would
cancel in float32, unless a feature track is longer than
``_SQRT_MAX_TRACK`` observations, when generic LM runs instead.
``BaImuConfig.sharded = N > 0`` runs the square-root Schur with its
landmarks split over N ranks instead (``parallel.sharded_ba_sqrt`` under
``parallel.launch`` on ``device``), whatever the dtype, while the longest
track is within ``_SQRT_MAX_TRACK``. ``features_from_store`` builds
``run_ba_imu``'s inputs from raw RGB-D frames through the feature
frontend.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..config import CameraIntrinsics
from ..core import se3
from ..device import resolve
from ..graph import GraphBuilder, LMParams, lm_optimize, total_error
from ..graph.ba_solve import ba_gn_optimize, ba_gn_optimize_sqrt
from ..imu import (ImuParams, ImuStream, find_index_at, init_preint,
                   integrate_segment, predict_navstate)
from ..vision.ba import TrackBook
from .vio_kernel import _pad_window

__all__ = ["BaImuConfig", "BaImuResult", "run_ba_imu", "features_from_store"]

# longest feature track the square-root Schur accepts before run_ba_imu
# falls back to LM: every landmark's QR stack pads to the longest track
_SQRT_MAX_TRACK = 64


@dataclasses.dataclass
class BaImuConfig:
    use_imu: bool = True
    point_sigma: float = 0.014      # Point3 prior
    pixel_sigma: float = 1.0        # projection noise
    max_imu_window: int = 512
    solver: str = "schur"            # "schur" | "lm"
    schur_iters: int = 10
    bucket: int = 64
    sharded: int = 0                 # >0: landmark-sharded solve over N
    #                                  ranks (parallel.sharded_ba_sqrt)


@dataclasses.dataclass
class BaImuResult:
    values: object
    graph: object
    error0: float
    error: float
    n_landmarks: int
    n_projection_factors: int
    n_imu_factors: int


def features_from_store(frames_provider, seq_ids, K,
                        max_features: int = 256, ratio: float = 0.8,
                        features: str = "harris", *, device=None):
    """Build ``run_ba_imu``'s (frames, matches) inputs from raw RGB-D frames.

    Extracts features per frame on ``device`` (``None``: the card; the
    driver's featureExtraction role, test_ba_imu_graph.cpp:79-120) and
    returns a consecutive-pair matcher backed by the batched descriptor
    matmul. Each frame's features and each pair's matches come back to the
    host in one copy.
    """
    from ..device import to_host
    from ..vision.frontend import get_extractor
    from ..vision.matching import match_descriptors

    extract_features = get_extractor(features)
    device = resolve(device)
    ffs = []
    frames_out = []
    for s in seq_ids:
        fr = frames_provider(int(s))
        if fr is None:
            raise FileNotFoundError(f"missing frame for seq {s}")
        f = extract_features(K, fr[0], fr[1], max_features=max_features,
                             device=device)
        ffs.append(f)
        uv, pts3 = to_host((f.uv, f.pts3))
        frames_out.append({"uv": uv, "pts3": pts3})

    def matches(i, j):
        idx, ok = match_descriptors(ffs[j].desc, ffs[i].desc, ratio=ratio)
        idx, ok = to_host((idx, ok & ffs[j].valid & ffs[i].valid[idx]))
        return [(int(idx[k]), int(k)) for k in np.nonzero(ok)[0]]

    return frames_out, matches


def run_ba_imu(frames, matches: Callable, img_times,
               imu: Optional[ImuStream], imu_params: Optional[ImuParams],
               cal: CameraIntrinsics, u2c: Optional[se3.Pose] = None,
               cfg: BaImuConfig = BaImuConfig(),
               lm_params: LMParams = LMParams(), *, device=None,
               dtype=torch.float64) -> BaImuResult:
    """Run BA(+IMU) over a frame sequence on ``device`` (``None``: the CUDA
    card); the graph is built in ``dtype``, the IMU preintegration runs in
    float64.

    Args:
      frames: per-frame feature data: dicts with ``uv`` (M, 2) pixel
        observations and ``pts3`` (M, 3) camera-frame 3D lifts.
      matches: ``(i, j) -> [(feat_i, feat_j), ...]`` feature matches between
        frames i and j (consecutive pairs are queried).
      img_times: seq -> timestamp (needed when use_imu).
    """
    device = resolve(device)
    f64 = dict(dtype=torch.float64, device=device)
    u2c_t = u2c if u2c is not None else se3.identity(**f64)
    body = (u2c_t.R.cpu().numpy(), u2c_t.t.cpu().numpy())
    b = GraphBuilder()
    book = TrackBook()
    n_proj = n_imu = 0

    prev_pose = se3.identity(**f64)
    prev_vel = torch.zeros(3, **f64)
    prev_bias = torch.zeros(6, **f64)
    cur_imu_idx = 0
    use_imu = cfg.use_imu and imu is not None
    poses: list[se3.Pose] = []
    t_of = img_times.__getitem__ if hasattr(img_times, "__getitem__") \
        else img_times

    def add_projection(frame_idx, feat_idx, qid):
        nonlocal n_proj
        b.add_projection_factor(frame_idx, qid,
                                np.asarray(frames[frame_idx]["uv"][feat_idx]),
                                cal, body_pose=body, sigma=cfg.pixel_sigma)
        n_proj += 1

    for j in range(len(frames)):
        if j == 0:
            b.add_pose((np.eye(3), np.zeros(3)))
            b.add_prior_pose(0, (np.eye(3), np.zeros(3)),
                             sigmas=np.full(6, 1e-7))
            if use_imu:
                b.add_vel(np.zeros(3))
                b.add_bias(np.zeros(6))
                b.add_prior_vel(0, np.zeros(3), sigma=1e-3)
                b.add_prior_bias(0, np.zeros(6), sigma=1e-3)
                imu.set_start_time(float(t_of(0)))
            poses.append(se3.identity(**f64))
            continue

        # IMU preintegration and prediction for the initial estimate
        if use_imu:
            nxt = find_index_at(imu.t, float(t_of(j)), imu.start)
            if nxt < 0:
                nxt = len(imu.t) - imu.start - 1
            acc, gyr = imu.window(cur_imu_idx, nxt)
            a, g, dts = _pad_window(acc, gyr, nxt - cur_imu_idx, imu.dt,
                                    cfg.max_imu_window)
            st = integrate_segment(init_preint(prev_bias, imu_params, **f64),
                                   a, g, dts, imu_params)
            cur_imu_idx = nxt
            pred_pose, pred_vel = predict_navstate(
                st, prev_pose, prev_vel, prev_bias, imu_params.gravity)
        else:
            pred_pose, pred_vel = prev_pose, prev_vel

        b.add_pose((pred_pose.R.cpu().numpy(), pred_pose.t.cpu().numpy()))
        poses.append(pred_pose)
        if use_imu:
            b.add_vel(pred_vel.cpu().numpy())
            b.add_bias(prev_bias.cpu().numpy())
            b.add_imu_factor(j - 1, j, st, imu_params.gravity)
            n_imu += 1
            prev_pose, prev_vel = pred_pose, pred_vel

        # feature tracks -> landmarks + projection factors
        pair_matches = matches(j - 1, j)
        events = book.merge(j - 1, j, pair_matches)
        for (ev, qid), (fi, fj) in zip(events, pair_matches):
            if ev == "new":
                # triangulate in frame j-1: world = X_{j-1} * u2c * p_cam
                p_cam = torch.as_tensor(
                    np.asarray(frames[j - 1]["pts3"][fi], np.float64),
                    device=device)
                pw = se3.transform_from(se3.compose(poses[j - 1], u2c_t),
                                        p_cam).cpu().numpy()
                b.add_point(pw)
                b.add_prior_point(qid, pw, sigma=cfg.point_sigma)
                add_projection(j - 1, fi, qid)
                add_projection(j, fj, qid)
            elif ev == "extend_i":
                add_projection(j - 1, fi, qid)
            elif ev == "extend_j":
                add_projection(j, fj, qid)
            # "seen": both observations already in the graph

    graph, values = b.build(bucket=cfg.bucket, device=device, dtype=dtype)
    e0 = float(total_error(graph, values))
    if cfg.solver == "schur":
        pj = graph.projection
        pidx = pj.point_idx[pj.active].cpu().numpy()
        max_track = int(np.bincount(pidx).max()) if pidx.size else 0
        track_ok = max_track <= _SQRT_MAX_TRACK
        if not track_ok and (cfg.sharded > 0 or dtype != torch.float64):
            warnings.warn(
                f"ba-imu: longest feature track ({max_track} observations) "
                f"exceeds {_SQRT_MAX_TRACK}; the sqrt-Schur elimination "
                "would pad every landmark to it — falling back to the "
                "generic LM solver"
                + (" (the --sharded mesh will sit idle)" if cfg.sharded
                   else ""))
        if cfg.sharded > 0 and track_ok:
            from ..convert import arena_from_numpy
            from ..parallel import launch, sharded_ba_sqrt

            vals, err = launch(cfg.sharded, sharded_ba_sqrt, graph, values,
                               iterations=cfg.schur_iters, device=device)[0]
            vals = arena_from_numpy(vals, device=device, dtype=dtype)
        elif dtype == torch.float64:
            vals, err = ba_gn_optimize(graph, values,
                                       iterations=cfg.schur_iters)
        elif track_ok:
            vals, err = ba_gn_optimize_sqrt(graph, values,
                                            iterations=cfg.schur_iters)
        else:
            res = lm_optimize(graph, values, lm_params)
            vals, err = res.values, res.error
    else:
        res = lm_optimize(graph, values, lm_params)
        vals, err = res.values, res.error
    return BaImuResult(values=vals, graph=graph, error0=e0, error=float(err),
                       n_landmarks=book.next_qid,
                       n_projection_factors=n_proj, n_imu_factors=n_imu)
