"""VRO frontend: pairwise frame matching and batched loop-closure search
(port of ``vision/frontend.py``).

``match_node_pair`` is the external frontend's ``CCameraNode::
matchNodePair`` (SURVEY.md §3.1 hot path): descriptor matching ->
parallel RANSAC -> rigid transform + information. The reference fans
loop-closure candidates over a Qt thread pool (``gtsam_graph.cpp:
1730-1731``); ``match_one_to_many`` matches a whole stacked candidate
window in one batch on the device.

Transform convention: the returned (R, t) is the pose of the *new* frame j
expressed in the reference frame i (``X_j = X_i * T_ij``), as
``addToGTSAM`` composes initial estimates (gtsam_graph.cpp:655-668).

A ``key`` is a tuple of non-negative ints that keys the RANSAC draw
(``matching.uniforms``); ``match_one_to_many`` draws candidate c with
``key + (c,)``. The device functions return tensors and read nothing back;
the host wrappers read each result back in one copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import se3
from ..device import resolve, to_host
from .features import FeatureFrame
from .matching import (MatchingResult, _match_descriptors_b, _ransac_rigid_b,
                       match_descriptors, ransac_rigid, uniforms,
                       vo_information)

__all__ = ["match_node_pair", "match_one_to_many", "match_frames_device",
           "match_under_prior", "refine_edge_ba", "make_ba_fn",
           "get_extractor", "make_feature_cache"]


def match_frames_device(key, frame_i: FeatureFrame, frame_j: FeatureFrame,
                        n_hyp: int = 2048, inlier_thresh: float = 0.05,
                        ratio: float = 0.8, min_inliers: int = 12,
                        point_sigma: float = 0.01):
    """Device core: (R, t, info, n_inliers, ok) for a frame pair."""
    idx, m_ok = match_descriptors(frame_j.desc, frame_i.desc, ratio=ratio)
    # matched pairs: src = j's 3D points, dst = i's 3D points
    src = frame_j.pts3
    dst = frame_i.pts3[idx]
    valid = m_ok & frame_j.valid & frame_i.valid[idx]
    R, t, inl, ok = ransac_rigid(key, src, dst, valid, n_hyp=n_hyp,
                                 inlier_thresh=inlier_thresh,
                                 min_inliers=min_inliers)
    info = vo_information(R, t, inl, src, sigma=point_sigma)
    return R, t, info, torch.sum(inl), ok


def match_node_pair(key, frame_i: FeatureFrame, frame_j: FeatureFrame,
                    id_i: int, id_j: int, **kw) -> MatchingResult:
    """Host wrapper producing the MatchingResult record."""
    R, t, info, n_inl, ok = to_host(
        match_frames_device(key, frame_i, frame_j, **kw))
    return MatchingResult(id_from=id_i, id_to=id_j, T=(R, t),
                          information=info, num_inliers=int(n_inl),
                          succeed=bool(ok))


def match_under_prior(key, frame_i: FeatureFrame, frame_j: FeatureFrame,
                      T_init, radius: float = 0.15, n_hyp: int = 512,
                      inlier_thresh: float = 0.04, ratio: float = 0.95,
                      min_inliers: int = 6, point_sigma: float = 0.01):
    """Guided re-matching under a predicted transform — ``vroAdjust``.

    The reference re-matches a frame pair with the search restricted by
    the predicted transform and re-estimates (``CGraphGT::vroAdjust``,
    gtsam_graph.cpp:450-498, via the frontend's ``matchNodePairBA``). The
    guidance is a dense geometric gate: each feature of frame j is pushed
    through ``T_init`` into frame i (``p_i = T_ij p_j``) and may only match
    i-features whose 3D point lies within ``radius`` meters of the
    prediction — one masked (Nj, Ni) distance matrix fused with the
    descriptor similarity matmul.

    Returns ``(R, t, info, inliers, nn, ok)``: the rigid estimate, its
    information, the (Nj,) boolean inlier mask, the (Nj,) index of each
    j-feature's matched i-feature, and the success flag.
    """
    pts_j = frame_j.pts3
    R0, t0 = (x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x)) for x in T_init)
    # the gate in the promoted dtype, as jnp promotes float32 points
    # against a float64 prior
    dtype = torch.promote_types(pts_j.dtype, R0.dtype)
    R0, t0 = R0.to(pts_j.device, dtype), t0.to(pts_j.device, dtype)
    pred_i = pts_j.to(dtype) @ R0.T + t0

    sim = frame_j.desc @ frame_i.desc.T
    d2 = 2.0 - 2.0 * sim
    dist2 = torch.sum((pred_i[:, None, :]
                       - frame_i.pts3.to(dtype)[None, :, :]) ** 2, dim=-1)
    gate = (dist2 <= radius * radius) & frame_i.valid[None, :]
    d2 = torch.where(gate, d2, torch.full_like(d2, torch.inf))
    nn = torch.argmin(d2, dim=1)
    best = torch.min(d2, dim=1).values
    second = torch.min(d2.scatter(1, nn[:, None], torch.inf), dim=1).values
    m_ok = torch.isfinite(best) & frame_j.valid
    m_ok = m_ok & ((best < (ratio * ratio) * second)
                   | ~torch.isfinite(second))

    src = pts_j
    dst = frame_i.pts3[nn]
    R, t, inl, ok = ransac_rigid(key, src, dst, m_ok, n_hyp=n_hyp,
                                 inlier_thresh=inlier_thresh,
                                 min_inliers=min_inliers)
    info = vo_information(R, t, inl, src, sigma=point_sigma)
    return R, t, info, inl, nn, ok


def refine_edge_ba(key, frame_i: FeatureFrame, frame_j: FeatureFrame,
                   T_init, cal, radius: float = 0.15,
                   min_inliers: int = 6, **ba_kw):
    """Guided re-match + two-frame BA: the full ``matchNodePairBA`` ->
    ``bundleAdjust`` chain (gtsam_graph.cpp:500-610). The BA runs on the
    frames' device unless ``device=`` says otherwise.

    Returns ((R, t), info6x6, chi2) or None when the guided match fails
    (the reference aborts below 4 matches, ``:519``).
    """
    from .ba import two_frame_ba

    R, t, _, inl, nn, ok = to_host(match_under_prior(
        key, frame_i, frame_j, T_init, radius=radius,
        min_inliers=min_inliers))
    if not bool(ok):
        return None
    sel = np.nonzero(inl)[0]
    nn = nn[sel]                  # j-feature sel[k] <-> i-feature nn[k]
    pts_i, uv_i, uv_j = to_host((frame_i.pts3, frame_i.uv, frame_j.uv))
    ba_kw.setdefault("device", frame_i.uv.device)
    return two_frame_ba(pts_i[nn], uv_i[nn], uv_j[sel], cal, (R, t),
                        **ba_kw)


def get_extractor(features: str = "harris"):
    """Feature-extractor dispatch: ``harris`` (patch descriptors) or
    ``sift`` (DoG keypoints + rotation/scale-invariant descriptors).
    Both return a ``FeatureFrame`` with the same fixed-shape semantics and
    take ``device=`` for host images."""
    if features == "harris":
        from .features import extract_features
        return extract_features
    if features == "sift":
        from .sift import sift_features
        return sift_features
    raise ValueError(f"unknown feature extractor {features!r} (harris|sift)")


def make_feature_cache(frames, K, max_features: int = 256,
                       features: str = "harris", *, device=None):
    """``seq_id -> FeatureFrame | None`` with per-sequence memoization.

    The shared lazy extraction closure behind every frame-source-driven
    tool (``make_ba_fn``, ``tools.make_frame_matcher``): ``frames`` maps a
    sequence id to ``(intensity, depth) | None``; features are extracted
    on ``device`` (``None``: the card).
    """
    extract = get_extractor(features)
    device = resolve(device)
    cache: dict = {}

    def feat(seq):
        if seq not in cache:
            fr = frames(seq)
            cache[seq] = None if fr is None else extract(
                K, fr[0], fr[1], max_features=max_features, device=device)
        return cache[seq]

    return feat


def make_ba_fn(frames, K, seed: int = 0, max_features: int = 256,
               radius: float = 0.15, *, device=None):
    """Build the ``convert_vo2ba`` refinement closure from a frame source.

    ``frames``: ``seq_id -> (intensity, depth) | None`` (e.g. a
    FrameStore). Features are extracted lazily on ``device`` (``None``:
    the card) and cached per sequence id; each edge is refined by guided
    re-matching under its logged transform followed by two-frame BA. Edge
    n's RANSAC draw is keyed ``(seed, n)``.
    """
    device = resolve(device)
    feat = make_feature_cache(frames, K, max_features=max_features,
                              device=device)
    calls = [0]

    def ba_fn(id_from, id_to, xi_init, valid):
        fi, fj = feat(id_from), feat(id_to)
        if fi is None or fj is None:
            return None
        xi = torch.as_tensor(np.asarray(xi_init, np.float64))
        T0 = se3.expmap(xi) if valid else se3.identity(device="cpu")
        key = (seed, calls[0])
        calls[0] += 1
        out = refine_edge_ba(key, fi, fj, (T0.R, T0.t), K, radius=radius)
        if out is None:
            return None
        (R, t), info, _ = out
        xi = se3.logmap(se3.Pose(torch.as_tensor(R), torch.as_tensor(t)))
        return xi.numpy(), info

    return ba_fn


def match_one_to_many(key, new_frame: FeatureFrame,
                      candidates: FeatureFrame, n_hyp: int = 2048,
                      inlier_thresh: float = 0.05, ratio: float = 0.8,
                      min_inliers: int = 12, point_sigma: float = 0.01):
    """Batched loop-closure matching: new frame vs a stacked candidate
    window (leading axis = candidate, ``features.stack_frames``). One
    batched computation replaces the reference's thread-pool
    ``QtConcurrent::blockingMapped``; candidate c draws with
    ``key + (c,)``. Returns (R, t, info, n_inliers, ok), each with the
    candidate axis in front."""
    n_cand = candidates.uv.shape[0]
    key = tuple(key) if isinstance(key, (tuple, list)) else (key,)
    dev = new_frame.pts3.device
    u = torch.cat([uniforms(key + (c,), (1, n_hyp, 3), dev)
                   for c in range(n_cand)])
    desc_j = new_frame.desc.expand(n_cand, -1, -1)
    idx, m_ok = _match_descriptors_b(desc_j, candidates.desc, ratio=ratio)
    rows = torch.arange(n_cand, device=dev)[:, None]
    src = new_frame.pts3.expand(n_cand, -1, -1)
    dst = candidates.pts3[rows, idx]
    valid = m_ok & new_frame.valid & candidates.valid[rows, idx]
    R, t, inl, ok = _ransac_rigid_b(u, src, dst, valid, inlier_thresh,
                                    min_inliers)
    info = vo_information(R, t, inl, src, sigma=point_sigma)
    return R, t, info, torch.sum(inl, dim=-1), ok
