"""VRO-log transformation tools (the reference's gtsam/test utilities;
port of ``tools/vro_tools.py``).

Twins of (SURVEY.md §2.6):
- ``convert_vo2ba.cpp`` (``:96-166``): rewrite a VRO log under the ``ba`` /
  ``hybrid`` / ``cut`` models — re-estimating edges with two-frame BA,
  falling back to VRO, or voiding weak edges (``makeItVoid`` = identity
  transform + sentinel information);
- ``merge_vro.cpp``: merge a BA log with a VRO log by per-edge match count;
- ``compute_trans_difference.cpp``: per-edge difference of two logs;
- ``delete_vo_by_plane_check.cpp``: void edges failing plane consistency;
- ``add_vo_at_sparse_area.cpp``: propose extra edges around feature-sparse
  frames and append the ones a matcher validates.

All operate on the columnar ``VROLog``; edge voiding preserves the
reference's exact encoding (zero transform, ``info = 1e4 * I``). The log
tools are host numpy; ``compute_trans_difference`` and the frame matcher
compute on ``device`` (``None``: the CUDA card).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core import se3
from ..device import resolve, to_host
from ..io.vro_log import FAILED_INFO_SENTINEL, VROLog

__all__ = ["void_edge", "convert_vo2ba", "merge_vro",
           "compute_trans_difference", "delete_vo_by_plane_check",
           "propose_sparse_area_edges", "add_vo_at_sparse_area",
           "make_frame_matcher"]


def void_edge(log: VROLog, k: int) -> None:
    """makeItVoid: identity transform + sentinel information."""
    log.xi[k] = 0.0
    log.info[k] = np.eye(6) * FAILED_INFO_SENTINEL


def convert_vo2ba(log: VROLog, mode: str,
                  ba_fn: Optional[Callable] = None,
                  match_counts: Optional[np.ndarray] = None,
                  min_match_num: int = 10) -> VROLog:
    """Rewrite a VRO log under the ba/hybrid/cut models.

    Args:
      mode: "cut" voids valid edges whose match count < min_match_num;
        "ba" replaces every edge by ``ba_fn``'s estimate, voiding edges BA
        cannot refine; "hybrid" tries BA and keeps the original VRO edge
        when BA fails (voiding only if the original was already failed).
      ba_fn: ``(id_from, id_to, xi_init, valid) -> (xi, info) | None`` —
        typically a closure over ``vision.two_frame_ba``.
      match_counts: per-edge inlier counts (the ``input_match.log`` stream).
    """
    out = VROLog(log.id_to.copy(), log.id_from.copy(), log.xi.copy(),
                 log.info.copy())
    valid = log.valid
    for k in range(len(log)):
        if mode == "cut":
            if valid[k] and match_counts is not None \
                    and match_counts[k] < min_match_num:
                void_edge(out, k)
        elif mode in ("ba", "hybrid"):
            res = ba_fn(int(log.id_from[k]), int(log.id_to[k]),
                        log.xi[k], bool(valid[k])) if ba_fn else None
            if res is not None:
                out.xi[k], out.info[k] = res
            elif mode == "ba" and valid[k]:
                void_edge(out, k)
            # hybrid: keep the VRO edge on BA failure
        else:
            raise ValueError(f"unknown model {mode!r}")
    return out


def merge_vro(log_ba: VROLog, log_vro: VROLog, match_counts,
              thresh: int = 20) -> VROLog:
    """merge_vro.cpp: below ``thresh`` matches, prefer the VRO edge."""
    assert len(log_ba) == len(log_vro)
    out = VROLog(log_ba.id_to.copy(), log_ba.id_from.copy(),
                 log_ba.xi.copy(), log_ba.info.copy())
    vro_valid = log_vro.valid
    for k in range(len(log_ba)):
        if match_counts[k] < thresh and vro_valid[k]:
            out.xi[k] = log_vro.xi[k]
            out.info[k] = log_vro.info[k]
    return out


def compute_trans_difference(log1: VROLog, log2: VROLog, *, device=None):
    """Per-edge pose difference: (dt_norm, dtheta_rad) arrays.

    Edges are matched by (id_from, id_to); unmatched rows get NaN. The
    poses are composed in float64 on ``device`` (``None``: the card).
    """
    dev = resolve(device)
    idx2 = {(int(f), int(t)): k for k, (f, t) in
            enumerate(zip(log2.id_from, log2.id_to))}
    dt = np.full(len(log1), np.nan)
    dr = np.full(len(log1), np.nan)
    pairs = [(k, idx2.get((int(log1.id_from[k]), int(log1.id_to[k]))))
             for k in range(len(log1))]
    pairs = [(k, j) for k, j in pairs if j is not None]
    if not pairs:
        return dt, dr
    k1, k2 = (np.asarray(c) for c in zip(*pairs))

    def poses(xi):
        return se3.expmap(torch.as_tensor(np.asarray(xi, np.float64),
                                          device=dev))

    xi = to_host(se3.logmap(se3.between(poses(log1.xi[k1]),
                                        poses(log2.xi[k2]))))
    dr[k1] = np.linalg.norm(xi[:, :3], axis=1)
    dt[k1] = np.linalg.norm(xi[:, 3:], axis=1)
    return dt, dr


def delete_vo_by_plane_check(log: VROLog, plane_scores,
                             err_thresh: float) -> VROLog:
    """Void valid edges whose plane-consistency score exceeds the threshold
    (delete_vo_by_plane_check.cpp semantics)."""
    out = VROLog(log.id_to.copy(), log.id_from.copy(), log.xi.copy(),
                 log.info.copy())
    valid = log.valid
    for k in range(len(log)):
        if valid[k] and plane_scores[k] > err_thresh:
            void_edge(out, k)
    return out


def propose_sparse_area_edges(feature_counts: dict, window: int = 5,
                              sparse_thresh: int = 60):
    """Candidate extra edges around feature-sparse frames
    (add_vo_at_sparse_area.cpp role): for every sparse frame, propose pairs
    to all frames within ``window``."""
    seqs = sorted(feature_counts)
    out = []
    for s in seqs:
        if feature_counts[s] >= sparse_thresh:
            continue
        for o in range(2, window + 1):
            if s - o in feature_counts:
                out.append((s - o, s))
            if s + o in feature_counts:
                out.append((s, s + o))
    return sorted(set(out))


def make_frame_matcher(frames, K, seed: int = 0, max_features: int = 256,
                       feature_cache=None, *, device=None):
    """Self-contained ``matcher`` for ``add_vo_at_sparse_area``: extract
    features lazily per frame on ``device`` (``None``: the card), match
    with the batched RANSAC frontend (pair n's draw keyed ``(seed, n)``),
    and return ``(xi, info)`` for validated pairs (test_match_two_frames
    role). ``feature_cache`` reuses an existing ``make_feature_cache``
    closure so a caller that already extracted features (the sparse-count
    pass of the CLI driver) doesn't pay extraction twice per frame.
    """
    from ..vision.frontend import make_feature_cache, match_frames_device

    feat = feature_cache if feature_cache is not None else \
        make_feature_cache(frames, K, max_features=max_features,
                           device=device)
    calls = [0]

    def matcher(id_from, id_to):
        fi, fj = feat(id_from), feat(id_to)
        if fi is None or fj is None:
            return None
        key = (seed, calls[0])
        calls[0] += 1
        R, t, info, _, ok = to_host(match_frames_device(key, fi, fj))
        if not bool(ok) or not np.isfinite(info).all():
            return None
        xi = se3.logmap(se3.Pose(torch.as_tensor(R), torch.as_tensor(t)))
        return xi.numpy(), info

    return matcher


def add_vo_at_sparse_area(log: VROLog, feature_counts: dict,
                          matcher: Callable, window: int = 5,
                          sparse_thresh: int = 60) -> VROLog:
    """Append matcher-validated extra edges at sparse areas.

    ``matcher(id_from, id_to) -> (xi, info) | None`` — e.g.
    ``make_frame_matcher(frames, K)`` for a self-contained run.
    """
    existing = {(int(f), int(t)) for f, t in zip(log.id_from, log.id_to)}
    new_rows = []
    for (i, j) in propose_sparse_area_edges(feature_counts, window,
                                            sparse_thresh):
        if (i, j) in existing:
            continue
        res = matcher(i, j)
        if res is None:
            continue
        xi, info = res
        new_rows.append((j, i, xi, info))
    if not new_rows:
        return log
    return VROLog(
        np.concatenate([log.id_to, [r[0] for r in new_rows]]),
        np.concatenate([log.id_from, [r[1] for r in new_rows]]),
        np.concatenate([log.xi, np.stack([r[2] for r in new_rows])]),
        np.concatenate([log.info, np.stack([r[3] for r in new_rows])]),
    )
