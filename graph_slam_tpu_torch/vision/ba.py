"""Two-frame bundle adjustment and shared-landmark track bookkeeping (port
of ``vision/ba.py``).

``two_frame_ba`` is ``CGraphGT::bundleAdjust``: a mini factor graph with a
near-exact prior on frame 0 (sigma 1e-7), a Point3 prior per match (sigma
0.014) and two Cal3DS2 projection factors per match (pixel sigma 1),
LM-optimized; it returns the optimized relative pose and the edge
information, the inverse marginal covariance of pose 1.

``TrackBook`` is the global BA insertion's ``mv_feature_qid`` bookkeeping:
feature observations across frames merge into point-landmark tracks (plain
Python, a copy of the reference's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve
from ..graph.builder import GraphBuilder
from ..graph.lm import LMParams, lm_optimize
from ..graph.marginals import pose_marginal

__all__ = ["two_frame_ba", "TrackBook"]


def two_frame_ba(pts_i, uv_i, uv_j, cal, T_ij_init, body_pose=None,
                 point_sigma: float = 0.014, pixel_sigma: float = 1.0,
                 pose_prior_sigma: float = 1e-7,
                 lm_params: LMParams = LMParams(), bucket: int = 64, *,
                 device=None, dtype=torch.float64):
    """Refine a two-frame relative pose from matched 3D points + pixels.

    Args:
      pts_i: (N, 3) 3D points in frame i's camera frame.
      uv_i, uv_j: (N, 2) pixel observations in frames i and j.
      cal: ``CameraIntrinsics`` / Cal3DS2-like intrinsics or a 9-tuple.
      T_ij_init: initial relative pose (R, t) of frame j in frame i.

    Runs on ``device`` (``None``: the CUDA card). Returns
    ``((R, t) numpy, info (6, 6) numpy, final_chi2)``.
    """
    device = resolve(device)
    pts_i = np.asarray(pts_i, np.float64)
    b = GraphBuilder()
    b.add_pose((np.eye(3), np.zeros(3)))          # s0 anchored
    b.add_pose(T_ij_init)                          # s1 = initial T_ij
    b.add_prior_pose(0, (np.eye(3), np.zeros(3)),
                     sigmas=np.full(6, pose_prior_sigma))
    for k in range(len(pts_i)):
        q = b.add_point(pts_i[k])
        b.add_prior_point(q, pts_i[k], sigma=point_sigma)
        b.add_projection_factor(0, q, np.asarray(uv_i[k]), cal,
                                body_pose=body_pose, sigma=pixel_sigma)
        b.add_projection_factor(1, q, np.asarray(uv_j[k]), cal,
                                body_pose=body_pose, sigma=pixel_sigma)
    graph, values = b.build(bucket=bucket, device=device, dtype=dtype)
    res = lm_optimize(graph, values, lm_params)
    cov = pose_marginal(graph, res.values, 1).cpu().numpy()
    R = res.values.pose_R[1].cpu().numpy()
    t = res.values.pose_t[1].cpu().numpy()
    return (R, t), np.linalg.inv(cov), float(res.error)


@dataclasses.dataclass
class TrackBook:
    """Feature-track -> point-landmark id bookkeeping across frames.

    ``feature_qid[frame]`` maps local feature index -> landmark id, the
    reference's ``mv_feature_qid``. ``merge`` processes (feat_i, feat_j)
    matches between two frames, assigning or propagating landmark ids.
    """

    next_qid: int = 0

    def __post_init__(self):
        self.feature_qid: dict[int, dict[int, int]] = {}

    def _get(self, frame: int) -> dict[int, int]:
        return self.feature_qid.setdefault(frame, {})

    def merge(self, frame_i: int, frame_j: int, matches):
        """One event per match: ("new", qid) | ("extend_i", qid) |
        ("extend_j", qid) | ("seen", qid) — a new landmark, a factor on
        one side, or an observation already in the graph."""
        fi = self._get(frame_i)
        fj = self._get(frame_j)
        events = []
        for (a, c) in matches:
            qa = fi.get(a, -1)
            qc = fj.get(c, -1)
            if qa < 0 and qc < 0:
                qid = self.next_qid
                self.next_qid += 1
                fi[a] = fj[c] = qid
                events.append(("new", qid))
            elif qa < 0:
                fi[a] = qc
                events.append(("extend_i", qc))
            elif qc < 0:
                fj[c] = qa
                events.append(("extend_j", qa))
            else:
                events.append(("seen", qa))
        return events
