"""Online RGB-D SLAM: feature frontend + keyframing + loop closures (port
of ``pipelines/online_slam.py``).

Twin of the reference's ONLINE pipeline (``test_gt_graph.cpp:38-130``
with ``CGraphGT::addNode`` gtsam_graph.cpp:1670-1766, and the g2o variant
``g2o/test_g2o_graph.cpp``):

  frame -> feature extraction -> match vs previous keyframe
    - small motion (t < 0.05 m AND theta < 3 deg)   -> drop frame
    - large motion (t > 2 m OR theta > 20 deg)      -> reject as outlier
    - match failure                                  -> fakeOdoNode
      (identity edge, info 1e4*I gtsam / 1e-3*I g2o, gtsam_graph.cpp:697-722,
       g2o_graph.cpp:151)
    - else VO edge; then loop closures against the last ``lookback``
      keyframes — the reference's QtConcurrent thread-pool map
      (gtsam_graph.cpp:1730-1731) becomes one batch on the device
      (``match_one_to_many``), and the JAX package's global tier
      (``global_loop_k``) another;
  every ``optimize_step`` keyframes: batch LM on the live arenas.

Features, matches and the arenas live on ``device`` (``None``: the card).
Each match's R, t, information and verdict come back to the host in one
copy, for the keyframe decisions the reference makes there. The RANSAC
draws are keyed ``(seed, n)``, n counting the matches made (a candidate
batch appends the candidate's index), not split from a JAX key, so they
differ from the reference's. ``timers`` accumulates the host wall time of
the phases ``extract``, ``odometry``, ``lookback``, ``place`` and
``optimize``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..config import CameraIntrinsics, SlamParams
from ..core import se3, so3
from ..device import resolve, to_host
from ..graph.builder import _sqrt_info, round_up
from ..graph.factors import empty_graph
from ..graph.lm import LMParams, lm_optimize
from ..graph.online import OnlineGraph
from ..graph.variables import empty_arena
from ..io.vro_log import FAILED_INFO_SENTINEL, VROLog, write_vro_log
from ..utils.profiling import Chi2Log, PhaseTimer
from ..vision.features import FeatureFrame, stack_frames
from ..vision.frontend import (get_extractor, match_frames_device,
                               match_one_to_many)

__all__ = ["OnlineSlam", "FrameStatus"]

# the arenas' dtype: the reference's sessions run under x64 (the features
# are float32 in both)
_DTYPE = torch.float64


class FrameStatus:
    FIRST = "first"
    KEYFRAME = "keyframe"
    SMALL_MOTION = "small_motion"      # dropped, not a keyframe
    FAILED = "failed"                   # fake odometry inserted


def _motion_magnitude(R, t):
    dist = float(np.linalg.norm(np.asarray(t)))
    tr = float(np.trace(np.asarray(R)))
    ang = math.degrees(math.acos(max(-1.0, min(1.0, (tr - 1.0) * 0.5))))
    return dist, ang


@dataclasses.dataclass
class OnlineSlam:
    """Stateful online SLAM session (CGraphGT + frontend roles)."""

    cam: CameraIntrinsics
    params: SlamParams = dataclasses.field(default_factory=SlamParams)
    backend: str = "gtsam"            # "gtsam" | "g2o" (fake-odo weighting)
    max_features: int = 256
    n_hyp: int = 2048
    inlier_thresh: float = 0.05
    min_inliers: int = 12
    seed: int = 0
    initial_pose_cap: int = 128   # arena start size; doubles on overflow
    features: str = "harris"      # "harris" | "sift" frontend (vision/)
    # global place-recognition loop closures (vision/place.py): try the
    # top-k most similar keyframes OLDER than the lookback window each
    # keyframe; 0 disables (the reference has no global tier)
    global_loop_k: int = 0
    global_loop_min_gap: int = 10  # proposals must be this many KFs old
    device: object = None          # None: the CUDA card

    def __post_init__(self):
        # preallocated online arenas: appends are row writes, the
        # optimizer runs on the live tensors with no host rebuild
        self._device = resolve(self.device)
        self._pose_cap = self.initial_pose_cap
        self.og = OnlineGraph(
            empty_graph(prior_pose_cap=2,
                        between_cap=self._between_cap(self._pose_cap),
                        dtype=_DTYPE, device=self._device),
            empty_arena(pose_cap=self._pose_cap, dtype=_DTYPE,
                        device=self._device))
        self.frames: list[FeatureFrame] = []   # keyframe feature frames
        self.seq_ids: list[int] = []
        self.records: list[tuple] = []          # VRO log rows
        self._draws = 0
        self._values = None
        self._n_since_opt = 0
        self._sequence = 0
        self._extract = get_extractor(self.features)
        self._places = None
        if self.global_loop_k > 0:
            from ..vision.place import PlaceIndex
            self._places = PlaceIndex(seed=self.seed)
        self.chi2_log = Chi2Log()
        self.timers = PhaseTimer()

    def _between_cap(self, pose_cap: int) -> int:
        return round_up(pose_cap * (self.params.lookback_nodes + 1), 64)

    def _ensure_capacity(self):
        bt_cap = self.og.graph.between.i.shape[0]
        if (len(self.frames) + 1 >= self._pose_cap
                or self.og._n["between"] + self.params.lookback_nodes + 2
                >= bt_cap):
            self._pose_cap *= 2
            self.og.grow(pose_cap=self._pose_cap, factor_caps={
                "between": self._between_cap(self._pose_cap)})

    # ------------------------------------------------------------------
    def _next_key(self):
        self._draws += 1
        return (self.seed, self._draws - 1)

    @property
    def num_keyframes(self) -> int:
        return len(self.frames)

    def _fake_info(self):
        scale = 1e4 if self.backend == "gtsam" else 1e-3
        return np.eye(6) * scale

    def _record(self, id_to, id_from, T, info):
        """One VRO log row; the tangent is taken on the host in the
        transform's own dtype, as the reference takes it."""
        xi = se3.logmap(se3.Pose(torch.as_tensor(np.asarray(T[0])),
                                 torch.as_tensor(np.asarray(T[1]))))
        self.records.append((id_to, id_from, xi.numpy(), np.asarray(info)))

    def _pose(self, R, t):
        return se3.Pose(R.to(_DTYPE), t.to(_DTYPE))

    def _add_keyframe(self, frame, seq_id):
        self.frames.append(frame)
        self.seq_ids.append(seq_id)
        if self._places is not None:
            with self.timers("place"):
                self._places.add(frame)

    def _accept(self, info_h, R_h, t_h) -> bool:
        """A loop-closure verdict on the host copies."""
        d, a = _motion_magnitude(R_h, t_h)
        if d > self.params.large_translation \
                or a > self.params.large_rotation:
            return False
        return bool(np.isfinite(info_h).all())

    # ------------------------------------------------------------------
    def process_frame(self, intensity, depth, seq_id: Optional[int] = None):
        """Feed one RGB-D frame (host arrays or tensors); returns a
        FrameStatus."""
        if seq_id is None:
            seq_id = self._sequence
        self._sequence += 1
        with self.timers("extract"):
            frame = self._extract(self.cam, intensity, depth,
                                  max_features=self.max_features,
                                  device=self._device)

        if not self.frames:
            ident = se3.identity(dtype=_DTYPE, device=self._device)
            self.og.set_pose(0, ident)
            self.og.add_prior_pose(0, ident,
                                   _sqrt_info(6, sigmas=np.full(6, 1e-7)))
            self._add_keyframe(frame, seq_id)
            return FrameStatus.FIRST

        # -- odometry match vs the previous keyframe --------------------
        prev = self.frames[-1]
        with self.timers("odometry"):
            R, t, info, _, ok = match_frames_device(
                self._next_key(), prev, frame, n_hyp=self.n_hyp,
                inlier_thresh=self.inlier_thresh,
                min_inliers=self.min_inliers)
            R_h, t_h, info_h, ok_h = to_host((R, t, info, ok))

        gi = len(self.frames) - 1
        self._ensure_capacity()
        if not bool(ok_h) or not np.isfinite(info_h).all():
            # total failure -> fake odometry keyframe (fakeOdoNode)
            gj = gi + 1
            self.og.set_pose(gj, self.og.pose(gi))
            ident = se3.identity(dtype=_DTYPE, device=self._device)
            self.og.add_between(gi, gj, ident,
                                _sqrt_info(6, information=self._fake_info()))
            self._record(seq_id, self.seq_ids[-1], (np.eye(3), np.zeros(3)),
                         np.eye(6) * FAILED_INFO_SENTINEL)
            self._add_keyframe(frame, seq_id)
            self._after_keyframe()
            return FrameStatus.FAILED

        dist, ang = _motion_magnitude(R_h, t_h)
        if dist < self.params.small_translation \
                and ang < self.params.small_rotation:
            return FrameStatus.SMALL_MOTION
        if dist > self.params.large_translation \
                or ang > self.params.large_rotation:
            # outlier transform: treat like a failure (reference rejects it)
            return FrameStatus.SMALL_MOTION

        # accept keyframe + odometry edge
        meas = self._pose(R, t)
        gj = gi + 1
        self.og.set_pose(gj, se3.compose(self.og.pose(gi), meas))
        self.og.add_between(gi, gj, meas, _sqrt_info(6, information=info_h))
        self._record(seq_id, self.seq_ids[-1], (R_h, t_h), info_h)

        # -- loop closures: one batch over the lookback window ----------
        lb = min(self.params.lookback_nodes, gi)
        if lb > 1:
            with self.timers("lookback"):
                cands = stack_frames(self.frames[gi - lb:gi - 1])
                Rs, ts, infos, _, oks = match_one_to_many(
                    self._next_key(), frame, cands, n_hyp=self.n_hyp,
                    inlier_thresh=self.inlier_thresh,
                    min_inliers=self.min_inliers)
                host = to_host((Rs, ts, infos, oks))
                for c in range(lb - 1):   # the predecessor is not a loop
                    ci = gi - lb + c
                    if not bool(host[3][c]) or not self._accept(
                            host[2][c], host[0][c], host[1][c]):
                        continue
                    self.og.add_between(
                        ci, gj, self._pose(Rs[c], ts[c]),
                        _sqrt_info(6, information=host[2][c]))
                    self._record(seq_id, self.seq_ids[ci],
                                 (host[0][c], host[1][c]), host[2][c])

        # -- global loop closures: place-recognition proposals beyond the
        # lookback window (vision/place.py; no reference counterpart) --
        if self._places is not None:
            with self.timers("place"):
                cand_ids, _ = self._places.query(
                    frame, top_k=self.global_loop_k,
                    max_id=gj - self.global_loop_min_gap + 1)
                cand_ids = [int(c) for c in cand_ids]
                if cand_ids:
                    Rg, tg, infog, _, okg = match_one_to_many(
                        self._next_key(), frame,
                        stack_frames([self.frames[c] for c in cand_ids]),
                        n_hyp=self.n_hyp, inlier_thresh=self.inlier_thresh,
                        min_inliers=self.min_inliers)
                    host = to_host((Rg, tg, infog, okg))
                for c, ci in enumerate(cand_ids):
                    if not bool(host[3][c]) or not self._accept(
                            host[2][c], host[0][c], host[1][c]):
                        continue
                    self.og.add_between(
                        ci, gj, self._pose(Rg[c], tg[c]),
                        _sqrt_info(6, information=host[2][c]))
                    self._record(seq_id, self.seq_ids[ci],
                                 (host[0][c], host[1][c]), host[2][c])

        self._add_keyframe(frame, seq_id)
        self._after_keyframe()
        return FrameStatus.KEYFRAME

    # ------------------------------------------------------------------
    def _after_keyframe(self):
        self._n_since_opt += 1
        if self._n_since_opt >= self.params.optimize_step:
            self.optimize()

    def optimize(self, lm_params: Optional[LMParams] = None):
        """Batch optimize on the live arenas (optimizeGraphBatch) — no
        host rebuild; the optimized values become the estimator state.
        Logs chi2 before/after (the test_gt_graph.cpp:113-117 pattern).

        The g2o backend runs a flat 20 LM iterations with no convergence
        test (``CGraphG2O::optimizeGraph``, g2o_graph.cpp:241-252); gtsam
        uses the GTSAM default stopping rules.
        """
        if lm_params is None:
            lm_params = (LMParams(max_iterations=20, relative_error_tol=0.0,
                                  absolute_error_tol=0.0)
                         if self.backend == "g2o" else LMParams())
        before = self.og.error()
        with self.timers("optimize"):
            res = lm_optimize(self.og.graph, self.og.values, lm_params)
            error = float(res.error)
        self.og.values = res.values
        self._values = res.values
        self._n_since_opt = 0
        self.chi2_log.add(self._sequence, len(self.frames), before, error)
        return error

    def error(self) -> float:
        return self.og.error()

    # -- outputs ---------------------------------------------------------
    def trajectory(self, w2o: se3.Pose | None = None):
        """(ids, t (n, 3), q (n, 4) wxyz, seq_ids) numpy of the keyframes,
        optionally moved by ``w2o`` (world to origin)."""
        n = len(self.frames)
        P = se3.Pose(self.og.values.pose_R[:n], self.og.values.pose_t[:n])
        if w2o is not None:
            w = se3.Pose(*(torch.as_tensor(x).to(P.t) for x in w2o))
            P = se3.compose(se3.Pose(w.R.expand_as(P.R), w.t.expand_as(P.t)),
                            P)
        t, q = to_host((P.t, so3.matrix_to_quat(P.R)))
        return np.arange(n), t, q, np.asarray(self.seq_ids)

    def vro_log(self) -> VROLog:
        if not self.records:
            return VROLog(np.zeros(0, int), np.zeros(0, int),
                          np.zeros((0, 6)), np.zeros((0, 6, 6)))
        return VROLog(
            np.asarray([r[0] for r in self.records]),
            np.asarray([r[1] for r in self.records]),
            np.stack([r[2] for r in self.records]),
            np.stack([r[3] for r in self.records]),
        )

    def save_vro_log(self, path: str):
        write_vro_log(path, self.vro_log())
