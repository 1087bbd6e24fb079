"""Plane-stack plumbing of the VIO pipeline (port of
``pipelines/vio_planes.py``).

The host-side plane state machine of ``test_vro_imu_graph.cpp``:
firstPlaneNode, the rescue block and the addPlaneFactor /
planeNodeAssociation split, written into either engine's live
``OnlineGraph`` arenas; and ``_OnlineVioGraph``, the online engine's
arenas sized from the log with their builder-shaped writers.

A rescue enqueues its device work (the plane prediction, whose flood
fill is the CUDA region grow on the card), then reads every result it
needs with one host sync (``device.to_host``); the association and the
covariance repair run on the host, and the new landmarks and factor rows
are staged and written in one batch each. The camera ->
body projections of host detections run on the CPU in float64. The frames'
device work runs in the arena's dtype (``plane_node``'s note on
precision).

Both engines write the same arena type, so the stack writes the
``OnlineGraph`` directly (its growth policy is ``_PlaneStack._grow``); the
reference's writer layer (``_PlaneWriterMixin``, ``_append_planes_batch``)
has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SlamParams
from ..core import se3
from ..device import resolve, to_host
from ..graph.builder import _sqrt_info, round_up
from ..graph.factors import empty_graph
from ..graph.online import OnlineGraph
from ..graph.variables import empty_arena
from ..planes import (PlaneLandmarkBook, extract_plane_node,
                      extract_plane_nodes_batch, inflate_if_uncertain,
                      predict_plane_node_finish, predict_plane_node_start,
                      repair_plane_cov, transform_plane_cov)
from .vio_types import VioConfig

__all__ = ["_OnlineVioGraph", "_PlaneStack", "_transform_plane_covs_batch"]


class _OnlineVioGraph:
    """The online engine's graph: one preallocated ``OnlineGraph`` (``og``)
    sized from the log, with builder-shaped writers: the variable writers
    append and return the index, the priors take their noise model as
    ``sigma``, ``sigmas``, ``information`` or ``sqrt_info``
    (``graph.builder``).

    ``P = round_up(n_frames, bucket)`` poses, velocities, biases and IMU
    rows; ``round_up(n_edges + 4, bucket)`` between rows;
    ``round_up(plane_factor_cap, bucket)`` plane rows; four rows of each
    prior; ``plane_var_cap`` landmarks (``_PlaneStack`` grows the plane
    arenas past theirs). On ``device`` (``None``: the card) in ``dtype``.
    """

    def __init__(self, n_frames: int, n_edges: int, bucket: int,
                 plane_var_cap: int, plane_factor_cap: int, *, device=None,
                 dtype=torch.float64):
        device = resolve(device)
        P = round_up(n_frames, bucket)
        self.og = OnlineGraph(
            empty_graph(prior_pose_cap=4,
                        between_cap=round_up(n_edges + 4, bucket),
                        prior_vel_cap=4, prior_bias_cap=4,
                        plane_cap=round_up(plane_factor_cap, bucket),
                        imu_cap=P, dtype=dtype, device=device),
            empty_arena(pose_cap=P, vel_cap=P, bias_cap=P,
                        plane_cap=plane_var_cap, dtype=dtype, device=device))

    # -- variables (appended in order) -----------------------------------
    def add_pose(self, pose: se3.Pose) -> int:
        gid = self.og.num_poses
        self.og.set_pose(gid, pose)
        return gid

    def add_vel(self, v) -> int:
        vid = self.og.num_vels
        self.og.set_vel(vid, v)
        return vid

    def add_bias(self, b) -> int:
        bid = self.og.num_biases
        self.og.set_bias(bid, b)
        return bid

    def pose(self, idx: int) -> se3.Pose:
        return self.og.pose(idx)

    # -- factors ----------------------------------------------------------
    def add_prior_pose(self, idx, pose: se3.Pose, **noise):
        self.og.add_prior_pose(idx, pose, _sqrt_info(6, **noise))

    def add_prior_vel(self, idx, mean, **noise):
        self.og.add_prior_vel(idx, mean, _sqrt_info(3, **noise))

    def add_prior_bias(self, idx, mean, **noise):
        self.og.add_prior_bias(idx, mean, _sqrt_info(6, **noise))

    def add_between(self, i, j, meas: se3.Pose, sqrt_info, robust=None):
        """A VO edge or loop closure (``sqrt_info`` as the engine
        precomputed it, ``vio_kernel._host_edges``)."""
        self.og.add_between(i, j, meas, sqrt_info, robust=robust)

    def add_imu_factor(self, i, j, preint, gravity):
        self.og.add_imu_factor(i, j, preint, gravity)


def _transform_plane_covs_batch(planes, covs, pose: se3.Pose):
    """A host detection's camera -> body projections, on the CPU in float64
    (``pose`` a float64 CPU pose): numpy in, numpy out."""
    pb, cb = transform_plane_cov(
        torch.from_numpy(np.array(planes, np.float64)),
        torch.from_numpy(np.array(covs, np.float64)), pose)
    return pb.numpy(), cb.numpy()


class _PlaneStack:
    """Host-side plane bookkeeping of the scan engine's rescue: the plane
    state machine of test_vro_imu_graph.cpp (firstPlaneNode, the
    rescue block, the addPlaneFactor / planeNodeAssociation split) over the
    live ``OnlineGraph`` ``og``, whose landmark arena and plane-factor
    table it grows past capacity (``_grow``). ``device`` and ``dtype``
    (the arena's) are where and in what the frames' work runs; ``pt`` (a
    ``PhaseTimer``) times the rescue's sub-phases."""

    def __init__(self, og: OnlineGraph, cfg: VioConfig, params: SlamParams,
                 intrinsics, u2c, frames, provider, device, dtype, pt):
        self.og = og
        self.cfg = cfg
        self.K = intrinsics
        self.device = device
        self.dtype = dtype
        # None = identity (the prediction then skips the conjugation)
        self.u2c = None if u2c is None else se3.Pose(
            u2c.R.to(device, torch.float64), u2c.t.to(device, torch.float64))
        host = se3.identity(device="cpu") if u2c is None else se3.Pose(
            u2c.R.detach().cpu().double(), u2c.t.detach().cpu().double())
        self._u2c_inv = se3.inverse(host)     # the host projections' pose
        self.frames = frames
        self.provider = provider
        self.book = PlaneLandmarkBook(lookback=params.lookback_nodes)
        self.plane_nodes: dict[int, object] = {}  # gid -> detection | None
        self.pending: dict[int, object] = {}      # pre-extracted, no factors
        self.pt = pt
        self.n_plane = 0
        self.n_predict = 0        # predictions run: one propagation each
        # predictions whose coverage test ran the fresh extraction
        self.n_extract = 0

    def _next_key(self):
        """The draw of the next prediction's fresh extraction: one key per
        call, in call order."""
        self.n_predict += 1
        return (self.cfg.seed, 1, self.n_predict)

    def _extract_key(self, seq):
        """A fresh extraction's draw, keyed by the frame's sequence id (not
        the call order), so the batched pre-extraction and the sequential
        path give the same detections."""
        return (self.cfg.seed, 0, int(seq))

    def insert_plane_obs(self, gid, pose_body: se3.Pose, plane_cam, cov3,
                         rows: list, new_planes: list, lid: int = -1,
                         trace_extra: float = 0.0, pre=None) -> int:
        """Camera-frame plane observation -> landmark id + plane factor
        (``pose_body`` on the host), staged for ``_flush``: the factor row
        in ``rows``, a new landmark in ``new_planes``.

        ``lid >= 0`` skips geometric association (the id was carried by
        plane propagation); returns the landmark id, or -1 when the
        observation is rejected (non-finite, or by the trace gate). ``pre``
        supplies the already-projected (plane_body, cov_body) pair.
        """
        cov3 = np.asarray(cov3)
        if pre is not None:
            pb, cb = pre
        else:
            pb, cb = _transform_plane_covs_batch(plane_cam, cov3,
                                                 self._u2c_inv)
        # an f32 degenerate refit can give a non-finite plane/covariance:
        # one such row would NaN the whole graph's chi2
        if not (np.isfinite(pb).all() and np.isfinite(cb).all()):
            return -1
        trace_snv = float(np.trace(cov3[:2, :2])) + trace_extra
        carried = lid >= 0
        if not carried:
            lid, is_new = self.book.associate(gid, pb, pose_body)
        else:
            is_new = False
        cb, accept = inflate_if_uncertain(np.asarray(cb), trace_snv, is_new)
        if not accept:
            return -1
        if carried:
            # record the re-observation only once the gate accepts it
            self.book.observe(gid, lid)
        S = repair_plane_cov(cb)
        if is_new and self.og.num_planes + len(new_planes) <= lid:
            # new lids are allocated in order by the book, so the staging
            # order is the arena's append order
            new_planes.append((lid, np.asarray(self.book.world[lid])))
        rows.append((gid, lid, np.asarray(pb), _sqrt_info(3, covariance=S)))
        self.n_plane += 1
        return lid

    def provider_obs(self, gid, pose_body: se3.Pose, seq) -> None:
        if self.provider is None:
            return
        rows: list = []
        new_planes: list = []
        for (plane_cam, cov3) in self.provider(seq):
            self.insert_plane_obs(gid, pose_body, plane_cam, cov3, rows,
                                  new_planes)
        self._flush(new_planes, rows)

    def insert_detection(self, gid, pose_body: se3.Pose, det, rows: list,
                         new_planes: list, trace_extra: float = 0.0,
                         transformed=None) -> None:
        """Stage factors for a PlaneNodeDetection, associating unassigned
        planes and writing the resolved landmark ids back in place;
        ``transformed`` supplies the detection's projections."""
        if not len(det):
            return
        if transformed is None:
            transformed = _transform_plane_covs_batch(det.params, det.cov,
                                                      self._u2c_inv)
        pbs, cbs = transformed
        for p in range(len(det)):
            got = self.insert_plane_obs(
                gid, pose_body, det.params[p], det.cov[p], rows, new_planes,
                lid=int(det.landmark_ids[p]), trace_extra=trace_extra,
                pre=(pbs[p], cbs[p]))
            if got >= 0:
                det.landmark_ids[p] = got

    def _grow(self, n_planes: int, n_rows: int) -> None:
        """Re-home the landmark arena and the plane-factor table when
        ``n_planes`` more landmarks or ``n_rows`` more rows do not fit: to
        twice the capacity (at least 8 landmarks, 64 rows, and what is
        needed)."""
        og = self.og
        cap_p = og.values.plane.shape[0]
        cap_f = og.graph.plane.pose_idx.shape[0]
        need_p = og.num_planes + n_planes
        need_f = og._n["plane"] + n_rows
        if need_p > cap_p or need_f > cap_f:
            og.grow(plane_var_cap=max(8, 2 * cap_p, need_p)
                    if need_p > cap_p else None,
                    factor_caps={"plane": max(64, 2 * cap_f, need_f)
                                 if need_f > cap_f else cap_f})

    def _flush(self, new_planes, rows) -> None:
        """Write the staged landmarks, then the factor rows that reference
        them, in one batch each."""
        lid0 = self.og.num_planes
        lids = [lid for lid, _ in new_planes]
        if lids != list(range(lid0, lid0 + len(lids))):
            # writing past this would corrupt row -> landmark addressing
            raise RuntimeError(
                "staged landmark order broke the arena append invariant")
        self._grow(len(new_planes), len(rows))
        if new_planes:
            self.og.set_planes(lids, np.stack([p for _, p in new_planes]))
        if rows:
            self.og.add_plane_factors(
                np.asarray([r[0] for r in rows], np.int64),
                np.asarray([r[1] for r in rows], np.int64),
                np.stack([r[2] for r in rows]),
                np.stack([r[3] for r in rows]))

    def precompute_detections(self, gid2seq: dict) -> None:
        """Batch-extract fresh plane sets of the nodes known upfront to be
        rescue sources. Factors are not inserted here (the node's estimate
        is not known yet); ``rescue`` consumes the pending detection."""
        if self.frames is None:
            return
        items = []
        for gid, seq in sorted(gid2seq.items()):
            if gid in self.plane_nodes or gid in self.pending:
                continue
            fr = self.frames(seq)
            if fr is not None:
                items.append((gid, seq, fr[1]))
        if not items:
            return
        dets = extract_plane_nodes_batch(
            [self._extract_key(seq) for _, seq, _ in items], self.K,
            [d for _, _, d in items], max_planes=self.cfg.max_planes,
            min_support=self.cfg.min_plane_support, device=self.device,
            dtype=self.dtype)
        for (gid, _, _), det in zip(items, dets):
            if det is not None:
                self.pending[gid] = det

    def _extract(self, seq):
        fr = self.frames(seq)
        if fr is None:
            return None
        return extract_plane_node(
            self._extract_key(seq), self.K, fr[1], max_planes=self.cfg.max_planes,
            min_support=self.cfg.min_plane_support, device=self.device,
            dtype=self.dtype)

    def first_node_planes(self, gid, pose_body: se3.Pose, seq) -> None:
        """firstPlaneNode: register node-0 planes as landmarks."""
        if self.frames is None:
            return
        det = self._extract(seq)
        if det is not None:
            rows: list = []
            new_planes: list = []
            self.insert_detection(gid, pose_body, det, rows, new_planes)
            self._flush(new_planes, rows)
            self.plane_nodes[gid] = det

    def rescue(self, gj, est: se3.Pose, seq_to, pre_gid, pre_pose: se3.Pose,
               pre_seq, S_pose) -> None:
        """Frames-driven plane rescue of a VO failure: propagate the
        previous frame's planes through the IMU-predicted relative pose
        from that node's estimate, carry landmark ids, extract fresh planes
        on the uncovered cloud.

        ``est``, ``pre_pose`` and ``S_pose`` are device tensors (the VIO
        step's outputs and the arena). The prediction is enqueued before
        anything is read; then one host sync reads the estimate, the
        covariance and the whole prediction.
        """
        if self.frames is None:
            return
        pt = self.pt
        rows: list = []
        new_planes: list = []

        # -- the pre-node detection (host bookkeeping only) --------------
        pre_det = self.plane_nodes.get(pre_gid)
        # always consume the pre-extracted entry: if the pre-node is a
        # plane node already (an earlier rescue's current node), its
        # pending detection would otherwise keep frame-sized masks alive
        pre_cached = self.pending.pop(pre_gid, None)
        pre_fresh = None          # detection whose factors are not in yet
        if pre_det is None:
            pre_fresh = pre_cached if pre_cached is not None \
                else self._extract(pre_seq)
            pre_det = pre_fresh
        fr = self.frames(seq_to)

        with pt("rescue_enqueue"):
            handle = None
            if fr is not None and pre_det is not None and len(pre_det):
                handle = predict_plane_node_start(
                    self._next_key(), self.K, pre_det, pre_pose.R,
                    pre_pose.t, est.R, est.t, S_pose, fr[0], fr[1],
                    u2c=self.u2c, max_new_planes=self.cfg.max_planes,
                    min_support=self.cfg.min_plane_support)
                # the handle's fresh extraction: None where it was skipped
                self.n_extract += handle[2] is not None
            pre_T = None
            if pre_fresh is not None and len(pre_fresh):
                pre_T = _transform_plane_covs_batch(
                    pre_fresh.params, pre_fresh.cov, self._u2c_inv)

        with pt("rescue_read"):
            est_h, pre_h, S_h, handle = to_host((est, pre_pose, S_pose,
                                                 handle))
        trace_simu = float(np.trace(S_h[:3, :3]))
        if pre_fresh is not None:
            with pt("rescue_pre_insert"):
                self.insert_detection(pre_gid, pre_h, pre_fresh, rows,
                                      new_planes, trace_extra=trace_simu,
                                      transformed=pre_T)
                self.plane_nodes[pre_gid] = pre_fresh
        cur_det, cur_T = None, None
        if fr is not None:
            if handle is not None:
                with pt("rescue_predict"):
                    cur_det, cur_T = predict_plane_node_finish(handle)
            elif pre_det is None or not len(pre_det):
                cur_det = self._extract(seq_to)
        if cur_det is not None:
            with pt("rescue_cur_insert"):
                self.insert_detection(gj, est_h, cur_det, rows, new_planes,
                                      trace_extra=trace_simu,
                                      transformed=cur_T)
        self.plane_nodes[gj] = cur_det
        with pt("rescue_flush"):
            self._flush(new_planes, rows)
