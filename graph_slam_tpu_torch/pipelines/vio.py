"""Offline visual-inertial odometry from a VRO log and an IMU stream (port
of ``pipelines/vio.py``).

Per VRO record, in file order: a new frame gets an IMU window
preintegration, a NavState prediction, a VO between-factor when its edge
is valid (camera->IMU conjugation by ``u2c``), a CombinedImuFactor from the
previous frame, and a pose estimate from VO composition (else from the IMU
prediction); loop-closure edges are added when both endpoints exist; every
``optimize_step`` frames a fixed-lag optimization feeds the bias and state
back into the next preintegration.

With ``plane_mode="rescue"`` and a plane source, a record whose VO edge
failed is rescued by planes: with ``frames`` the previous frame's planes
are propagated into the new one (the CUDA region grow on the card) and
fresh planes extracted where they do not cover it; with
``plane_obs_provider`` the provider's observations are inserted. The
planes become landmarks and OrientedPlane3 factors.
``plane_mode="rescue"`` with neither source is inert, as in the reference.
``plane_mode="always"`` (online engine only) runs the plane stack on every
new frame.

Engines (``VioConfig.engine``): ``"online"``, the default, is this
module's loop over the records in file order, writing preallocated
``OnlineGraph`` arenas (``_OnlineVioGraph``) and running an
``IncrementalOptimizer`` update every ``optimize_step`` frames (the whole
arena with ``window=None``, else the fixed-lag window); ``"scan"``
precomputes the records on the host and replays them in segments
(``pipelines.vio_scan``). Both run the same record kernel
(``pipelines.vio_kernel``) and the same plane stack
(``pipelines.vio_planes``).

The online engine takes a new frame on one of two paths, as the
reference does. With no plane stack and no provider it is the fast path
(``_fused_vio_step``): the between row is written in its slot even for a
failed or gated edge, inactive, and nothing is read back. Otherwise it is
the slow path: the between row only for a valid edge, so the two paths
lay out the between table differently, and a fixed-lag window (the last
``8 W`` rows by slot) spans other records on each. On the slow path the
chi2 gate decides whether a row is written, so a gated frame reads its
verdict back (one host sync); a rescue reads what its plane stack needs
(``vio_planes._PlaneStack.rescue``). The estimate is composed on the
device on both paths, and every update's chi2 is read once at the end.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import CameraIntrinsics, SlamParams
from ..core import se3
from ..device import resolve, to_host, upload
from ..graph import LMParams, lm_optimize, total_error
from ..graph.online import IncrementalOptimizer
from ..imu import ImuParams, ImuStream, find_index_at
from ..io.vro_log import VROLog
from ..utils.profiling import Chi2Log, PhaseTimer, trace_context
from .vio_kernel import (_fused_vio_step, _host_edges, _pad_window,
                         _preintegrate, _static_init, _vio_frame_kernel)
from .vio_planes import _OnlineVioGraph, _PlaneStack
from .vio_scan import _run_vio_scan
from .vio_types import VioConfig, VioResult

__all__ = ["VioConfig", "VioResult", "run_vio"]


def run_vio(log: VROLog, img_times, imu: ImuStream,
            imu_params: ImuParams, u2c: Optional[se3.Pose] = None,
            plane_obs_provider: Optional[Callable] = None,
            frames: Optional[Callable] = None,
            intrinsics: Optional[CameraIntrinsics] = None,
            params: SlamParams = SlamParams(),
            cfg: VioConfig = VioConfig(),
            lm_params: LMParams = LMParams(), *, device=None,
            dtype=torch.float64) -> VioResult:
    """Replay a VRO log with IMU on ``device`` (``None``: the CUDA card)
    in ``dtype``.

    Args:
      img_times: mapping seq_id -> timestamp (dict or callable).
      u2c: camera->IMU extrinsic (``core.extrinsics.camera_to_imu``);
        ``None`` is the identity.
      plane_obs_provider: optional ``seq_id -> [(plane_cam4, cov3x3),
        ...]``, per-frame plane observations in the camera frame.
      frames: optional ``seq_id -> (intensity, depth) | None`` (numpy,
        depth in meters) with ``intrinsics``: the rescue runs the plane
        stack from the frames (node 0's planes become landmarks).
      params: ``lookback_nodes`` sets the landmark association window.
    """
    device = resolve(device)
    t_of = img_times.__getitem__ if hasattr(img_times, "__getitem__") \
        else img_times
    if frames is not None and intrinsics is None:
        raise ValueError("frames mode requires camera intrinsics")
    if cfg.engine == "online":
        return _run_vio_online(log, t_of, imu, imu_params, u2c, params, cfg,
                               lm_params, device=device, dtype=dtype,
                               frames=frames, intrinsics=intrinsics,
                               plane_obs_provider=plane_obs_provider)
    if cfg.engine != "scan":
        raise ValueError(f"unknown engine {cfg.engine!r} (online|scan)")
    if cfg.plane_mode == "always":
        raise ValueError(
            "engine='scan' supports plane_mode 'off' or 'rescue' "
            "(failures are host-known from the log, every frame is "
            "not); use engine='online' for 'always'")
    if not cfg.feedback:
        raise ValueError("engine='scan' requires feedback=True")
    return _run_vio_scan(log, t_of, imu, imu_params, u2c, params, cfg,
                         lm_params, device=device, dtype=dtype, frames=frames,
                         intrinsics=intrinsics,
                         plane_obs_provider=plane_obs_provider)


def _run_vio_online(log: VROLog, t_of, imu: ImuStream,
                    imu_params: ImuParams, u2c, params: SlamParams,
                    cfg: VioConfig, lm_params: LMParams, *, device, dtype,
                    frames=None, intrinsics=None,
                    plane_obs_provider=None) -> VioResult:
    """``engine="online"``: the records in file order over one
    ``_OnlineVioGraph``, an ``IncrementalOptimizer`` update every
    ``optimize_step`` frames, the optional final batch LM."""
    robust_k = cfg.robust_k if cfg.robust == "huber" else None
    robust_kind, robust_kval = (0, 1.0) if robust_k is None \
        else (1, float(robust_k))
    n_frames = len(set(int(x) for x in log.id_to)) + 1
    b = _OnlineVioGraph(n_frames, len(log), cfg.bucket, cfg.plane_var_cap,
                        max(64, 4 * n_frames), device=device, dtype=dtype)
    og = b.og
    inc = IncrementalOptimizer(
        iters_per_update=cfg.incremental_iters, damping=1e-6,
        solver=cfg.incremental_solver, pcg_iters=cfg.incremental_pcg_iters,
        window=cfg.window)
    pt = PhaseTimer()
    # the plane stack needs a source: plane_mode="rescue" with neither
    # frames nor a provider is plane-free and keeps the fast path
    stack = _PlaneStack(og, cfg, params, intrinsics, u2c, frames,
                        plane_obs_provider, device, dtype, pt) \
        if cfg.plane_mode != "off" and (frames is not None
                                        or plane_obs_provider is not None) \
        else None
    # as in the reference, a provider alone (plane_mode="off") also takes
    # the slow path
    fast = stack is None and plane_obs_provider is None

    # every edge camera -> body on the host, uploaded once
    R_all, t_all, S_all, valid = _host_edges(log, u2c)
    edge_R, edge_t, edge_S = (upload(x, device, dtype)
                              for x in (R_all, t_all, S_all))
    imu_dev = ImuParams(*(x.to(device) for x in imu_params))
    gravity = imu_dev.gravity.to(dtype)

    if cfg.gravity_init and len(log):
        init_R, init_bias = _static_init(
            imu, float(t_of(int(log.id_from[0]))), imu_params,
            cfg.static_init_samples)
    else:
        init_R, init_bias = np.eye(3), np.zeros(6)
    pose0 = se3.Pose(torch.as_tensor(init_R),
                     torch.zeros(3, dtype=torch.float64))

    seq2graph: dict[int, int] = {}
    seq_ids: list[int] = []
    cur = 0                 # IMU cursor relative to the sync start

    def first_node(seq):
        """Node 0: its values, its three priors, its planes; returns the
        feedback state ``(R, t, vel, bias)``."""
        nonlocal cur
        gid = b.add_pose(pose0)
        b.add_vel(np.zeros(3))
        b.add_bias(init_bias)
        seq2graph[seq] = gid
        seq_ids.append(seq)
        b.add_prior_pose(gid, pose0, sigmas=np.full(6, 1e-7))
        b.add_prior_vel(gid, np.zeros(3), sigma=1e-3)
        b.add_prior_bias(gid, init_bias, sigma=1e-3)
        imu.set_start_time(float(t_of(seq)))
        cur = 0
        if stack is not None:
            stack.first_node_planes(gid, pose0, seq)
        v = og.values
        return tuple(x[gid].clone() for x in (v.pose_R, v.pose_t, v.vel,
                                               v.bias))

    def imu_window(seq):
        """The padded measurement window up to frame ``seq``'s time, as
        ``(acc, gyr, dts)`` views of one upload."""
        nonlocal cur
        nxt = find_index_at(imu.t, float(t_of(seq)), imu.start)
        if nxt < 0:
            nxt = len(imu.t) - imu.start - 1
        i0, i1 = cur, max(nxt, cur)
        acc, gyr = imu.window(i0, i1)
        cur = nxt
        a, g, d = _pad_window(acc, gyr, i1 - i0, imu.dt, cfg.max_imu_window)
        w = upload(np.concatenate([a, g, d[:, None]], axis=1), device, dtype)
        return w[:, :3], w[:, 3:6], w[:, 6]

    chi2 = []               # (record, frames, update chi2 on the device)
    prev = None             # feedback state (R, t, vel, bias)
    n_imu = 0
    with trace_context(cfg.trace_dir):
        for k in range(len(log)):
            id_to, id_from = int(log.id_to[k]), int(log.id_from[k])
            failed = not bool(valid[k])
            if not seq2graph:
                prev = first_node(id_from)
            if id_from not in seq2graph:
                continue            # dangling edge (ordered-log assumption)
            gi = seq2graph[id_from]
            meas = se3.Pose(edge_R[k], edge_t[k])

            if id_to in seq2graph:
                # loop closure: a valid edge between known frames
                if failed:
                    continue
                b.add_between(gi, seq2graph[id_to], meas, edge_S[k],
                              robust=robust_k)
            else:
                gj = len(seq_ids)
                seq2graph[id_to] = gj
                seq_ids.append(id_to)
                with pt("fused_frame" if fast else "new_frame"):
                    a, g, d = imu_window(id_to)
                    if fast:
                        bt = og._slot("between", og.graph.between.i.shape[0])
                        im = og._slot("imu", og.graph.imu.i.shape[0])
                        est_R, est_t, vel = _fused_vio_step(
                            og, imu_dev, a, g, d, prev, meas.R, meas.t,
                            edge_S[k], robust_kind, robust_kval, failed, gi,
                            gj, bt, im, gravity, cfg.chi2_vro_gate,
                            cfg.chi2_threshold)
                    else:
                        st = _preintegrate(prev[3], imu_dev, a, g, d)
                        est_R, est_t, vel, verdict = _vio_frame_kernel(
                            og.values, st, prev, meas.R, meas.t, failed, gi,
                            gj, gravity, cfg.chi2_vro_gate and not failed,
                            cfg.chi2_threshold)
                        # the gate decides whether the row exists: one
                        # host read per gated frame
                        failed = bool(verdict)
                        if not failed:
                            b.add_between(gi, gj, meas, edge_S[k],
                                          robust=robust_k)
                        # the IMU factor joins CONSECUTIVE frames
                        b.add_imu_factor(gj - 1, gj, st, gravity)
                og.num_poses = max(og.num_poses, gj + 1)
                og.num_vels = max(og.num_vels, gj + 1)
                og.num_biases = max(og.num_biases, gj + 1)
                n_imu += 1
                if stack is not None and (
                        cfg.plane_mode == "always"
                        or (cfg.plane_mode == "rescue" and failed)):
                    with pt("rescue_step"):
                        est = se3.Pose(est_R, est_t)
                        if plane_obs_provider is not None:
                            stack.provider_obs(gj, to_host(est), id_to)
                        if frames is not None:
                            # from the PREVIOUS FRAME's estimate, whatever
                            # node the VO edge matched
                            stack.rescue(gj, est, id_to, gj - 1,
                                         b.pose(gj - 1), seq_ids[gj - 1],
                                         st.cov[:6, :6])
                if cfg.feedback:
                    prev = (est_R, est_t, vel, prev[3])

            # the cadence check follows every record that reaches here
            if cfg.feedback and len(seq_ids) % cfg.optimize_step == 0:
                with pt("optimize"):
                    res = inc.update(og)
                chi2.append((k, len(seq_ids), res.error))
                j = len(seq_ids) - 1
                v = og.values
                prev = tuple(x[j].clone() for x in (v.pose_R, v.pose_t,
                                                     v.vel, v.bias))

        # every update's chi2, read once
        chi2_log = Chi2Log()
        if chi2:
            vals = torch.stack([e for *_, e in chi2]).cpu().tolist()
            for (k, n, _), val in zip(chi2, vals):
                chi2_log.add(k, n, None, val)

        graph, values = og.graph, og.values
        n_vo = int(graph.between.active.sum())
        e0 = float(total_error(graph, values))
        if cfg.final_batch:
            with pt("final_batch"):
                res = lm_optimize(graph, values, lm_params)
            values = res.values
            err = float(res.error)
        else:
            err = e0
    chi2_log.add(len(log), len(seq_ids), e0, err)

    return VioResult(values=values, graph=graph,
                     seq_ids=np.asarray(seq_ids), error0=e0, error=err,
                     n_imu_factors=n_imu, n_vo_edges=n_vo,
                     n_plane_factors=stack.n_plane if stack else 0,
                     plane_book=stack.book if stack else None,
                     chi2_log=chi2_log, timers=pt.summary(),
                     plane_stack=stack)
