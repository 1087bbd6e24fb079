"""The whole-replay VIO engine (``engine="scan"``; port of
``pipelines/vio_scan.py``).

The graph's structure (slots, ids, failure flags, the optimize schedule,
window starts) is precomputed on the host from the log, and the records'
values (IMU windows, edges, sqrt-information, row indices) go to the
device once. The replay is then a host loop over segments: the records up
to and including the next scheduled optimization. The feedback bias only
changes at an optimization, so a segment's windows are preintegrated in
one batch and its between and IMU rows written at once (the optimization
that closes the segment is the first reader of those rows); the pose chain
runs record by record (``_vio_frame_kernel``), then the fixed-lag
``windowed_gn`` feeds the last frame's state back. The reference compiles
the same replay into chunked ``lax.scan`` programs; here every branch is
host-known and nothing is compiled, so no chunk padding is needed. The
window chi2 of each optimization stays on the device and is read once at
the end, so a plane-free replay makes no host sync.

With ``plane_mode="rescue"`` and a plane source (frames or an observation
provider) this is the flagship path. The failed records are host-known
from the log's info sentinel, so each one is a segment of its own: its
VIO step, then the rescue (``vio_planes._PlaneStack``: one host sync, the
plane rows written), then its optimization if one is scheduled, whose
window caps and plane start come from the live graph. Every rescue's
source frame is pre-extracted in batches before the replay.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..config import SlamParams
from ..core import se3
from ..device import to_host
from ..graph import LMParams, lm_optimize, total_error
from ..graph.builder import _sqrt_info, round_up
from ..graph.factors import empty_graph
from ..graph.online import (OnlineGraph, _window_caps, _window_starts,
                            between_row, imu_row, window_graph, windowed_gn)
from ..graph.variables import empty_arena
from ..imu import ImuParams, ImuStream, PreintState, find_index_at
from ..io.vro_log import VROLog
from ..utils.profiling import Chi2Log, PhaseTimer, trace_context
from .vio_kernel import (_host_edges, _pad_window, _preintegrate,
                         _static_init, _vio_frame_kernel)
from .vio_planes import _PlaneStack
from .vio_types import VioConfig, VioResult

__all__ = ["_run_vio_scan", "_replay_scan"]

# record fields uploaded to the device once (the rest stay host-side):
# edges by record, IMU windows by IMU slot (new frames only)
_EDGES = ("meas_R", "meas_t", "sqrt_info")
_WINDOWS = ("acc", "gyr", "dts")


def _replay_scan(og: OnlineGraph, xs, dev, prev, imu_params, gravity, cfg,
                 robust_kind, robust_kval, wcaps, rescue, pt):
    """The sequential VIO replay over host-precomputed records.

    ``xs`` holds the host-side structure per record (numpy); ``dev`` the
    records' values on the device: edges and between-row indices by record,
    IMU windows and IMU-row indices by IMU slot. A record flagged ``host``
    (a rescue) is a segment of its own: after its VIO step
    ``rescue(record, est_R, est_t, S15)`` writes its plane rows (``S15``
    the window's preintegration covariance), and its optimization, if
    scheduled, reads them; ``pt`` (a ``PhaseTimer``) times each rescue
    record as ``rescue_step``. Returns the feedback state after the last
    record and ``[(record, window chi2 as a 0-d device tensor)]``.
    """
    chi2 = []
    n = len(xs["gj"])
    host = np.nonzero(xs["host"])[0].tolist()
    ends = sorted(set(np.nonzero(xs["do_opt"])[0].tolist()) | {n - 1}
                  | set(host) | {i - 1 for i in host if i > 0})
    lo = 0
    for hi in ends:
        with (pt("rescue_step") if xs["host"][hi]
              else contextlib.nullcontext()):
            prev = _segment(og, xs, dev, lo, hi, prev, imu_params, gravity,
                            cfg, robust_kind, robust_kval, wcaps, rescue,
                            chi2)
        lo = hi + 1
    return prev, chi2


def _segment(og, xs, dev, lo, hi, prev, imu_params, gravity, cfg,
             robust_kind, robust_kval, wcaps, rescue, chi2):
    """Records ``lo``..``hi`` of ``_replay_scan``; returns the feedback
    state and appends the closing optimization's chi2 to ``chi2``."""
    recs = slice(lo, hi + 1)
    between_row(og.graph.between, recs, dev["gi"][recs], dev["gj"][recs],
                dev["meas_R"][recs], dev["meas_t"][recs],
                dev["sqrt_info"][recs], robust_kind, robust_kval,
                active=dev["valid"][recs])
    new = [k for k in range(lo, hi + 1) if xs["is_new"][k]]
    if new:
        # consecutive IMU slots, one bias estimate: one batch
        s0, s1 = int(xs["imu_slot"][new[0]]), int(xs["imu_slot"][new[-1]])
        slots = slice(s0, s1 + 1)
        st = _preintegrate(prev[3].expand(s1 + 1 - s0, 6), imu_params,
                           dev["acc"][slots], dev["gyr"][slots],
                           dev["dts"][slots])
        imu_row(og.graph.imu, slots, dev["imu_i"][slots],
                dev["imu_j"][slots], st.dR, st.dp, st.dv, st.H_R_bg,
                st.H_p_ba, st.H_p_bg, st.H_v_ba, st.H_v_bg, st.bias_hat,
                st.dt, gravity, st.cov)
    for k in new:
        q = int(xs["imu_slot"][k]) - s0
        est_R, est_t, pred_vel, failed = _vio_frame_kernel(
            og.values, PreintState(*(x[q] for x in st)), prev,
            dev["meas_R"][k], dev["meas_t"][k], bool(xs["failed"][k]),
            int(xs["gi"][k]), int(xs["gj"][k]), gravity,
            cfg.chi2_vro_gate, cfg.chi2_threshold)
        if not isinstance(failed, bool):
            og.graph.between.active[k] = ~failed   # the gate's verdict
        prev = (est_R, est_t, pred_vel, prev[3])
        if xs["host"][k]:
            rescue(k, est_R, est_t, st.cov[q])
    if xs["do_opt"][hi]:
        # caps and the plane start from the live graph: a rescue may
        # have grown the plane tables and added rows
        opt_caps = _window_caps(og.graph, cfg.window)
        starts = _window_starts({
            "prior_pose": 1, "prior_vel": 1, "prior_bias": 1,
            "between": int(xs["n_between"][hi]), "imu": int(xs["n_imu"][hi]),
            "plane": og._n["plane"]}, opt_caps)
        win = window_graph(og.graph, starts, opt_caps)
        og.values, werr = windowed_gn(win, og.values, xs["free_from"][hi],
                                      wcaps, 1e-6, cfg.incremental_iters)
        j = int(xs["last_gj"][hi])
        v = og.values
        prev = tuple(x[j].clone() for x in (v.pose_R, v.pose_t, v.vel,
                                             v.bias))
        chi2.append((hi, werr))
    return prev


def _run_vio_scan(log: VROLog, t_of, imu: ImuStream,
                  imu_params: ImuParams, u2c, params: SlamParams,
                  cfg: VioConfig, lm_params: LMParams, *, device, dtype,
                  frames=None, intrinsics=None,
                  plane_obs_provider=None) -> VioResult:
    """Host wrapper for ``engine="scan"``: precompute the structure,
    replay (with the plane rescue at the failed records when a plane
    source is given), finalize (window chi2 read back, optional batch
    LM)."""
    robust_k = cfg.robust_k if cfg.robust == "huber" else None
    Wimu = cfg.max_imu_window
    rescue_on = cfg.plane_mode == "rescue" and (
        frames is not None or plane_obs_provider is not None)
    if rescue_on and cfg.chi2_vro_gate:
        raise ValueError(
            "engine='scan' plane rescue requires chi2_vro_gate=False: "
            "the segment split needs failures host-known from the log")

    if len(log) == 0:
        raise ValueError("empty VRO log")
    first_seq = int(log.id_from[0])
    seq2graph = {first_seq: 0}
    seq_ids = [first_seq]
    if cfg.gravity_init:
        init_R, init_bias = _static_init(imu, float(t_of(first_seq)),
                                         imu_params, cfg.static_init_samples)
    else:
        init_R, init_bias = np.eye(3), np.zeros(6)
    imu.set_start_time(float(t_of(first_seq)))
    cur = 0
    n_imu_rows = 0

    R_all, t_all, S_all, valid_mask = _host_edges(log, u2c)

    rows = []
    for k in range(len(log)):
        id_to = int(log.id_to[k])
        id_from = int(log.id_from[k])
        if id_from not in seq2graph:
            continue  # dangling edge (ordered-log assumption)
        failed = not bool(valid_mask[k])
        gi = seq2graph[id_from]
        is_new = id_to not in seq2graph
        if failed and not is_new:
            # failed loop closure: skipped entirely (no row, no optimize
            # cadence check), as the per-frame engines do
            continue
        if is_new:
            gj = len(seq_ids)
            seq2graph[id_to] = gj
            seq_ids.append(id_to)
            nxt = find_index_at(imu.t, float(t_of(id_to)), imu.start)
            if nxt < 0:
                nxt = len(imu.t) - imu.start - 1
            i0, i1 = cur, max(nxt, cur)
            acc, gyr = imu.window(i0, i1)
            cur = nxt
            a, g, d = _pad_window(acc, gyr, i1 - i0, imu.dt, Wimu)
            imu_slot = n_imu_rows
            n_imu_rows += 1
        else:
            gj = seq2graph[id_to]
            a = g = d = None
            imu_slot = -1   # loop closures write no IMU row
        # the cadence check runs after EVERY record (loop-closure records
        # can re-trigger at the same count), as in the per-frame engines
        rows.append(dict(
            is_new=is_new, failed=failed, edge_valid=not failed,
            gi=gi, gi_imu=(gj - 1 if is_new else gi), gj=gj,
            bt_slot=len(rows), imu_slot=imu_slot,
            last_gj=len(seq_ids) - 1,
            do_opt=bool(cfg.feedback
                        and len(seq_ids) % cfg.optimize_step == 0),
            host=rescue_on and failed and is_new, seq_to=id_to,
            meas_R=R_all[k], meas_t=t_all[k], sqrt_info=S_all[k],
            acc=a, gyr=g, dts=d, n_poses=len(seq_ids),
            n_between=len(rows) + 1, n_imu=n_imu_rows))
    if not rows:
        raise ValueError("empty VRO log")

    n_frames = len(seq_ids)
    P = round_up(n_frames, 8)
    # the reference's capacities (one reserved dummy slot each, rounded to
    # 8): window_graph clips its starts against them
    imu_cap = round_up(n_imu_rows + 1, 8)
    between_cap = round_up(len(rows) + 1, 8)
    n_rescue = sum(1 for r in rows if r["host"])
    if rescue_on:
        # host-known budget: rescue frames + firstPlaneNode, each holding
        # up to max_planes propagated + max_planes fresh observations;
        # the plane stack grows both tables past it
        plane_factor_cap = round_up(
            max(64, (n_rescue + 1) * (2 * cfg.max_planes + 2)), 8)
        plane_var_cap = max(8, cfg.plane_var_cap)
    else:
        plane_factor_cap = plane_var_cap = 0

    graph = empty_graph(prior_pose_cap=4, between_cap=between_cap,
                        prior_vel_cap=4, prior_bias_cap=4,
                        plane_cap=plane_factor_cap, imu_cap=imu_cap,
                        dtype=dtype, device=device)
    arena = empty_arena(pose_cap=P, vel_cap=P, bias_cap=P,
                        plane_cap=plane_var_cap, dtype=dtype, device=device)
    og = OnlineGraph(graph, arena)
    pose0 = se3.Pose(torch.as_tensor(init_R),
                     torch.zeros(3, dtype=torch.float64))
    og.set_pose(0, pose0)
    og.set_vel(0, np.zeros(3))
    og.set_bias(0, init_bias)
    og.add_prior_pose(0, pose0, _sqrt_info(6, sigmas=np.full(6, 1e-7)))
    og.add_prior_vel(0, np.zeros(3), _sqrt_info(3, sigma=1e-3))
    og.add_prior_bias(0, init_bias, _sqrt_info(6, sigma=1e-3))

    pt = PhaseTimer()
    stack = None
    if rescue_on:
        stack = _PlaneStack(og, cfg, params, intrinsics, u2c, frames,
                            plane_obs_provider, device, dtype, pt)
        stack.first_node_planes(0, pose0, first_seq)

    if cfg.window is not None and cfg.window <= 0:
        raise ValueError("VioConfig.window must be positive or None")
    if cfg.window is None and n_frames > 2048:
        raise ValueError(
            f"engine='scan' on {n_frames} frames requires a fixed-lag "
            "window (set VioConfig.window): with window=None every "
            "scheduled optimization QR-solves the FULL arena dimension")
    Wwin = P if cfg.window is None else cfg.window

    for r in rows:
        f = max(0, r["n_poses"] - Wwin)
        r["free_from"] = [f, f, f, 0, 0]

    xs = {key: np.stack([r[key] for r in rows]) for key in rows[0]
          if key not in _WINDOWS + _EDGES}
    new = [r for r in rows if r["is_new"]]      # in IMU-slot order
    on_dev = og.values.pose_t.device

    def up(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=on_dev).to(dt)

    dev = {key: up(np.stack([r[key] for r in rows])) for key in _EDGES}
    dev.update({key: up(np.stack([r[key] for r in new])) for key in _WINDOWS})
    dev.update(gi=up(xs["gi"], torch.int64), gj=up(xs["gj"], torch.int64),
               valid=up(xs["edge_valid"], torch.bool),
               imu_i=up([r["gi_imu"] for r in new], torch.int64),
               imu_j=up([r["gj"] for r in new], torch.int64))
    del rows, new
    imu_dev = ImuParams(*(x.to(device=og.values.pose_t.device)
                          for x in imu_params))
    gravity = imu_dev.gravity.to(dtype)

    host_idx = np.nonzero(xs["host"])[0]
    if stack is not None and frames is not None and len(host_idx):
        # every rescue's plane source is the previous frame (gj - 1),
        # host-known upfront: their fresh extractions run in batches
        stack.precompute_detections({
            int(xs["gj"][i]) - 1: seq_ids[int(xs["gj"][i]) - 1]
            for i in host_idx})

    def rescue(i, est_R, est_t, S15):
        """One rescue record's plane work, after its VIO step."""
        gj = int(xs["gj"][i])
        est = se3.Pose(est_R, est_t)
        seq_to = int(xs["seq_to"][i])
        if plane_obs_provider is not None:
            stack.provider_obs(gj, to_host(est), seq_to)
        if frames is not None:
            pre_pose = se3.Pose(og.values.pose_R[gj - 1],
                                og.values.pose_t[gj - 1])
            stack.rescue(gj, est, seq_to, gj - 1, pre_pose, seq_ids[gj - 1],
                         S15[:6, :6])

    chi2_log = Chi2Log()
    with trace_context(cfg.trace_dir):
        with pt("replay_scan"):
            v = og.values
            prev = tuple(x[0].clone() for x in (v.pose_R, v.pose_t, v.vel,
                                                 v.bias))
            prev, chi2 = _replay_scan(
                og, xs, dev, prev, imu_dev, gravity, cfg,
                0 if robust_k is None else 1,
                1.0 if robust_k is None else float(robust_k),
                (Wwin, Wwin, Wwin), rescue, pt)
            og.num_poses = og.num_vels = og.num_biases = n_frames
            if og.values.pose_t.is_cuda:
                torch.cuda.synchronize()

        # the window chi2 of every scheduled optimization, read once
        if chi2:
            vals = torch.stack([e for _, e in chi2]).cpu().tolist()
            for (k, _), val in zip(chi2, vals):
                chi2_log.add(k, int(xs["last_gj"][k]) + 1, None, val)

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
    chi2_log.add(len(log), n_frames, e0, err)

    return VioResult(values=values, graph=graph,
                     seq_ids=np.asarray(seq_ids), error0=e0, error=err,
                     n_imu_factors=n_imu_rows, n_vo_edges=n_vo,
                     n_plane_factors=stack.n_plane if stack else 0,
                     plane_book=stack.book if stack else None,
                     chi2_log=chi2_log, timers=pt.summary(),
                     plane_stack=stack)
