"""Command-line drivers of the port — ``graph_slam_tpu/cli.py`` on torch.

One entry point with subcommands standing in for the reference's per-main
executables + ROS launch files (params come from flags or a JSON config,
``config.load_params``); every subcommand, flag, default and choice is the
JAX package's, and the estimators run on ``--device`` (default: the CUDA
card; ``--device cpu`` runs on the CPU):

  python -m graph_slam_tpu_torch posegraph  --vro vro_results.log --out-dir out/
      (test_gt_graph offline replay)
  python -m graph_slam_tpu_torch slam       --frames DIR [--gt groundtruth.txt]
      (test_gt_graph ONLINE: frontend + keyframing + loop closures; frame
       dirs may be .gsf stores, TUM sequences, or PNG pairs)
  python -m graph_slam_tpu_torch evaluate   --est trajectory.log --gt GT
      (full ATE/RPE statistics; GT = TUM groundtruth.txt or trajectory.log)
  python -m graph_slam_tpu_torch vio        --vro ... --imu imu.log --times t.txt
      (test_vro_imu_graph)
  python -m graph_slam_tpu_torch convert    --vro ... --model cut --matches m.log
      (convert_vo2ba)
  python -m graph_slam_tpu_torch merge      --ba a.log --vro b.log --matches m.log
  python -m graph_slam_tpu_torch diff       --log1 a.log --log2 b.log
  python -m graph_slam_tpu_torch g2o        --input graph.g2o --out-dir out/
      (standard g2o pose-graph ingest + LM; known-optimum parity runs)
  python -m graph_slam_tpu_torch map        --traj trajectory.log --frames DIR
      --out map.pcd|map.ply           (mapping_PCD / mapping_PLY)
  python -m graph_slam_tpu_torch video      --traj trajectory.log --frames DIR
      --out-dir snaps/                (map_video snapshot replay)
  python -m graph_slam_tpu_torch ba-imu     --frames DIR --seqs 0:40 [--imu ...]
      (test_ba_imu_graph)
  python -m graph_slam_tpu_torch plane-check --vro ... --frames DIR
      (test_plane_check_vo)
  python -m graph_slam_tpu_torch mesh       --pcd map.pcd --out mesh.ply
  python -m graph_slam_tpu_torch tsdf       --traj trajectory.log --frames DIR
      --out mesh.ply                  (volumetric TSDF fusion + marching
                                       tetrahedra; beyond the reference)
  python -m graph_slam_tpu_torch filter     --pcd map.pcd --out filtered.pcd
  python -m graph_slam_tpu_torch serve      --port 7200
      (streaming SLAM service: RGB-D frames in over TCP, poses out)
  python -m graph_slam_tpu_torch publish    --pcd map.pcd
      (pub_pcd role: PointCloud2-layout TCP republisher)
  python -m graph_slam_tpu_torch bench      (sphere2500 GN throughput)

Frame directories hold ``.gsf`` files named ``{seq:07d}.gsf``
(``io.frames.FrameStore``); ``--camera`` picks the intrinsics preset.
``g2o --sharded N`` and ``ba-imu --sharded N`` solve over N ranks, one
process each (``parallel.launch``): one card a rank over NCCL, or, with
``--device cpu``, N gloo processes on the CPU. N < 0 takes every card (one
rank on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

def _load_params(args):
    from .config import SlamParams, load_params

    if getattr(args, "config", None):
        return load_params(args.config)
    return SlamParams()


def _load_config_dict(args):
    """Full config dict (reserved sections included) or {}."""
    from .config import load_config_dict

    if getattr(args, "config", None):
        return load_config_dict(args.config)
    return {}


def _device(args):
    """The torch device every estimator of the command runs on: ``--device``
    or, when it is not given, the CUDA card (a RuntimeError without one)."""
    from .device import resolve

    return resolve(args.device)


def _ranks(n, dev):
    """``--sharded N``'s rank count: N, or for N < 0 every card (one rank
    on the CPU)."""
    if n > 0:
        return n
    import torch

    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _plane_provider(store, K, dev, **kw):
    """``seq -> (planes, covs)`` of each frame's fresh plane extraction,
    cached; the draw of frame ``seq`` is keyed ``(0, seq)``."""
    from .planes import extract_plane_node

    cache = {}

    def planes_of(seq):
        if seq not in cache:
            fr = store(seq)
            if fr is None:
                cache[seq] = ([], [])
            else:
                det = extract_plane_node((0, int(seq)), K, fr[1], device=dev,
                                         **kw)
                cache[seq] = ([], []) if det is None else \
                    (list(det.params), list(det.cov))
        return cache[seq]

    return planes_of


def cmd_posegraph(args):
    from .core import extrinsics
    from .io import read_vro_log, write_trajectory, write_trajectory_ply
    from .pipelines import run_pose_graph, trajectory_arrays

    dev = _device(args)
    params = _load_params(args)
    if getattr(args, "robust", None):
        import dataclasses as _dc
        params = _dc.replace(params, robust=args.robust)
    preset = _load_config_dict(args)
    log = read_vro_log(args.vro)
    u2c = extrinsics.camera_to_imu(args.pitch, device=dev) \
        if args.imu_frame else None
    # the preset's reserved "backend" key selects the fake-odometry
    # weighting (gtsam I*1e4 vs g2o I*1e-3, g2o_graph.cpp:151)
    backend = args.backend or preset.get("backend", "gtsam")
    res = run_pose_graph(log, params, u2c=u2c, backend=backend,
                         init=getattr(args, "init", "odometry"),
                         loop_gate=getattr(args, "loop_gate", "none")
                         or "none", device=dev)
    print(f"chi2: {res.error0:.6f} -> {res.error:.6f} "
          f"({res.iterations} LM iterations, {len(res.seq_ids)} nodes)")
    os.makedirs(args.out_dir, exist_ok=True)
    w2o = extrinsics.world_to_original(args.pitch, device=dev)
    ids, t, q, seq = trajectory_arrays(res.values, res.seq_ids, w2o=w2o)
    write_trajectory(os.path.join(args.out_dir, "trajectory.log"),
                     ids, t, q, seq)
    write_trajectory_ply(os.path.join(args.out_dir, "trajectory.ply"), t)
    print(f"wrote {args.out_dir}/trajectory.log, trajectory.ply")
    if getattr(args, "marginals", None):
        _write_pose_marginals(args.marginals, res.graph, res.values,
                              len(res.seq_ids))
    _report_vs_gt(args, t)


def _write_pose_marginals(path, graph, values, n):
    """Per-pose 6x6 marginal covariances (the Marginals(CHOLESKY) output
    tier, gtsam_graph.cpp:598-601) in one factorization."""
    from .device import to_host
    from .graph import pose_marginals_all
    from .io import write_marginals

    covs = to_host(pose_marginals_all(graph, values, n))
    write_marginals(path, np.arange(n), covs)
    print(f"wrote {path} ({n} pose marginals)")


def _report_vs_gt(args, est_t):
    """Print ATE RMSE / RPE against a ground-truth trajectory log."""
    if not getattr(args, "gt", None):
        return
    from .io import read_trajectory
    from .utils.metrics import ate_rmse, rpe

    gt = read_trajectory(args.gt)
    n = min(len(est_t), len(gt.t))
    print(f"ATE RMSE: {ate_rmse(est_t[:n], gt.t[:n]):.6f} m  "
          f"RPE(1): {rpe(est_t[:n], gt.t[:n]):.6f} m")


def _read_times(path):
    """``seq_id timestamp`` lines -> {seq: t}."""
    times = {}
    with open(path) as f:
        for line in f:
            tok = line.split()
            if len(tok) >= 2:
                times[int(tok[0])] = float(tok[1])
    return times


def cmd_vio(args):
    from .core import extrinsics
    from .imu import mems_params, read_mems_log, read_vn100_log, vn100_params
    from .io import read_vro_log, write_trajectory
    from .pipelines import trajectory_arrays
    from .pipelines.vio import VioConfig, run_vio

    dev = _device(args)
    params = _load_params(args)
    preset = _load_config_dict(args)
    log = read_vro_log(args.vro)
    imu_type = args.imu_type or preset.get("imu_type", "vn100")
    if imu_type == "vn100":
        stream = read_vn100_log(args.imu)
        iparams = vn100_params(device=dev)
    else:
        stream = read_mems_log(args.imu)
        iparams = mems_params(device=dev)
    times = _read_times(args.times)
    extrinsic = args.extrinsic or preset.get("extrinsic", "sr4000")
    if extrinsic == "identity":
        u2c = None
    elif extrinsic == "rs435-translation":
        # translation-only camera-IMU extrinsic of the RealSense driver
        # (setCamera2IMUTranslation(-0.01, 0, 0.025),
        # main_rgbdslam_imu_offline.cpp:105)
        u2c = extrinsics.camera_to_imu_translation(-0.01, 0.0, 0.025,
                                                   device=dev)
    else:
        u2c = extrinsics.camera_to_imu(args.pitch, device=dev)
    # one flat kwargs dict: explicit defaults first, then the preset's
    # "vio" section, then CLI flags — a preset that sets optimize_step /
    # robust / trace_dir in its vio section must override, not TypeError
    vio_kw = dict(optimize_step=params.optimize_step,
                  robust=params.robust, robust_k=params.robust_k)
    vio_kw.update(preset.get("vio", {}))
    if args.trace_dir:
        vio_kw["trace_dir"] = args.trace_dir
    if args.plane_mode:
        vio_kw["plane_mode"] = args.plane_mode
    # CLI default: "off" (the reference launch default plane_aided=false),
    # EXCEPT when the user supplies frames — the flag's whole purpose is
    # the frames-driven plane rescue, so it must not be silently inert
    if vio_kw.setdefault("plane_mode",
                         "rescue" if args.frames else "off") == "rescue" \
            and args.frames and not args.plane_mode:
        print("note: --frames given, plane-mode defaults to 'rescue' "
              "(pass --plane-mode off to disable)")
    if args.engine:
        vio_kw["engine"] = args.engine
    if args.gravity_init:
        vio_kw["gravity_init"] = True
    cfg = VioConfig(**vio_kw)
    frames = intr = None
    if args.frames:
        from .io import open_frame_source

        frames = open_frame_source(args.frames)
        intr = _camera(args, preset)
    res = run_vio(log, times, stream, iparams, u2c=u2c, params=params,
                  frames=frames, intrinsics=intr, cfg=cfg, device=dev)
    print(f"chi2: {res.error0:.6f} -> {res.error:.6f} "
          f"(vo={res.n_vo_edges} imu={res.n_imu_factors} "
          f"plane={res.n_plane_factors})")
    os.makedirs(args.out_dir, exist_ok=True)
    w2o = extrinsics.world_to_original(args.pitch, device=dev)
    ids, t, q, seq = trajectory_arrays(res.values, res.seq_ids, w2o=w2o)
    write_trajectory(os.path.join(args.out_dir, "trajectory.log"),
                     ids, t, q, seq)
    print(f"wrote {args.out_dir}/trajectory.log")
    _report_vs_gt(args, t)


def cmd_convert(args):
    from .io import read_vro_log, write_vro_log
    from .tools import convert_vo2ba

    log = read_vro_log(args.vro)
    counts = None
    if args.matches:
        counts = np.loadtxt(args.matches)[:, 2].astype(int)
    out = convert_vo2ba(log, args.model, match_counts=counts,
                        min_match_num=args.min_match_num)
    path = args.out or f"{args.vro}_{args.model}"
    write_vro_log(path, out)
    print(f"wrote {path} ({int(out.valid.sum())}/{len(out)} valid edges)")


def cmd_merge(args):
    from .io import read_vro_log, write_vro_log
    from .tools import merge_vro

    counts = np.loadtxt(args.matches)[:, 2].astype(int)
    out = merge_vro(read_vro_log(args.ba), read_vro_log(args.vro), counts,
                    thresh=args.thresh)
    write_vro_log(args.out, out)
    print(f"wrote {args.out}")


def _scores_by_edge(log, rows, score_col):
    """Per-log-row scores from plane-check rows keyed by (id_to, id_from);
    rows cover VALID edges only, so they align by edge id, not position."""
    by_edge = {(int(r[0]), int(r[1])): float(r[score_col]) for r in rows}
    return np.asarray([by_edge.get((int(t), int(f)), 0.0)
                       for t, f in zip(log.id_to, log.id_from)])


def cmd_delete_vo(args):
    """delete_vo_by_plane_check.cpp driver: void VO edges whose
    plane-consistency Mahalanobis score exceeds the threshold."""
    from .io import open_frame_source, read_vro_log, write_vro_log
    from .pipelines.plane_check import check_vo_edges
    from .tools import delete_vo_by_plane_check

    if not args.scores and not args.frames:
        raise SystemExit("delete-vo: need --scores or --frames")
    log = read_vro_log(args.vro)
    if args.scores:
        # pre-computed 'id2 id1 num err err_raw' rows (plane-check --out)
        rows = np.loadtxt(args.scores)
        if rows.ndim == 1:
            rows = rows[None, :]
    else:
        dev = _device(args)
        planes_of = _plane_provider(open_frame_source(args.frames),
                                    _camera(args), dev,
                                    max_planes=args.max_planes)
        rows = check_vo_edges(log, planes_of, device=dev)
    scores = _scores_by_edge(log, rows, 3)
    out = delete_vo_by_plane_check(log, scores, args.thresh)
    write_vro_log(args.out, out)
    n_void = int((~out.valid & log.valid).sum())
    print(f"wrote {args.out} ({n_void} edges voided of {len(out)})")


def cmd_add_vo_sparse(args):
    """add_vo_at_sparse_area.cpp driver: append matcher-validated extra
    edges around feature-sparse frames."""
    from .io import open_frame_source, read_vro_log, write_vro_log
    from .tools import add_vo_at_sparse_area, make_frame_matcher
    from .vision.frontend import make_feature_cache

    dev = _device(args)
    log = read_vro_log(args.vro)
    store = open_frame_source(args.frames)
    K = _camera(args)
    seqs = sorted(set(int(x) for x in log.id_from)
                  | set(int(x) for x in log.id_to))
    feat = make_feature_cache(store, K, max_features=args.max_features,
                              device=dev)
    counts = {}
    for s in seqs:
        f = feat(s)
        counts[s] = 0 if f is None else int(f.valid.sum())
    matcher = make_frame_matcher(store, K,
                                 max_features=args.max_features,
                                 feature_cache=feat, device=dev)
    out = add_vo_at_sparse_area(log, counts, matcher, window=args.window,
                                sparse_thresh=args.sparse_thresh)
    write_vro_log(args.out, out)
    print(f"wrote {args.out} ({len(out) - len(log)} edges added, "
          f"{sum(1 for s in seqs if counts[s] < args.sparse_thresh)} "
          f"sparse frames)")


def cmd_diff(args):
    from .io import read_vro_log
    from .tools import compute_trans_difference

    dt, dr = compute_trans_difference(read_vro_log(args.log1),
                                      read_vro_log(args.log2),
                                      device=_device(args))
    print(f"edges={len(dt)} mean |dt|={np.nanmean(dt):.6f} m "
          f"mean |dr|={np.nanmean(dr):.6f} rad "
          f"max |dt|={np.nanmax(dt):.6f} max |dr|={np.nanmax(dr):.6f}")


def _gt_ncols(path: str) -> int:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                return len(line.split())
    return 0


def cmd_evaluate(args):
    """Trajectory evaluation (the TUM benchmark's evaluate_ate/evaluate_rpe
    role): full ATE + RPE statistics of an estimated trajectory.log against
    ground truth — a TUM groundtruth.txt (timestamp-associated through a
    TUM frame dir) or another framework trajectory.log (row-indexed)."""
    from .io import read_trajectory
    from .utils.metrics import ate_stats, rpe_stats

    est = read_trajectory(args.est)
    est_t = est.t
    if _gt_ncols(args.gt) == 8:        # TUM: t tx ty tz qx qy qz qw
        from .io import groundtruth_at, open_frame_source

        if not args.frames:
            raise SystemExit("evaluate: TUM-format ground truth needs "
                             "--frames (the TUM sequence dir) to recover "
                             "keyframe timestamps")
        src = open_frame_source(args.frames)
        ts = getattr(src, "timestamps", None)
        if ts is None:
            raise SystemExit(f"evaluate: {args.frames} is not a TUM "
                             "sequence (no timestamps)")
        iq, gt_t, _ = groundtruth_at(args.gt, ts[np.asarray(est.seq)],
                                     max_dt=args.gt_max_dt)
        if len(iq) < 2:
            raise SystemExit("evaluate: no estimated poses matched a "
                             "ground-truth timestamp")
        est_t = est_t[iq]
    else:                              # framework log: id x y z q... sid
        gt = read_trajectory(args.gt)
        n = min(len(est_t), len(gt.t))
        est_t, gt_t = est_t[:n], gt.t[:n]

    ate, est_aligned = ate_stats(est_t, gt_t, with_scale=args.scale)
    rp = rpe_stats(est_aligned, gt_t, delta=args.delta)
    print(f"ATE  rmse {ate['rmse']:.6f} m  mean {ate['mean']:.6f}  "
          f"median {ate['median']:.6f}  std {ate['std']:.6f}  "
          f"min {ate['min']:.6f}  max {ate['max']:.6f}  "
          f"({ate['n']} poses, scale {ate['scale']:.6f})")
    print(f"RPE({rp['delta']})  rmse {rp['rmse']:.6f} m  "
          f"mean {rp['mean']:.6f}  median {rp['median']:.6f}  "
          f"std {rp['std']:.6f}  max {rp['max']:.6f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"ate": ate, "rpe": rp}, f, indent=1)
        print(f"wrote {args.json}")
    if args.aligned:
        from .io import write_trajectory_ply

        write_trajectory_ply(args.aligned, est_aligned)
        print(f"wrote {args.aligned} (aligned estimate)")


def _camera(args, preset=None):
    from .config import RS435, SR4000, TUM_FR1, TUM_FR2, TUM_FR3

    name = getattr(args, "camera", None) or (preset or {}).get("camera") \
        or "sr4000"
    return {"sr4000": SR4000, "rs435": RS435, "tum-fr1": TUM_FR1,
            "tum-fr2": TUM_FR2, "tum-fr3": TUM_FR3}[name]


def cmd_g2o(args):
    from .graph import LMParams
    from .io import write_trajectory
    from .pipelines import run_g2o_file, trajectory_arrays

    dev = _device(args)
    if args.sharded:
        from .convert import arena_from_numpy
        from .graph import total_error
        from .io import read_g2o
        from .parallel import launch, sharded_gn
        from .pipelines import build_graph_from_g2o
        from .pipelines.posegraph import PoseGraphResult

        vertices, edges = read_g2o(args.input)
        graph, values, ids = build_graph_from_g2o(vertices, edges,
                                                  device=dev)
        n_dev = _ranks(args.sharded, dev)
        e0 = float(total_error(graph, values))
        if getattr(args, "init", "odometry") == "chordal":
            from .graph import chordal_initialize
            values = chordal_initialize(graph, values)
        vals, err = launch(n_dev, sharded_gn, graph, values,
                           iterations=args.iters, damping=1e-6,
                           solver="pcg", device=dev)[0]
        res = PoseGraphResult(
            values=arena_from_numpy(vals, device=dev,
                                    dtype=values.pose_t.dtype),
            graph=graph, error0=e0, error=float(err), seq_ids=ids,
            iterations=args.iters)
        print(f"chi2: {res.error0:.6f} -> {res.error:.6f} "
              f"({args.iters} sharded GN iterations over {n_dev} devices, "
              f"{len(res.seq_ids)} vertices)")
    else:
        res = run_g2o_file(args.input, LMParams(),
                           init=getattr(args, "init", "odometry"),
                           loop_gate=getattr(args, "loop_gate", "none")
                           or "none", device=dev)
        print(f"chi2: {res.error0:.6f} -> {res.error:.6f} "
              f"({res.iterations} LM iterations, "
              f"{len(res.seq_ids)} vertices)")
    os.makedirs(args.out_dir, exist_ok=True)
    ids, t, q, seq = trajectory_arrays(res.values, res.seq_ids)
    write_trajectory(os.path.join(args.out_dir, "trajectory.log"),
                     ids, t, q, seq)
    print(f"wrote {args.out_dir}/trajectory.log")


def cmd_sparsify(args):
    """Pose-graph maintenance: optimize, marginalize poses out, write the
    Chow-Liu-sparsified graph (graph/sparsify.py; no reference
    counterpart — the reference can only avoid creating nodes)."""
    from .core import so3
    from .device import to_host
    from .graph import gn_optimize, marginalize_poses, total_error
    from .io import read_vro_log, write_g2o, write_trajectory
    from .pipelines import run_pose_graph, trajectory_arrays

    params = _load_params(args)
    log = read_vro_log(args.vro)
    res = run_pose_graph(log, params, device=_device(args))
    n = len(res.seq_ids)
    if args.drop:
        drop = sorted({int(x) for x in args.drop.split(",")})
    else:
        k = max(2, args.keep_every)
        drop = [i for i in range(n) if i % k]
    g2, v2, old2new = marginalize_poses(res.graph, res.values, drop)
    out = gn_optimize(g2, v2, iterations=10)
    keep = np.array(sorted(old2new))
    n_fac0 = int(res.graph.between.active.sum())
    n_fac1 = int(g2.between.active.sum())
    print(f"poses {n} -> {len(keep)}, between factors {n_fac0} -> {n_fac1}, "
          f"chi2 {float(total_error(g2, v2)):.6f} -> {float(out.error):.6f}")
    os.makedirs(args.out_dir, exist_ok=True)
    ids, t, q, seq = trajectory_arrays(out.values, res.seq_ids[keep])
    write_trajectory(os.path.join(args.out_dir, "trajectory.log"),
                     ids, t, q, seq)
    bt = g2.between
    active, sqrt_info, quats, bi, bj, meas_t = to_host(
        (bt.active, bt.sqrt_info, so3.matrix_to_quat(bt.meas_R), bt.i, bt.j,
         bt.meas_t))
    act = np.flatnonzero(active)
    S = sqrt_info[act]
    infos = np.einsum("lki,lkj->lij", S, S)
    qm = quats[act]
    edges = [(int(bi[e]), int(bj[e]), meas_t[e], qm[w], infos[w])
             for w, e in enumerate(act)]
    write_g2o(os.path.join(args.out_dir, "sparsified.g2o"), t, q, edges)
    print(f"wrote {args.out_dir}/trajectory.log, sparsified.g2o")


def cmd_map(args):
    from .core import extrinsics
    from .io import open_frame_source, read_trajectory, write_ply_points
    from .mapping import accumulate_cloud, voxel_filter, write_pcd

    dev = _device(args)
    traj = read_trajectory(args.traj)
    store = open_frame_source(args.frames)
    if getattr(args, "roi", None):
        # ROI limits which pixels are backprojected (the per-pixel loop
        # bounds of mapping_PCD.cpp): zero the depth outside it so the
        # intrinsics stay valid (slicing would shift cx/cy)
        try:
            u0, v0, u1, v1 = (int(x) for x in args.roi.split(","))
        except ValueError:
            raise SystemExit("map: --roi must be U0,V0,U1,V1")
        inner = store

        def store(seq, _s=inner):
            got = _s(seq)
            if got is None:
                return None
            inten, depth = got
            m = np.zeros_like(np.asarray(depth))
            m[v0:v1, u0:u1] = 1.0
            return inten, np.asarray(depth) * m

    u2c = extrinsics.camera_to_imu(args.pitch, device=dev) \
        if args.imu_frame else None
    pts, cols = accumulate_cloud(traj, store, _camera(args), u2c=u2c,
                                 stride=args.stride, skip=args.skip,
                                 z_max=args.z_max, device=dev)
    if args.voxel:
        pts, cols = voxel_filter(pts, cols, voxel=args.voxel)
    if args.out.endswith(".ply"):
        write_ply_points(args.out, pts, cols)
    else:
        write_pcd(args.out, pts, cols)
    print(f"wrote {args.out} ({len(pts)} points)")


def cmd_video(args):
    from .io import open_frame_source, read_trajectory
    from .mapping import incremental_map_video

    trajs = [read_trajectory(p) for p in args.traj]
    store = open_frame_source(args.frames)
    snaps = incremental_map_video(trajs if len(trajs) > 1 else trajs[0],
                                  store, _camera(args), args.out_dir,
                                  every=args.every, voxel=args.voxel,
                                  device=_device(args))
    print(f"wrote {len(snaps)} snapshots to {args.out_dir}")


def cmd_slam(args):
    """Online frames-driven SLAM (the reference's flagship ONLINE driver,
    test_gt_graph.cpp:38-130): frame -> feature frontend -> keyframing +
    loop closures -> periodic batch LM -> trajectory/PLY, with optional
    VRO-log recording (recordVROResult role) and ATE/RPE against either a
    TUM groundtruth.txt or a framework trajectory.log."""
    from .io import open_frame_source
    from .io.tum import TumDataset, is_tum_dir
    from .pipelines import OnlineSlam

    dev = _device(args)
    params = _load_params(args)
    preset = _load_config_dict(args)
    src = open_frame_source(args.frames)
    if getattr(args, "camera", None) is None and not (preset or {}).get(
            "camera") and is_tum_dir(args.frames):
        args.camera = "tum-fr1"
        print("note: TUM sequence detected, camera preset 'tum-fr1' "
              "(override with --camera)")
    K = _camera(args, preset)
    backend = args.backend or preset.get("backend", "gtsam")
    slam = OnlineSlam(cam=K, params=params, backend=backend,
                      max_features=args.max_features, n_hyp=args.n_hyp,
                      min_inliers=args.min_inliers, features=args.features,
                      global_loop_k=args.global_loop_k, device=dev)

    counts: dict = {}
    n_fed = 0
    misses = 0
    seq = args.start
    while n_fed < args.max_frames:
        frame = src(seq)
        if frame is None:
            misses += 1
            if misses >= 3 or isinstance(src, TumDataset):
                break          # TUM length is exact; stores may have gaps
            seq += args.stride
            continue
        misses = 0
        st = slam.process_frame(frame[0], frame[1], seq_id=seq)
        counts[st] = counts.get(st, 0) + 1
        n_fed += 1
        seq += args.stride
    if slam.num_keyframes == 0:
        raise SystemExit(f"slam: no frames found under {args.frames}")
    err = slam.optimize()
    summary = " ".join(f"{k}={v}" for k, v in sorted(counts.items()))
    print(f"frames={n_fed} keyframes={slam.num_keyframes} [{summary}]")
    print(f"final chi2: {err:.6f}")

    os.makedirs(args.out_dir, exist_ok=True)
    from .io import write_trajectory, write_trajectory_ply

    ids, t, q, seqs = slam.trajectory()
    write_trajectory(os.path.join(args.out_dir, "trajectory.log"),
                     ids, t, q, seqs)
    write_trajectory_ply(os.path.join(args.out_dir, "trajectory.ply"), t)
    print(f"wrote {args.out_dir}/trajectory.log, trajectory.ply")
    if args.record:
        slam.save_vro_log(args.record)
        print(f"recorded VRO log: {args.record} ({len(slam.records)} edges)")
    if args.marginals:
        _write_pose_marginals(args.marginals, slam.og.graph, slam.og.values,
                              slam.num_keyframes)
    _report_slam_gt(args, src, t, seqs)


def _report_slam_gt(args, src, est_t, est_seq):
    """ATE/RPE for cmd_slam: TUM groundtruth.txt (timestamp-associated) or
    framework trajectory.log (row-indexed)."""
    if not getattr(args, "gt", None):
        return
    from .utils.metrics import ate_rmse, rpe

    if _gt_ncols(args.gt) == 8:      # TUM: t tx ty tz qx qy qz qw
        from .io import groundtruth_at

        ts = getattr(src, "timestamps", None)
        if ts is None:
            print("gt: TUM-format ground truth needs a timestamped "
                  "(TUM) frame source; skipping ATE")
            return
        iq, gt_t, _ = groundtruth_at(args.gt, ts[np.asarray(est_seq)],
                                     max_dt=args.gt_max_dt)
        if len(iq) < 2:
            print("gt: no keyframes matched a ground-truth timestamp")
            return
        est = est_t[iq]
        print(f"ATE RMSE: {ate_rmse(est, gt_t):.6f} m  "
              f"RPE(1): {rpe(est, gt_t):.6f} m  ({len(iq)} matched poses)")
    else:                    # framework log: id x y z qx qy qz qw sid
        _report_vs_gt(args, est_t)


def cmd_ba_imu(args):
    from .imu import read_vn100_log, vn100_params
    from .io import open_frame_source
    from .pipelines.ba_imu import (
        BaImuConfig,
        features_from_store,
        run_ba_imu,
    )

    if args.imu and not args.times:
        raise SystemExit("ba-imu: --times is required with --imu")
    parts = args.seqs.split(":")
    if len(parts) not in (2, 3):
        raise SystemExit("ba-imu: --seqs must be lo:hi or lo:hi:step")
    lo, hi = int(parts[0]), int(parts[1])
    step = int(parts[2]) if len(parts) == 3 else 1
    seqs = list(range(lo, hi, step))
    dev = _device(args)
    store = open_frame_source(args.frames)
    K = _camera(args)
    frames, matches = features_from_store(store, seqs, K, device=dev)
    stream = iparams = None
    times = {}
    if args.imu:
        stream = read_vn100_log(args.imu)
        iparams = vn100_params(device=dev)
        times = _read_times(args.times)
    cfg = BaImuConfig(use_imu=bool(args.imu),
                      sharded=_ranks(args.sharded, dev) if args.sharded
                      else 0)
    res = run_ba_imu(frames, matches, times.get, stream, iparams, K,
                     cfg=cfg, device=dev)
    print(f"chi2 {res.error0:.6f} -> {res.error:.6f} "
          f"(proj={res.n_projection_factors} landmarks={res.n_landmarks} "
          f"imu={res.n_imu_factors})")


def cmd_plane_check(args):
    from .io import VROLog, open_frame_source, read_vro_log
    from .pipelines.plane_check import check_vo_edges

    dev = _device(args)
    log = read_vro_log(args.vro)
    if getattr(args, "pair", None):
        # single-edge scoring (test_plane_dis.cpp role: one from:to pair
        # under the log's VO covariance, plane_dis_two_frames.launch)
        try:
            lo, hi = (int(x) for x in args.pair.split(":"))
        except ValueError:
            raise SystemExit("plane-check: --pair must be FROM:TO")
        sel = (log.id_from == lo) & (log.id_to == hi)
        if not sel.any():
            raise SystemExit(f"plane-check: no edge {lo}->{hi} in {args.vro}")
        log = VROLog(log.id_to[sel], log.id_from[sel], log.xi[sel],
                     log.info[sel])
    planes_of = _plane_provider(open_frame_source(args.frames),
                                _camera(args), dev,
                                max_planes=args.max_planes,
                                min_support=args.min_support)
    rows = check_vo_edges(log, planes_of, out_path=args.out, device=dev)
    bad = sum(1 for r in rows if r[2] > 0 and r[3] > args.thresh)
    print(f"scored {len(rows)} edges, {bad} above Mahalanobis {args.thresh}")
    for r in rows if getattr(args, "pair", None) else []:
        print(f"edge {int(r[1])}->{int(r[0])}: matched_planes={int(r[2])} "
              f"err={r[3]:.4f} err_raw={r[4]:.4f}")
    if args.out:
        print(f"wrote {args.out}")


def cmd_match(args):
    """Two-frame transform + covariance harness.

    The test_match_two_frames.cpp (SVD 3D-3D RANSAC) / test_match_PnP.cpp
    (--method pnp) executables; launch twins match_two_frames.launch and
    match_two_frames_pnp.launch. Prints the estimated T (xi + matrix), the
    6x6 information, and inlier count; --out-ply writes the registration
    overlay the view_registration tier renders. The RANSAC draws are keyed
    by ``--seed``.
    """
    import torch

    from .core import se3
    from .device import to_host
    from .io import open_frame_source
    from .vision.features import extract_features
    from .vision.frontend import match_node_pair
    from .vision.matching import (
        match_descriptors,
        pnp_ransac,
        vo_information,
    )

    dev = _device(args)
    store = open_frame_source(args.frames)
    K = _camera(args)
    got_src, got_tar = store(args.src), store(args.tar)
    if got_src is None or got_tar is None:
        missing = args.src if got_src is None else args.tar
        raise SystemExit(f"match: no frame {missing} under {args.frames}")
    f_src = extract_features(K, got_src[0], got_src[1],
                             max_features=args.max_features, device=dev)
    f_tar = extract_features(K, got_tar[0], got_tar[1],
                             max_features=args.max_features, device=dev)
    key = args.seed
    if args.method == "svd":
        mr = match_node_pair(key, f_tar, f_src, args.tar, args.src,
                             n_hyp=args.n_hyp)
        R, t = (torch.as_tensor(x, device=dev) for x in mr.T)
        info, n_inl, ok = mr.information, mr.num_inliers, mr.succeed
    else:
        # PnP: 3D points of the tar (old) frame vs pixels in src (new)
        from .vision.cal3ds2 import Cal3DS2

        idx, m_ok = match_descriptors(f_src.desc, f_tar.desc)
        dt = torch.float64
        pts_i = f_tar.pts3[idx].to(dt)
        valid = m_ok & f_src.valid & f_tar.valid[idx]
        # pinhole, no distortion: the feature 3D lift (vision.camera.
        # backproject) is pinhole, so the PnP projection model must match
        # or the recovered pose is biased
        cal = Cal3DS2.make(K.fx, K.fy, K.cx, K.cy, dtype=dt, device=dev)
        R, t, inl, ok = pnp_ransac(key, pts_i, f_src.uv.to(dt), valid,
                                   cal, n_hyp=args.n_hyp)
        info = vo_information(R, t, inl, pts_i)
        n_inl, ok = int(inl.sum()), bool(ok)
    if not ok:
        print(f"match FAILED ({args.method}, {n_inl} inliers)")
        return 1
    T = se3.Pose(R, t)
    xi, t_h, info = to_host((se3.logmap(T), t, torch.as_tensor(info)))
    print(f"match OK ({args.method}): {n_inl} inliers")
    print("xi (rot-first se3 log):", " ".join(f"{x:.6f}" for x in xi))
    print("t:", " ".join(f"{x:.6f}" for x in t_h))
    print("info diag:", " ".join(f"{x:.3f}" for x in np.diag(info)))
    if getattr(args, "out_ply", None):
        from .mapping.viewers import write_registration_ply

        n = write_registration_ply(args.out_ply, K, got_tar, got_src, T)
        print(f"wrote {args.out_ply} ({n} points)")
    return 0


def cmd_view(args):
    """Headless viewer tier.

    Stands in for the reference's VTK/Qt visualizers
    (view_registration_vo/list/range.launch -> registration-overlay PLYs;
    view_planes.launch -> plane-mask PNG montage). Artifacts land in
    --out-dir instead of a window.
    """
    import torch

    from .core import se3
    from .io import FAILED_INFO_SENTINEL, open_frame_source
    from .mapping.viewers import write_image_grid, write_registration_ply

    dev = _device(args)
    os.makedirs(args.out_dir, exist_ok=True)
    store = open_frame_source(args.frames)
    K = _camera(args)

    if args.mode == "planes":
        from .planes import extract_plane_node

        if args.frame_id is None:
            raise SystemExit("view: --frame-id is required for mode planes")
        fr = store(args.frame_id)
        if fr is None:
            raise SystemExit(f"view: no frame {args.frame_id}")
        det = extract_plane_node((0, args.frame_id), K, fr[1],
                                 max_planes=args.max_planes,
                                 min_support=args.min_support, device=dev)
        if det is None:
            raise SystemExit("view: no plane reached --min-support")
        inten = np.asarray(fr[0])
        imgs = [inten] + [np.where(m, inten, 0.0) for m in det.masks]
        out = os.path.join(args.out_dir, f"planes_{args.frame_id}.png")
        write_image_grid(out, imgs)
        print(f"{len(det)} planes; wrote {out}")
        return 0

    from .io import read_vro_log

    if not args.vro:
        raise SystemExit(f"view: --vro is required for mode {args.mode}")
    log = read_vro_log(args.vro)
    if args.mode == "pair":
        if args.from_id is None or args.to_id is None:
            raise SystemExit("view: --from-id and --to-id are required "
                             "for mode pair")
        pairs = [(args.from_id, args.to_id)]
    elif args.mode == "range":
        sel = (log.id_from >= args.start) & (log.id_to <= args.end)
        pairs = list(zip(log.id_from[sel].tolist(),
                         log.id_to[sel].tolist()))
    else:  # list: 'id2 id1 num ...' rows filtered by match count
        if not args.list:
            raise SystemExit("view: --list is required for mode list")
        rows = np.atleast_2d(np.loadtxt(args.list))
        keep = (rows[:, 2] >= args.min_num) & (rows[:, 2] <= args.max_num)
        pairs = [(int(r[1]), int(r[0])) for r in rows[keep]]

    emap = {(int(f), int(t)): k for k, (f, t)
            in enumerate(zip(log.id_from, log.id_to))}
    written = 0
    for f_id, t_id in pairs:
        k = emap.get((f_id, t_id))
        if k is None:
            print(f"  {f_id}->{t_id}: not in {args.vro}, skipped")
            continue
        if log.info[k][0, 0] == FAILED_INFO_SENTINEL:
            print(f"  {f_id}->{t_id}: failed edge (sentinel), skipped")
            continue
        fi, fj = store(f_id), store(t_id)
        if fi is None or fj is None:
            print(f"  {f_id}->{t_id}: frame missing, skipped")
            continue
        T = se3.expmap(torch.as_tensor(log.xi[k], device=dev))
        out = os.path.join(args.out_dir, f"reg_{f_id}_{t_id}.ply")
        n = write_registration_ply(out, K, fi, fj, T)
        print(f"  {f_id}->{t_id}: wrote {out} ({n} points)")
        written += 1
    print(f"wrote {written}/{len(pairs)} registration overlays")
    return 0 if written else 1


def cmd_imu_preview(args):
    """IMU dead-reckoning preview (the launch/display tier).

    imu_camera_play.launch runs test_imu_MEMS + a gyro display;
    imu_camera_vn100.launch runs test_vn100. Headless equivalent:
    integrate the gyro stream to Euler angles (CGyroEuler role,
    gyro_euler.cpp:85-114) and write an 'idx t roll pitch yaw' log —
    against the VN100's logged RPY columns when available.
    """
    from .device import to_host
    from .imu import read_mems_log, read_vn100_log
    from .imu.euler import gyro_bias_from_static, integrate_euler

    if args.imu_type == "vn100":
        stream = read_vn100_log(args.imu)
    else:
        stream = read_mems_log(args.imu)
    gyr = np.asarray(stream.gyr)
    dts = np.diff(np.asarray(stream.t),
                  prepend=np.asarray(stream.t)[0]).clip(min=1e-6)
    n_static = min(args.static_samples, len(gyr))
    bias = gyro_bias_from_static(gyr, n_static) if n_static > 0 else None
    rpy = to_host(integrate_euler(gyr, dts, bias=bias, device=_device(args)))
    deg = np.degrees(rpy)
    meas = getattr(stream, "rpy", None)
    with open(args.out, "w") as f:
        for k in range(len(deg)):
            row = f"{k} {stream.t[k]:.6f} " + \
                  " ".join(f"{x:.4f}" for x in deg[k])
            if meas is not None:
                row += " " + " ".join(f"{x:.4f}" for x in meas[k])
            f.write(row + "\n")
    drift = np.abs(deg[-1] - deg[0])
    print(f"{len(deg)} samples over {stream.t[-1] - stream.t[0]:.1f} s; "
          f"end-to-end drift r/p/y = "
          f"{drift[0]:.2f}/{drift[1]:.2f}/{drift[2]:.2f} deg")
    print(f"wrote {args.out}")


def cmd_convert_frames(args):
    from .io import convert_bdat_dir

    n = convert_bdat_dir(args.src, args.dst, suffix=args.suffix,
                         layout=args.layout)
    print(f"converted {n} frames -> {args.dst}")


def cmd_mesh(args):
    from .mapping import pcd_to_mesh, read_pcd

    pts, _ = read_pcd(args.pcd)
    verts, faces = pcd_to_mesh(pts, args.out, cell=args.cell,
                               max_edge=args.max_edge)
    print(f"wrote {args.out}: {len(verts)} vertices, {len(faces)} faces")


def cmd_tsdf(args):
    from .core import extrinsics
    from .io import open_frame_source, read_trajectory
    from .mapping import extract_mesh, fuse_trajectory, write_ply_mesh

    dev = _device(args)
    traj = read_trajectory(args.traj)
    store = open_frame_source(args.frames)
    u2c = extrinsics.camera_to_imu(args.pitch, device=dev) \
        if args.imu_frame else None
    if args.origin is not None:
        origin = np.asarray([float(x) for x in args.origin.split(",")])
    else:
        origin = traj.t.mean(0) - args.size / 2.0
    vol = fuse_trajectory(traj, store, _camera(args), origin, args.size,
                          n=args.n, stride=args.stride, u2c=u2c, device=dev)
    verts, faces = extract_mesh(vol, min_weight=args.min_weight)
    write_ply_mesh(args.out, verts, faces)
    print(f"wrote {args.out}: {len(verts)} vertices, {len(faces)} faces "
          f"(grid {args.n}^3, voxel {args.size / args.n:.3f} m)")


def cmd_filter(args):
    from .mapping import occupancy_denoise, passthrough, read_pcd, write_pcd

    pts, cols = read_pcd(args.pcd)
    if args.z_min is not None or args.z_max is not None:
        lo = args.z_min if args.z_min is not None else -np.inf
        hi = args.z_max if args.z_max is not None else np.inf
        if cols is not None:
            pts, cols = passthrough(pts, cols, lo=lo, hi=hi)
        else:
            pts = passthrough(pts, lo=lo, hi=hi)
    if cols is not None:
        pts, cols = occupancy_denoise(pts, cols, voxel=args.voxel,
                                      min_neighbors=args.min_neighbors)
    else:
        pts = occupancy_denoise(pts, voxel=args.voxel,
                                min_neighbors=args.min_neighbors)
    write_pcd(args.out, pts, cols)
    print(f"wrote {args.out} ({len(pts)} points)")


def cmd_publish(args):
    from .mapping import publish_pcd

    print(f"publishing {args.pcd} on {args.host}:{args.port} "
          f"at {args.rate} Hz (frame_id={args.frame_id})")
    publish_pcd(args.pcd, host=args.host, port=args.port,
                rate_hz=args.rate, max_cycles=args.cycles,
                frame_id=args.frame_id)


def cmd_serve(args):
    from .config import SlamParams
    from .serving import serve_slam

    params = SlamParams(optimize_step=args.optimize_step)

    def on_bound(port):
        # printed AFTER bind so --port 0 reports the real ephemeral port
        print(f"SLAM service on {args.host}:{port} "
              f"(camera={args.camera}, "
              f"optimize_step={args.optimize_step})", flush=True)

    serve_slam(_camera(args), params, host=args.host, port=args.port,
               max_messages=args.max_messages, on_bound=on_bound,
               slam_kwargs={"features": args.features},
               device=_device(args))


def cmd_bench(args):
    """The reference bench's headline on the port (``bench.py:54-72``):
    ``make_sphere_graph(2500)`` in float32, 200 GN iterations of PCG-10,
    timed warm; prints GN it/s and the chi2 drop."""
    import time

    import torch

    from .datasets import make_sphere_graph
    from .graph import gn_optimize, total_error

    dev = _device(args)
    graph, values, _ = make_sphere_graph(2500, 4.0, seed=0,
                                         dtype=torch.float32, bucket=256,
                                         device=dev)
    e0 = float(total_error(graph, values))
    gn_optimize(graph, values, iterations=2, solver="pcg", damping=1e-3,
                pcg_iters=10)                                  # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = gn_optimize(graph, values, iterations=200, solver="pcg",
                      damping=1e-3, pcg_iters=10)
    err = float(res.error)
    wall = time.perf_counter() - t0
    print(f"sphere2500 PCG-10 float32 on {dev}: {200 / wall:.2f} GN it/s, "
          f"chi2 {e0:.6f} -> {err:.6f} ({e0 / err:.3f}x drop, 200 "
          "iterations)")


def cmd_presets(args):
    from .config import load_config_dict, preset_names

    for name in preset_names():
        desc = load_config_dict(name).get("description", "")
        print(f"{name:28s} {desc}")


def _subcommand(argv):
    """The subcommand of ``argv``: its first word that is not a top-level
    option or an option's value."""
    it = iter(argv)
    for a in it:
        if a == "--device":
            next(it, None)
        elif not a.startswith("-"):
            return a
    return None


def _apply_preset_args(subparsers, argv):
    """Apply a preset's "args" section as flag defaults for its subcommand.

    Launch-file ``<param>`` tags ship as the preset's ``args`` dict
    (config.py reserved keys). Every key must name a real flag of the
    invoked subcommand — presets can't silently rot — and a preset's
    ``tool`` key pins which subcommand it parameterizes. Explicit CLI
    flags still override (argparse defaults lose to given flags).
    """
    cmd = _subcommand(argv)
    sp = subparsers.get(cmd) if cmd else None
    if sp is None:
        return
    cfg = None
    for k, a in enumerate(argv):
        if a == "--config" and k + 1 < len(argv):
            cfg = argv[k + 1]
        elif a.startswith("--config="):
            cfg = a.split("=", 1)[1]
    if not cfg:
        return
    from .config import load_config_dict

    preset = load_config_dict(cfg)
    tool = preset.get("tool")
    if tool and tool != cmd:
        raise SystemExit(
            f"config {cfg!r} parameterizes subcommand '{tool}', not "
            f"'{cmd}' (run: python -m graph_slam_tpu_torch {tool} --config "
            f"{cfg})")
    overrides = preset.get("args", {})
    by_dest = {a.dest: a for a in sp._actions}
    defaults = {}
    for key, val in overrides.items():
        dest = key.replace("-", "_")
        if dest not in by_dest:
            raise SystemExit(f"config {cfg!r}: its args section names "
                             f"{key!r}, which is not a flag of '{cmd}'")
        defaults[dest] = val
        by_dest[dest].required = False   # a preset default satisfies it
    if defaults:
        sp.set_defaults(**defaults)


def build_parser():
    """The full CLI parser + its subparser registry (tests validate preset
    args sections against the real flags through this): the reference's
    flags, defaults and choices, plus the top-level ``--device``."""
    p = argparse.ArgumentParser(
        prog="graph_slam_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device the estimators run on (default: the "
                        "CUDA card; 'cpu' runs on the CPU)")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("posegraph", help="offline pose-graph SLAM from a VRO log")
    s.add_argument("--vro", required=True)
    s.add_argument("--out-dir", default="out")
    s.add_argument("--config",
                   help="JSON SlamParams overrides: a file path or a "
                        "shipped preset name (see 'presets')")
    s.add_argument("--pitch", type=float, default=0.0)
    s.add_argument("--imu-frame", action="store_true",
                   help="conjugate edges into the IMU frame (T_u2c)")
    s.add_argument("--backend", choices=["gtsam", "g2o"], default=None,
                   help="fake-odometry weighting: gtsam I*1e4 or g2o "
                        "I*1e-3 (default gtsam, or the preset's)")
    s.add_argument("--marginals",
                   help="write per-pose 6x6 marginal covariances "
                        "(id + 21 upper-tri entries per line)")
    s.add_argument("--gt", help="ground-truth trajectory log for ATE/RPE")
    s.add_argument("--init", choices=["odometry", "chordal"],
                   default="odometry",
                   help="initialization: odometry composition (reference "
                        "semantics) or chordal relaxation (rotation "
                        "averaging + linear translations)")
    s.add_argument("--robust", choices=["huber", "gnc-tls", "gnc-gm"],
                   default=None,
                   help="robust edge handling: per-row Huber kernel or "
                        "graduated non-convexity over loop closures "
                        "(overrides the config's)")
    s.add_argument("--loop-gate", choices=["none", "pcm"], default="none",
                   dest="loop_gate",
                   help="pre-optimization loop-closure gating: pcm keeps "
                        "only the maximum pairwise-consistent set "
                        "(composes with --robust)")
    s.set_defaults(fn=cmd_posegraph)

    s = sub.add_parser("vio", help="plane-aided VIO replay (VRO + IMU)")
    s.add_argument("--vro", required=True)
    s.add_argument("--imu", required=True)
    s.add_argument("--imu-type", choices=["vn100", "mems"], default=None,
                   help="IMU preset (default vn100, or the config's)")
    s.add_argument("--times", required=True,
                   help="file of 'seq_id timestamp' lines")
    s.add_argument("--plane-mode", choices=["rescue", "always", "off"],
                   default=None,
                   help="plane factor policy (default off — or 'rescue' "
                        "when --frames is given, or the config's)")
    s.add_argument("--frames",
                   help="frame directory (.gsf or PNG pairs) enabling the "
                        "frames-driven plane rescue (flips the default "
                        "--plane-mode to 'rescue')")
    s.add_argument("--camera", choices=["sr4000", "rs435", "tum-fr1", "tum-fr2", "tum-fr3"], default=None)
    s.add_argument("--engine", choices=["online", "scan"],
                   default=None,
                   help="replay engine: per-frame online arenas (default) "
                        "or the whole-replay-on-device scan")
    s.add_argument("--out-dir", default="out")
    s.add_argument("--config",
                   help="JSON config path or preset name (see 'presets')")
    s.add_argument("--pitch", type=float, default=0.0)
    s.add_argument("--gt", help="ground-truth trajectory log for ATE/RPE")
    s.add_argument("--trace-dir", help="torch.profiler trace output directory")
    s.add_argument("--extrinsic",
                   choices=["sr4000", "identity", "rs435-translation"],
                   default=None,
                   help="camera-IMU extrinsic: the SR4000 RzRyRx "
                        "composition (setCamera2IMU), identity, or the "
                        "RealSense translation-only variant "
                        "(setCamera2IMUTranslation) "
                        "(default sr4000, or the config's)")
    s.add_argument("--gravity-init", action="store_true",
                   help="align the first pose to measured gravity and seed "
                        "the bias from the pre-sync static IMU window "
                        "(initFromImu + static bias estimation)")
    s.set_defaults(fn=cmd_vio)

    s = sub.add_parser("convert", help="rewrite a VRO log (ba/hybrid/cut)")
    s.add_argument("--vro", required=True)
    s.add_argument("--model", choices=["ba", "hybrid", "cut"], required=True)
    s.add_argument("--matches", help="'id2 id1 num' lines (input_match.log)")
    s.add_argument("--min-match-num", type=int, default=10)
    s.add_argument("--out")
    s.set_defaults(fn=cmd_convert)

    s = sub.add_parser("merge", help="merge BA and VRO logs by match count")
    s.add_argument("--ba", required=True)
    s.add_argument("--vro", required=True)
    s.add_argument("--matches", required=True)
    s.add_argument("--thresh", type=int, default=20)
    s.add_argument("--out", default="vo_results_merge.log")
    s.set_defaults(fn=cmd_merge)

    s = sub.add_parser("delete-vo",
                       help="void VO edges failing plane consistency")
    s.add_argument("--vro", required=True)
    s.add_argument("--scores",
                   help="pre-computed plane-check rows ('id2 id1 num err "
                        "err_raw', from plane-check --out); otherwise "
                        "scored from --frames")
    s.add_argument("--frames", help="frame directory (when no --scores)")
    s.add_argument("--camera", choices=["sr4000", "rs435", "tum-fr1", "tum-fr2", "tum-fr3"], default="sr4000")
    s.add_argument("--max-planes", type=int, default=4)
    s.add_argument("--thresh", type=float, default=100.0,
                   help="Mahalanobis score above which an edge is voided")
    s.add_argument("--out", default="vo_results_deleted.log")
    s.set_defaults(fn=cmd_delete_vo)

    s = sub.add_parser("add-vo-sparse",
                       help="add VO edges around feature-sparse frames")
    s.add_argument("--vro", required=True)
    s.add_argument("--frames", required=True)
    s.add_argument("--camera", choices=["sr4000", "rs435", "tum-fr1", "tum-fr2", "tum-fr3"], default="sr4000")
    s.add_argument("--window", type=int, default=5)
    s.add_argument("--sparse-thresh", type=int, default=60)
    s.add_argument("--max-features", type=int, default=256)
    s.add_argument("--out", default="vo_results_added.log")
    s.set_defaults(fn=cmd_add_vo_sparse)

    s = sub.add_parser("diff", help="difference of two VO logs")
    s.add_argument("--log1", required=True)
    s.add_argument("--log2", required=True)
    s.set_defaults(fn=cmd_diff)

    s = sub.add_parser("g2o", help="ingest + optimize a standard .g2o pose graph")
    s.add_argument("--input", required=True)
    s.add_argument("--out-dir", default="out")
    s.add_argument("--sharded", type=int, default=0, metavar="N",
                   help="optimize with factor-sharded matrix-free PCG over "
                        "N devices (0 = single-device LM)")
    s.add_argument("--iters", type=int, default=20,
                   help="GN iterations in --sharded mode")
    s.add_argument("--init", choices=["odometry", "chordal"],
                   default="odometry",
                   help="chordal = rotation-averaging initialization "
                        "before the solve")
    s.add_argument("--loop-gate", choices=["none", "pcm"], default="none",
                   dest="loop_gate",
                   help="pcm keeps only the maximum pairwise-consistent "
                        "loop-closure set before the solve (single-device "
                        "path)")
    s.set_defaults(fn=cmd_g2o)

    s = sub.add_parser("sparsify",
                       help="graph maintenance: marginalize poses, replace "
                            "eliminated cliques with Chow-Liu trees")
    s.add_argument("--vro", required=True)
    s.add_argument("--out-dir", default="out")
    s.add_argument("--config",
                   help="JSON SlamParams overrides: a file path or a "
                        "shipped preset name")
    s.add_argument("--keep-every", type=int, default=2, dest="keep_every",
                   help="keep every K-th pose (anchored pose 0 always kept)")
    s.add_argument("--drop",
                   help="explicit comma-separated pose ids to remove "
                        "(overrides --keep-every)")
    s.set_defaults(fn=cmd_sparsify)

    s = sub.add_parser("map", help="trajectory + frames -> PCD/PLY map")
    s.add_argument("--traj", required=True)
    s.add_argument("--frames", required=True, help=".gsf frame directory")
    s.add_argument("--out", required=True, help=".pcd or .ply output")
    s.add_argument("--camera", choices=["sr4000", "rs435", "tum-fr1", "tum-fr2", "tum-fr3"], default="sr4000")
    s.add_argument("--stride", type=int, default=7)
    s.add_argument("--skip", type=int, default=2)
    s.add_argument("--voxel", type=float, default=0.0)
    s.add_argument("--roi", metavar="U0,V0,U1,V1",
                   help="pixel region of interest (top_left_u/v, "
                        "bot_right_u/v of mapping_PCD.launch); pixels "
                        "outside are dropped, geometry unchanged")
    s.add_argument("--z-max", type=float, default=10.0,
                   help="depth passthrough ceiling in meters "
                        "(z_pass_through of mapping_PCD_rs.launch)")
    s.add_argument("--pitch", type=float, default=0.0)
    s.add_argument("--imu-frame", action="store_true")
    s.set_defaults(fn=cmd_map)

    s = sub.add_parser("video", help="incremental map snapshot replay")
    s.add_argument("--traj", required=True, nargs="+",
                   help="one or more trajectory logs (mtraj overlay)")
    s.add_argument("--frames", required=True)
    s.add_argument("--out-dir", default="snaps")
    s.add_argument("--camera", choices=["sr4000", "rs435", "tum-fr1", "tum-fr2", "tum-fr3"], default="sr4000")
    s.add_argument("--every", type=int, default=5)
    s.add_argument("--voxel", type=float, default=0.05)
    s.set_defaults(fn=cmd_video)

    s = sub.add_parser(
        "evaluate", help="trajectory evaluation: full ATE/RPE statistics "
        "vs TUM groundtruth.txt or a trajectory.log")
    s.add_argument("--est", required=True, help="estimated trajectory.log")
    s.add_argument("--gt", required=True,
                   help="TUM groundtruth.txt or framework trajectory.log")
    s.add_argument("--frames",
                   help="TUM sequence dir (timestamps for TUM-format gt)")
    s.add_argument("--delta", type=int, default=1, help="RPE frame delta")
    s.add_argument("--scale", action="store_true",
                   help="Sim(3) alignment (estimate scale too)")
    s.add_argument("--gt-max-dt", type=float, default=0.02)
    s.add_argument("--json", help="write the stats as JSON")
    s.add_argument("--aligned", help="write the aligned estimate as PLY")
    s.set_defaults(fn=cmd_evaluate)

    s = sub.add_parser(
        "slam", help="ONLINE frames-driven SLAM (test_gt_graph role): "
        "feature frontend + keyframing + loop closures + periodic LM")
    s.add_argument("--frames", required=True,
                   help="frame dir (.gsf store, TUM sequence, or PNG pairs)")
    s.add_argument("--out-dir", default="out")
    s.add_argument("--camera",
                   choices=["sr4000", "rs435", "tum-fr1", "tum-fr2",
                            "tum-fr3"],
                   default=None,
                   help="intrinsics preset (default: tum-fr1 for TUM "
                        "sequences, else sr4000)")
    s.add_argument("--config", help="JSON preset (configs/*.json)")
    s.add_argument("--backend", choices=["gtsam", "g2o"], default=None,
                   help="fake-odometry weighting semantics")
    s.add_argument("--features", choices=["harris", "sift"],
                   default="harris")
    s.add_argument("--start", type=int, default=0)
    s.add_argument("--stride", type=int, default=1)
    s.add_argument("--max-frames", type=int, default=1000000)
    s.add_argument("--max-features", type=int, default=256)
    s.add_argument("--n-hyp", type=int, default=2048,
                   help="RANSAC hypotheses per match")
    s.add_argument("--min-inliers", type=int, default=12)
    s.add_argument("--global-loop-k", type=int, default=0,
                   help="place-recognition loop-closure proposals per "
                        "keyframe beyond the lookback window (0 = off)")
    s.add_argument("--record", help="write the accepted edges as a VRO log")
    s.add_argument("--marginals",
                   help="write per-pose 6x6 marginal covariances "
                        "(id + 21 upper-tri entries per line)")
    s.add_argument("--gt", help="TUM groundtruth.txt or trajectory.log "
                                "for ATE/RPE")
    s.add_argument("--gt-max-dt", type=float, default=0.02)
    s.set_defaults(fn=cmd_slam)

    s = sub.add_parser("ba-imu", help="BA(+IMU) over a frame sequence")
    s.add_argument("--frames", required=True)
    s.add_argument("--seqs", required=True, help="lo:hi[:step] sequence ids")
    s.add_argument("--camera", choices=["sr4000", "rs435", "tum-fr1", "tum-fr2", "tum-fr3"], default="sr4000")
    s.add_argument("--imu", help="VN100 log (optional)")
    s.add_argument("--times", help="'seq_id timestamp' lines (with --imu)")
    s.add_argument("--sharded", type=int, default=0, metavar="N",
                   help="landmark-sharded solve over an N-device mesh")
    s.set_defaults(fn=cmd_ba_imu)

    s = sub.add_parser("plane-check",
                       help="plane-consistency scoring of VO edges")
    s.add_argument("--vro", required=True)
    s.add_argument("--frames", required=True)
    s.add_argument("--camera", choices=["sr4000", "rs435", "tum-fr1", "tum-fr2", "tum-fr3"], default="sr4000")
    s.add_argument("--max-planes", type=int, default=4)
    s.add_argument("--min-support", type=int, default=300,
                   help="min inlier pixels per plane "
                        "(min_num_pts_of_plane)")
    s.add_argument("--thresh", type=float, default=100.0)
    s.add_argument("--pair", metavar="FROM:TO",
                   help="score only this edge (test_plane_dis role, "
                        "plane_dis_two_frames.launch)")
    s.add_argument("--out")
    s.set_defaults(fn=cmd_plane_check)

    s = sub.add_parser("match",
                       help="two-frame transform + covariance harness "
                            "(test_match_two_frames / test_match_PnP)")
    s.add_argument("--frames", required=True)
    s.add_argument("--src", type=int, required=True,
                   help="new-frame seq id (src_filename role)")
    s.add_argument("--tar", type=int, required=True,
                   help="base-frame seq id (tar_filename role)")
    s.add_argument("--camera", choices=["sr4000", "rs435", "tum-fr1", "tum-fr2", "tum-fr3"], default="sr4000")
    s.add_argument("--method", choices=["svd", "pnp"], default="svd")
    s.add_argument("--max-features", type=int, default=256)
    s.add_argument("--n-hyp", type=int, default=2048)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--out-ply", help="registration-overlay PLY")
    s.set_defaults(fn=cmd_match)

    s = sub.add_parser("view",
                       help="headless viewer artifacts: registration "
                            "overlays + plane montages")
    s.add_argument("--mode", choices=["pair", "list", "range", "planes"],
                   required=True)
    s.add_argument("--frames", required=True)
    s.add_argument("--vro", help="VRO log (pair/list/range modes)")
    s.add_argument("--from-id", type=int, help="pair mode: base frame")
    s.add_argument("--to-id", type=int, help="pair mode: observed frame")
    s.add_argument("--start", type=int, default=0, help="range mode")
    s.add_argument("--end", type=int, default=1 << 30, help="range mode")
    s.add_argument("--list", help="'id2 id1 num' rows (list mode)")
    s.add_argument("--min-num", type=float, default=1)
    s.add_argument("--max-num", type=float, default=float("inf"))
    s.add_argument("--frame-id", type=int, help="planes mode")
    s.add_argument("--max-planes", type=int, default=4)
    s.add_argument("--min-support", type=int, default=300)
    s.add_argument("--camera", choices=["sr4000", "rs435", "tum-fr1", "tum-fr2", "tum-fr3"], default="sr4000")
    s.add_argument("--out-dir", default="views")
    s.set_defaults(fn=cmd_view)

    s = sub.add_parser("imu-preview",
                       help="gyro dead-reckoning preview "
                            "(launch/display tier)")
    s.add_argument("--imu", required=True)
    s.add_argument("--imu-type", choices=["vn100", "mems"],
                   default="vn100")
    s.add_argument("--static-samples", type=int, default=100,
                   help="pre-sync samples for gyro bias estimation")
    s.add_argument("--out", default="rpy.log")
    s.set_defaults(fn=cmd_imu_preview)

    s = sub.add_parser("convert-frames",
                       help="SR4000 .bdat dataset -> .gsf frame directory")
    s.add_argument("--src", required=True)
    s.add_argument("--dst", required=True)
    s.add_argument("--suffix", default="bdat")
    s.add_argument("--layout", choices=["zxyi", "zf_i", "z_i"],
                   help="override the auto-detected .bdat layout")
    s.set_defaults(fn=cmd_convert_frames)

    s = sub.add_parser("mesh", help="PCD -> triangle mesh PLY")
    s.add_argument("--pcd", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--cell", type=float, default=0.05)
    s.add_argument("--max-edge", type=float, default=0.15)
    s.set_defaults(fn=cmd_mesh)

    s = sub.add_parser("tsdf",
                       help="trajectory + frames -> fused TSDF -> mesh PLY "
                            "(volumetric upgrade over map+mesh)")
    s.add_argument("--traj", required=True)
    s.add_argument("--frames", required=True, help=".gsf frame directory")
    s.add_argument("--out", required=True, help=".ply mesh output")
    s.add_argument("--size", type=float, default=8.0,
                   help="cubic volume edge length in meters")
    s.add_argument("--n", type=int, default=128, help="grid resolution")
    s.add_argument("--origin",
                   help="x,y,z of the volume corner (default: cube "
                        "centered on the trajectory mean)")
    s.add_argument("--stride", type=int, default=1)
    s.add_argument("--min-weight", type=float, default=1.0)
    s.add_argument("--camera", choices=["sr4000", "rs435", "tum-fr1", "tum-fr2", "tum-fr3"],
                   default="sr4000")
    s.add_argument("--pitch", type=float, default=0.0)
    s.add_argument("--imu-frame", action="store_true")
    s.set_defaults(fn=cmd_tsdf)

    s = sub.add_parser("filter", help="denoise / passthrough a PCD")
    s.add_argument("--pcd", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--voxel", type=float, default=0.05)
    s.add_argument("--min-neighbors", type=int, default=3)
    s.add_argument("--z-min", type=float)
    s.add_argument("--z-max", type=float)
    s.set_defaults(fn=cmd_filter)

    s = sub.add_parser("publish",
                       help="republish a PCD to TCP subscribers "
                            "(pub_pcd role, PointCloud2 layout)")
    s.add_argument("--pcd", required=True)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=7100)
    s.add_argument("--rate", type=float, default=1.0)
    s.add_argument("--cycles", type=int, default=None,
                   help="stop after N publishes (default: forever)")
    s.add_argument("--frame-id", default="map")
    s.set_defaults(fn=cmd_publish)

    s = sub.add_parser("serve",
                       help="streaming SLAM service: RGB-D frames in over "
                            "TCP, poses out (the online ROS-node role)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=7200)
    s.add_argument("--camera", choices=["sr4000", "rs435", "tum-fr1", "tum-fr2", "tum-fr3"],
                   default="sr4000")
    s.add_argument("--optimize-step", type=int, default=10)
    s.add_argument("--max-messages", type=int, default=None,
                   help="stop after N messages (default: until 'end')")
    s.add_argument("--features", choices=["harris", "sift"],
                   default="harris",
                   help="frontend: harris+patch or DoG/SIFT-class "
                        "(rotation/scale-invariant)")
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("bench", help="sphere2500 GN throughput benchmark")
    s.set_defaults(fn=cmd_bench)

    s = sub.add_parser("presets",
                       help="list shipped launch-file-equivalent presets")
    s.set_defaults(fn=cmd_presets)

    # every subcommand accepts --config (a shipped launch-twin preset name
    # or a JSON path); a preset's "args" section becomes flag defaults
    for name, sp in sub.choices.items():
        if not any(a.dest == "config" for a in sp._actions):
            sp.add_argument("--config",
                            help="JSON preset (configs/*.json name or "
                                 "path); its 'args' section sets flag "
                                 "defaults for this subcommand")
    return p, sub


def main(argv=None):
    p, sub = build_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    _apply_preset_args(sub.choices, argv)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
