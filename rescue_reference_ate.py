#!/usr/bin/env python3
"""The JAX package's flagship accuracy on the CPU, for ``chip_smoke.py``'s
``rescue`` phase to hold the port to.

    JAX_PLATFORMS=cpu python3 rescue_reference_ate.py [--frames 2000]
        [--engine scan|online] [--seed 0] [--save out.npz]
        [--frames-dtype float32|float64]
    JAX_PLATFORMS=cpu python3 rescue_reference_ate.py --frames N --scenario-only

Replays ``make_vio_plane_scenario(N, fail_every=100, render="lazy")`` with
the JAX bench's ``vio_planes_2k`` configuration (``bench.py:343-345``:
plane rescue, optimize every 10 frames, IMU window 64, window 16, no final
batch) through the scan engine (the default) or the per-frame online
engine (``--engine online``, the bench's ``compare_online`` configuration,
``bench.py:369``) in float64 and prints one JSON line: the ATE RMSE in
metres (Umeyama-aligned, ``chip_smoke._ate``'s formula), the mean rotation
error, the path length and the rescue's counts. Takes minutes on one CPU
at 2,000 frames and grows about linearly with the length.

``--seed`` sets ``VioConfig.seed``, the key of the RANSAC draws.
``--frames-dtype float64`` casts the rendered frames to float64, so the
JAX package refits the rescue's planes in float64, as the port does by
design; with the frames' own float32 (the default) it refits them in
float32.

``--scenario-only`` replays nothing: it prints the largest gaps between
the JAX package's scenario and the port's at N frames (the log, the IMU
stream, the ground truth and three rendered frames).

``--save PATH`` also writes an ``.npz`` that ``rescue_port_ate.py
--against`` holds the port's run to: the frames' sequence
ids and final poses, one row per rescue step (node, frame, planes
predicted, fresh extractions, plane factors and landmarks added), the
planes of each rescued node and those freshly extracted at its previous
node, the landmark book and the printed counts.
"""

import argparse
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from graph_slam_tpu.datasets import make_vio_plane_scenario  # noqa: E402
from graph_slam_tpu.pipelines.vio import VioConfig, run_vio  # noqa: E402


def _chunk_precompute(size=4):
    """Split the scan engine's batched extraction of the rescue sources
    into batches of ``size`` frames. The JAX package extracts every
    source in one vmapped program whose hypothesis buffer is ~1.3 GB a
    frame in float64 (335 GB for the 269 sources at 27,000 frames); each
    frame keeps its own key, so only the batch size changes."""
    from graph_slam_tpu.pipelines import vio_planes

    batch = vio_planes._PlaneStack.precompute_detections

    def chunked(stack, gid2seq):
        items = sorted(gid2seq.items())
        for i in range(0, len(items), size):
            batch(stack, dict(items[i:i + size]))

    vio_planes._PlaneStack.precompute_detections = chunked


def _as_float64(frames):
    """The lazy frame source with its intensity and depth in float64."""
    def get(f):
        fr = frames(f)
        return None if fr is None else tuple(np.asarray(x, np.float64)
                                             for x in fr)
    return get


def _scenario_gaps(n_frames):
    """The largest absolute gap of each input of the rescue scenario
    between the JAX package and the port, at ``n_frames``."""
    from graph_slam_tpu_torch.datasets import \
        make_vio_plane_scenario as port_scenario

    kw = dict(n_frames=n_frames, fail_every=100, render="lazy",
              return_gt=True)
    a = make_vio_plane_scenario(**kw)
    b = port_scenario(**kw, device="cpu")

    def gap(x, y):
        return float(np.abs(np.asarray(x, np.float64)
                            - np.asarray(y, np.float64)).max())

    out = {f"log.{f}": gap(getattr(a[0], f), getattr(b[0], f))
           for f in ("id_to", "id_from", "xi", "info")}
    out["times"] = max(abs(float(a[1][k]) - float(b[1][k])) for k in a[1])
    out.update({f"imu.{f}": gap(getattr(a[2], f), getattr(b[2], f))
                for f in ("t", "acc", "gyr")})
    out["gt_R"], out["gt_t"] = gap(a[6][0], b[6][0]), gap(a[6][1], b[6][1])
    for f in (0, n_frames // 2, n_frames - 1):
        out[f"frame_{f}"] = max(gap(x, y) for x, y in zip(a[4](f), b[4](f)))
    return out


def _ate(est_R, est_t, gt_R, gt_t):
    """``chip_smoke._ate``: ATE RMSE after a rigid Umeyama alignment, and
    the mean geodesic rotation error (degrees) after a rotation-average
    alignment."""
    mu_e, mu_g = est_t.mean(0), gt_t.mean(0)
    U, _, Vt = np.linalg.svd((gt_t - mu_g).T @ (est_t - mu_e) / len(est_t))
    W = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        W[2, 2] = -1.0
    R = U @ W @ Vt
    d = (R @ est_t.T).T + (mu_g - R @ mu_e) - gt_t
    ate = float(np.sqrt((d * d).sum(1).mean()))
    U, _, Vt = np.linalg.svd(np.einsum("kij,klj->il", gt_R, est_R))
    W = np.eye(3)
    W[2, 2] = np.sign(np.linalg.det(U @ Vt))
    E = np.einsum("kji,jl,klm->kim", gt_R, U @ W @ Vt, est_R)
    tr = np.clip((np.trace(E, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return ate, float(np.degrees(np.arccos(tr)).mean())


def _failed_new_records(log):
    """``chip_smoke._failed_new_records``: records whose VO edge failed on
    a frame not seen before, the ones the rescue takes."""
    from graph_slam_tpu.io.vro_log import FAILED_INFO_SENTINEL

    seen, n = {int(log.id_from[0])}, 0
    for k in range(len(log)):
        if int(log.id_from[k]) not in seen:
            continue
        new = int(log.id_to[k]) not in seen
        seen.add(int(log.id_to[k]))
        n += new and bool(log.info[k, 0, 0] == FAILED_INFO_SENTINEL)
    return n


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--engine", choices=("scan", "online"), default="scan")
    ap.add_argument("--seed", type=int, default=0,
                    help="VioConfig.seed: the key of the RANSAC draws")
    ap.add_argument("--save", default=None,
                    help="write the run's poses and rescue records here")
    ap.add_argument("--frames-dtype", choices=("float32", "float64"),
                    default="float32",
                    help="the dtype the plane stack sees the frames in")
    ap.add_argument("--scenario-only", action="store_true",
                    help="compare the scenario with the port's; no replay")
    args = ap.parse_args()
    if args.scenario_only:
        print(json.dumps({"frames": args.frames,
                          **_scenario_gaps(args.frames)}))
        return
    rec = None
    if args.save:
        from graph_slam_tpu.pipelines import vio_planes
        from graph_slam_tpu.planes import plane_node
        from rescue_port_ate import RescueRecorder

        rec = RescueRecorder(vio_planes, plane_node)
    _chunk_precompute()
    log, times, stream, params, frames, K, (gt_R, gt_t) = \
        make_vio_plane_scenario(n_frames=args.frames, fail_every=100,
                                render="lazy", return_gt=True)
    if args.frames_dtype == "float64":
        frames = _as_float64(frames)
    cfg = VioConfig(engine=args.engine, plane_mode="rescue", optimize_step=10,
                    max_imu_window=64, bucket=64, window=16,
                    final_batch=False, seed=args.seed)
    t0 = time.perf_counter()
    res = run_vio(log, times, stream, params, frames=frames, intrinsics=K,
                  cfg=cfg)
    wall = time.perf_counter() - t0
    n = len(res.seq_ids)
    seqs = np.asarray(res.seq_ids, int)
    ate, rot = _ate(np.asarray(res.values.pose_R[:n]),
                    np.asarray(res.values.pose_t[:n]), gt_R[seqs],
                    gt_t[seqs])
    path = float(np.linalg.norm(np.diff(gt_t, axis=0), axis=1).sum())
    out = {
        "frames": args.frames, "seed": args.seed,
        "frames_dtype": args.frames_dtype, "ate_rmse_m": ate,
        "ate_rot_mean_deg": rot,
        "path_m": path, "n_plane_factors": int(res.n_plane_factors),
        "landmarks": len(res.plane_book.world),
        "engine": args.engine,
        # the online engine times no rescue step: count the failed
        # new-frame records it rescued from the log
        "rescue_steps": res.timers["rescue_step"]["calls"]
        if "rescue_step" in res.timers else _failed_new_records(log),
        "error": res.error, "cpu_wall_s": wall,
        "jax": jax.__version__}
    if rec is not None:
        np.savez_compressed(args.save, **rec.arrays(res, out))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
