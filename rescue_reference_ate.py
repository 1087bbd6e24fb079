#!/usr/bin/env python3
"""The JAX package's flagship accuracy on the CPU, for ``chip_smoke.py``'s
``rescue`` phase to hold the port to.

    JAX_PLATFORMS=cpu python3 rescue_reference_ate.py [--frames 2000]
        [--engine scan|online]

Replays ``make_vio_plane_scenario(N, fail_every=100, render="lazy")`` with
the JAX bench's ``vio_planes_2k`` configuration (``bench.py:343-345``:
plane rescue, optimize every 10 frames, IMU window 64, window 16, no final
batch) through the scan engine (the default) or the per-frame online
engine (``--engine online``, the bench's ``compare_online`` configuration,
``bench.py:369``) in float64 and prints one JSON line: the ATE RMSE in
metres (Umeyama-aligned, ``chip_smoke._ate``'s formula), the mean rotation
error, the path length and the rescue's counts. Takes minutes on one CPU.
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
    args = ap.parse_args()
    log, times, stream, params, frames, K, (gt_R, gt_t) = \
        make_vio_plane_scenario(n_frames=args.frames, fail_every=100,
                                render="lazy", return_gt=True)
    cfg = VioConfig(engine=args.engine, plane_mode="rescue", optimize_step=10,
                    max_imu_window=64, bucket=64, window=16,
                    final_batch=False)
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
    print(json.dumps({
        "frames": args.frames, "ate_rmse_m": ate, "ate_rot_mean_deg": rot,
        "path_m": path, "n_plane_factors": int(res.n_plane_factors),
        "landmarks": len(res.plane_book.world),
        "engine": args.engine,
        # the online engine times no rescue step: count the failed
        # new-frame records it rescued from the log
        "rescue_steps": res.timers["rescue_step"]["calls"]
        if "rescue_step" in res.timers else _failed_new_records(log),
        "error": res.error, "cpu_wall_s": wall,
        "jax": jax.__version__}))


if __name__ == "__main__":
    main()
