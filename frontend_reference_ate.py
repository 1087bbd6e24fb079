#!/usr/bin/env python3
"""A rendered box room for online RGB-D SLAM, and the JAX package's run
over it, for ``chip_smoke.py``'s ``frontend`` phase to hold the port to.

    JAX_PLATFORMS=cpu python3 frontend_reference_ate.py \
        [--frames 1000] [--features harris|sift] [--path N] [--gsf DIR]

The room is a 6 x 3 x 6 m box whose six faces carry the 3 cm random grid
of ``tests/test_pipelines2.py:render_wall_frame`` (one grid a face),
rendered by ray-plane intersection at the ``RS435`` intrinsics, 640 x 480,
float32 intensity and exact depth, in torch: on the card for
``chip_smoke.py`` and on the CPU for ``main``, the same bits on both. The
camera circles 0.8 m around a point 2.5 m from the far wall at a steady
~3 cm a frame while its yaw swings +-30 degrees (under 1.3 degrees a
frame); the path closes after a whole number of laps and swings, so the
camera comes back to its start and revisits the same views lap after lap.
Every keyframe is then two frames from the last: one frame is 3 cm (below
``SlamParams.small_translation``), two are 6 cm, 1 cm clear of the
threshold either way.

``main`` runs ``OnlineSlam`` of the JAX package with its defaults
(``max_features=256``, ``n_hyp=2048``, ``SlamParams()``) and
``global_loop_k=2`` over the first ``--frames`` frames in float64, then
one final ``optimize()``, and prints one JSON line: the status of every
frame (one letter each: ``F`` first, ``K`` keyframe, ``S`` small motion,
``X`` failed), the keyframe count, the lookback and global loop edges, and
the ATE RMSE of the keyframes against the path (Umeyama-aligned,
``chip_smoke._ate``'s formula). ``--path N`` takes the first ``--frames``
frames of the closed path of N frames (default: ``--frames``). ``--gsf
DIR`` feeds the frames decoded from the ``.gsf`` store DIR instead of the
rendered ones (u16 millimetre depth and integer intensity, what
``python -m graph_slam_tpu_torch slam --frames DIR`` reads), writing them
there first when DIR holds none (``write_gsf``). Importing this module
imports numpy and torch only: ``chip_smoke.py`` renders its frames with it
on a machine without JAX.
"""

import argparse
import json
import math
import time

import numpy as np
import torch

ROOM = ((-3.0, 3.0), (-1.5, 1.5), (-3.0, 3.0))   # x, y (down), z in metres
CELL = 0.03             # texture grid cell (tests/test_pipelines2.py:33)
RADIUS = 0.8            # the camera's circle
CENTER = (0.0, 0.0, 0.5)
STEP = 0.03             # metres a frame, before the path is closed
YAW_DEG = 30.0
YAW_PERIOD = 200        # frames a swing, before the path is closed
STATUS_LETTER = {"first": "F", "keyframe": "K", "small_motion": "S",
                 "failed": "X"}


def room_scene(K, device="cpu"):
    """(textures, rays) on ``device``: one 300 x 300 grid of uniform
    [0, 255) float32 texels a face (``render_wall_frame``'s grid), stacked
    (6, 300, 300) in the order -x, +x, -y, +y, -z, +z; and each pixel's
    ray (x, y, 1) in the camera frame, float64 (3, H * W)."""
    r = np.random.default_rng(0)
    tex = np.stack([r.uniform(0, 255, size=(300, 300)).astype(np.float32)
                    for _ in range(6)])
    uu, vv = np.meshgrid(np.arange(K.width, dtype=np.float64),
                         np.arange(K.height, dtype=np.float64))
    rays = np.stack([(uu - K.cx) / K.fx, (vv - K.cy) / K.fy,
                     np.ones_like(uu)]).reshape(3, -1)
    return (torch.as_tensor(tex, device=device),
            torch.as_tensor(rays, device=device))


def render_room_frame(K, R_wc, t_wc, tex, rays):
    """(intensity, depth) float32 (H, W) tensors of the room seen from the
    camera pose (R_wc, t_wc) (camera to world; x right, y down, z forward)
    on ``tex``'s device: each pixel's ray meets the first face of the box;
    depth is the hit's z in the camera frame. Elementwise IEEE operations
    one at a time, so the card and the CPU render the same bits."""
    R = [[float(v) for v in row] for row in R_wc]
    c = [float(v) for v in t_wc]
    d = torch.stack([R[i][0] * rays[0] + R[i][1] * rays[1]
                     + R[i][2] * rays[2] for i in range(3)])
    # the nearest of the three faces each ray meets (one an axis, the
    # bound in the direction it runs) is the hit
    hit_t = torch.full_like(d[0], torch.inf)
    face = torch.zeros(d.shape[1], dtype=torch.int64, device=d.device)
    for axis, (lo, hi) in enumerate(ROOM):
        pos = d[axis] > 0
        t = torch.where(pos, torch.full_like(d[axis], hi - c[axis]),
                        torch.full_like(d[axis], lo - c[axis])) / d[axis]
        t = torch.where(d[axis] == 0, torch.inf, t)
        closer = t < hit_t
        hit_t = torch.where(closer, t, hit_t)
        face = torch.where(closer, 2 * axis + pos.to(torch.int64), face)
    p = torch.tensor(c, dtype=d.dtype, device=d.device)[:, None] + hit_t * d
    # the two in-face coordinates: y, z on the x faces; x, z on the y
    # faces; x, y on the z faces
    axis = face // 2
    a = torch.where(axis == 0, p[1], p[0])
    b = torch.where(axis == 2, p[1], p[2])
    # render_wall_frame's bilinear lookup. The divisor is a tensor: torch
    # divides a CUDA tensor by a Python scalar as a product with its
    # reciprocal, which rounds otherwise than the CPU's division
    cell = torch.full_like(a, CELL)
    gx = (a + 4.0) / cell
    gy = (b + 4.0) / cell
    x0 = torch.clamp(gx.to(torch.int64), 0, 298)
    y0 = torch.clamp(gy.to(torch.int64), 0, 298)
    fx = (gx - x0).to(torch.float32)
    fy = (gy - y0).to(torch.float32)
    flat = tex.reshape(-1)
    base = face * (300 * 300)

    def at(y, x):
        return flat[base + y * 300 + x]

    img = ((1 - fx) * (1 - fy) * at(y0, x0)
           + fx * (1 - fy) * at(y0, x0 + 1)
           + (1 - fx) * fy * at(y0 + 1, x0)
           + fx * fy * at(y0 + 1, x0 + 1))
    return (img.reshape(K.height, K.width),
            hit_t.to(torch.float32).reshape(K.height, K.width))


def room_path(n):
    """(R_wc (n, 3, 3), t_wc (n, 3)) of the closed path of ``n`` frames:
    a whole number of laps of the circle and of yaw swings, the step and
    swing stretched to close them."""
    laps = max(1, round(n * STEP / (2 * math.pi * RADIUS)))
    swings = max(1, round(n / YAW_PERIOD))
    # libm's sine and cosine, one value at a time: numpy's vectorized
    # ones differ between builds and CPUs in the last bit
    phi = [2 * math.pi * laps * k / n for k in range(n)]
    t = np.asarray([[CENTER[0] + RADIUS * math.sin(a), CENTER[1],
                     CENTER[2] - RADIUS * math.cos(a)] for a in phi])
    yaw = [math.radians(YAW_DEG) * math.sin(2 * math.pi * swings * k / n)
           for k in range(n)]
    c = np.asarray([math.cos(y) for y in yaw])
    s = np.asarray([math.sin(y) for y in yaw])
    R = np.zeros((n, 3, 3))
    R[:, 0, 0], R[:, 0, 2] = c, s
    R[:, 1, 1] = 1.0
    R[:, 2, 0], R[:, 2, 2] = -s, c
    return R, t


def path_frames(K, n, device="cpu"):
    """Iterator over the ``n`` frames of ``room_path(n)``, rendered on
    ``device``."""
    tex, rays = room_scene(K, device)
    R, t = room_path(n)
    for k in range(n):
        yield render_room_frame(K, R[k], t[k], tex, rays)


def write_gsf(K, n, directory, path=None, device="cpu"):
    """The first ``n`` frames of ``room_path(path or n)``, rendered on
    ``device``, written as the ``.gsf`` store ``directory`` (frame k at
    ``{k:07d}.gsf``). Returns the seconds it took."""
    from graph_slam_tpu_torch.io import FrameStore

    t0 = time.perf_counter()
    store = FrameStore(directory)
    for k, (img, depth) in enumerate(path_frames(K, path or n, device)):
        if k == n:
            break
        store.save(k, img.cpu().numpy(), depth.cpu().numpy())
    return time.perf_counter() - t0


def ate(est_t, gt_t):
    """``chip_smoke._ate``'s translational ATE RMSE after a rigid Umeyama
    alignment."""
    mu_e, mu_g = est_t.mean(0), gt_t.mean(0)
    U, _, Vt = np.linalg.svd((gt_t - mu_g).T @ (est_t - mu_e) / len(est_t))
    W = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        W[2, 2] = -1.0
    R = U @ W @ Vt
    d = (R @ est_t.T).T + (mu_g - R @ mu_e) - gt_t
    return float(np.sqrt((d * d).sum(1).mean()))


def loop_edges(i, j, lookback):
    """(lookback, global) loop-closure counts among between rows (i, j):
    odometry rows join neighbours, lookback rows span up to ``lookback``
    keyframes, global rows more."""
    gap = np.asarray(j) - np.asarray(i)
    return int(((gap > 1) & (gap <= lookback)).sum()), int((gap > lookback)
                                                           .sum())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--features", choices=("harris", "sift"),
                    default="harris")
    ap.add_argument("--path", type=int, default=None,
                    help="frames of the closed path (default: --frames)")
    ap.add_argument("--gsf", help=".gsf store to read the frames from "
                                  "(written first when it holds none)")
    args = ap.parse_args()
    n_path = args.path or args.frames

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from graph_slam_tpu.config import RS435, SlamParams
    from graph_slam_tpu.pipelines import OnlineSlam

    if args.gsf:
        import glob
        import os

        from graph_slam_tpu.io import FrameStore

        if not glob.glob(os.path.join(args.gsf, "*.gsf")):
            write_gsf(RS435, args.frames, args.gsf, n_path)
        store = FrameStore(args.gsf)
        frames = (store(k) for k in range(args.frames))
    else:
        frames = ((img.numpy(), depth.numpy()) for img, depth in
                  path_frames(RS435, n_path))
    slam = OnlineSlam(cam=RS435, params=SlamParams(),
                      features=args.features, global_loop_k=2)
    statuses = []
    t0 = time.perf_counter()
    for k, (img, depth) in zip(range(args.frames), frames):
        statuses.append(STATUS_LETTER[slam.process_frame(
            img, depth, seq_id=k)])
    slam.optimize()
    wall = time.perf_counter() - t0
    _, t, _, seqs = slam.trajectory()
    _, gt_t = room_path(n_path)
    bt = slam.og.graph.between
    act = np.asarray(bt.active)
    lookback, global_ = loop_edges(np.asarray(bt.i)[act],
                                   np.asarray(bt.j)[act],
                                   slam.params.lookback_nodes)
    print(json.dumps({
        "frames": args.frames, "path": n_path, "gsf": bool(args.gsf),
        "features": args.features,
        "keyframes": slam.num_keyframes, "lookback_edges": lookback,
        "global_edges": global_, "ate_m": ate(np.asarray(t, np.float64),
                                              gt_t[np.asarray(seqs)]),
        "error": slam.error(), "statuses": "".join(statuses),
        "cpu_wall_s": wall, "jax": jax.__version__}))


if __name__ == "__main__":
    main()
