#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:

1. build   — compile ``graph_slam_tpu_torch/csrc/region_grow.cu`` with nvcc;
2. kernel  — the CUDA region grow against its plain torch version on the
             card, bit-equal, at the SR4000 and RealSense frame shapes and
             the main path's own shapes, with both times per call, the
             bound and the cluster size chosen; with every gate closed; and
             over every cluster size on planes whose rows it does not
             divide, widths off the 16-byte path, no plane and more planes
             than the card holds clusters, 0 to 200 steps;
3. golden  — ``run_pose_graph`` on ``tests/goldens/posegraph_vro.log`` in
             float64 against the pinned chi2 and trajectory;
4. sphere  — a sphere2500-class VRO log (~10,000 records, 1% of the loop
             closures failed) through ``run_pose_graph``, dense LM, float64;
5. pcg     — the reference bench's headline configuration: 200 GN
             iterations, PCG-10, float32, on ``make_sphere_graph(2500)``;
6. planes  — the plane-rescue propagation over rendered frames of the
             two-plane room: 50 SR4000 frames through ``propagate_planes``
             and 10 RealSense frames through ``propagate_plane``, every call
             launching the region-grow kernel.

Phases 3-6 are the main path, driven on the port's default device (the
card): the kernel's launch counter is set to 0 just before them and read
just after. Then the kernel is timed on the fill inputs of real frames
(phase ``frames``), and the script prints the kernel summary line and, last,
``{"ok": true, "device": {...}}``. Any failed check raises, so the
exit code is non-zero and no result line is printed. It needs one CUDA card
and the repository beside it; it imports no JAX.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens")
SPHERE_HEADLINE_DROP_REF = 256.5   # BENCH_r05.json, same graph (accuracy)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# the shapes timed: SR4000 and RealSense frames at P = 8, then the main
# path's own (propagate_planes at P = 2, propagate_plane at P = 1)
GROW_SHAPES = [(8, 144, 176), (8, 480, 640), (2, 144, 176), (1, 480, 640)]
MAIN_PATH_SHAPE = (1, 480, 640)


def _require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _cuda_time_us(fn, reps):
    """Mean microseconds per call of ``fn`` on the current stream."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) * 1e3 / reps


def _cuda_graph_time_us(fn, reps):
    """Mean microseconds per call with ``reps`` calls captured once into a
    CUDA graph and replayed, so no host work sits between the launches: the
    card's own time for a call, launch gap included."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return _cuda_time_us(graph.replay, 3) / reps


def _grow_inputs(P, h, w, seed):
    """Random flood-fill inputs above the percolation threshold, so the
    fill keeps spreading for all 64 steps."""
    import numpy as np
    import torch

    r = np.random.default_rng(seed)
    member = r.random((P, h, w)) < 0.7
    seeds = np.zeros((P, h, w), bool)
    for p in range(P):
        y, x = r.integers(0, h), r.integers(0, w)
        seeds[p, max(0, y - 2):y + 2, max(0, x - 2):x + 2] = True
    gates = [r.random((h, w)) < 0.95 for _ in range(4)]
    return [torch.as_tensor(a, device="cuda") for a in (seeds, member, *gates)]


def _grow_module():
    import graph_slam_tpu_torch.planes.region_grow  # noqa: F401

    return sys.modules["graph_slam_tpu_torch.planes.region_grow"]


def grow_bound_us(P, h, w):
    """The least time the card could take: seed and member read once, the
    output written once (P*h*w bytes each), four gates read once (h*w bytes
    each), over the memory rate. Bytes bound it; the bit operations are far
    below any operation bound."""
    return (3 * P * h * w + 4 * h * w) / HBM_BYTES_PER_S * 1e6


def grow_steps_run(args, steps):
    """Steps the kernel runs on these inputs: up to and including the first
    step that changes nothing, at most ``steps``."""
    import torch

    from graph_slam_tpu_torch.planes.region_grow import region_grow_torch

    seed, member, *gates = [a != 0 for a in args]
    mask = seed & member
    for step in range(steps):
        grown = region_grow_torch(mask, member, *gates, steps=1)
        if torch.equal(grown, mask):
            return step + 1
        mask = grown
    return steps


def grow_row(args, steps, plain_reps=5, reps=200):
    """Hold the kernel bit-equal to the plain version on ``args`` and time
    both; one row of the ``kernel`` line. ``us`` is what a caller pays a
    call (CUDA events around ``reps`` wrapper calls in a row, paced by the
    wrapper's host work where that is slower than the card), ``device_us``
    the card's own time (the launches replayed from a CUDA graph), which is
    the kernel's ``ms`` on the ``kernels`` line, ``us`` its ``call_ms``."""
    import torch

    from graph_slam_tpu_torch.planes.region_grow import (region_grow,
                                                         region_grow_torch)

    grow = _grow_module()
    P, h, w = args[0].shape
    out = region_grow(*args, steps=steps)
    ref = region_grow_torch(*args, steps=steps)
    torch.cuda.synchronize()
    err = int((out != ref).sum())
    _require(err == 0, f"kernel != plain version at {(P, h, w)}: "
                       f"{err} pixels differ")
    C = grow.cluster_size(h, w)
    K = grow.sub_steps(h, w, C)
    return {"shape": [P, h, w], "cluster": C, "steps_between_exchanges": K,
            "threads": grow.block_threads(h, w, C, K),
            "smem_bytes": grow.smem_bytes(h, w, C, K),
            "us": _cuda_time_us(lambda: region_grow(*args, steps=steps), reps),
            "device_us": _cuda_graph_time_us(
                lambda: region_grow(*args, steps=steps), 50),
            "plain_us": _cuda_time_us(
                lambda: region_grow_torch(*args, steps=steps), plain_reps),
            "bound_us": grow_bound_us(P, h, w), "bound_by": "bytes",
            "steps_run": grow_steps_run(args, steps),
            "grown_px": int(out.sum()), "mismatches": err}


def _band_cases():
    """Every cluster size on shapes that exercise the bands: rows the
    cluster does not divide, fewer rows than blocks, widths off the 16-byte
    path, no plane, more planes than the card holds clusters at once."""
    import torch

    from graph_slam_tpu_torch.planes.region_grow import (region_grow,
                                                         region_grow_torch)

    grow = _grow_module()
    cases = 0
    for k, (P, h, w) in enumerate([(2, 13, 176), (2, 5, 20), (2, 3, 33),
                                   (2, 21, 97), (3, 61, 97), (2, 7, 1),
                                   (0, 16, 16), (300, 144, 176)]):
        args = _grow_inputs(max(P, 1), h, w, seed=40 + k)
        args[:2] = [a[:P] for a in args[:2]]
        for steps in (0, 1, 64, 200):
            ref = region_grow_torch(*args, steps=steps)
            outs = [region_grow(*args, steps=steps)] + [
                grow._launch(args[0], args[1], args[2:], steps, cluster=C)
                for C in grow.CLUSTER_SIZES]
            torch.cuda.synchronize()
            for out in outs:
                _require(out.shape == ref.shape and bool(torch.equal(out, ref)),
                         f"kernel != plain version at {(P, h, w)}, "
                         f"{steps} steps")
                cases += 1
    return cases


def phase_kernel():
    import torch

    from graph_slam_tpu_torch.planes.region_grow import (region_grow,
                                                         region_grow_torch)

    rows = [grow_row(_grow_inputs(P, h, w, seed=10 + k), 64)
            for k, (P, h, w) in enumerate(GROW_SHAPES)]

    # every gate closed: one step that changes nothing, then the exit; what
    # is left is the launch, bytes to bits and back
    args = _grow_inputs(8, 480, 640, seed=11)
    closed_args = args[:2] + [torch.zeros_like(g) for g in args[2:]]
    closed = grow_row(closed_args, 64)
    _require(closed["steps_run"] == 1, "closed gates ran more than one step")

    # no wraparound: with every gate closed nothing leaves the seed column
    h, w = 24, 40
    seed = torch.zeros(h, w, dtype=torch.bool, device="cuda")
    seed[:, 0] = True
    member = torch.ones(h, w, dtype=torch.bool, device="cuda")
    shut = [torch.zeros(h, w, dtype=torch.bool, device="cuda")] * 4
    out = region_grow(seed, member, *shut, steps=8)
    ref = region_grow_torch(seed, member, *shut, steps=8)
    torch.cuda.synchronize()
    _require(bool(torch.equal(out, ref)) and not bool(out[:, 1:].any()),
             "no-wraparound case")
    _emit({"phase": "kernel", "steps": 64, "max_abs_err": 0,
           "shapes": rows, "closed_gates": closed, "no_wraparound": True,
           "band_cases_bit_equal": _band_cases()})
    return {tuple(r["shape"]): r for r in rows}


def phase_golden():
    import numpy as np

    from graph_slam_tpu_torch.io import read_vro_log
    from graph_slam_tpu_torch.pipelines import run_pose_graph, trajectory_arrays

    pins = json.load(open(os.path.join(GOLDEN, "chi2.json")))
    res = run_pose_graph(read_vro_log(os.path.join(GOLDEN,
                                                   "posegraph_vro.log")),
                         bucket=64)
    rel0 = abs(res.error0 - pins["vro_error0"]) / pins["vro_error0"]
    rel = abs(res.error - pins["vro_error"]) / pins["vro_error"]
    golden = np.loadtxt(os.path.join(GOLDEN, "posegraph_traj.log"))
    _, t, q, seq = trajectory_arrays(res.values, res.seq_ids)
    t_err = float(np.abs(t - golden[:, 1:4]).max())
    q_err = float(np.abs(q[:, [1, 2, 3, 0]] - golden[:, 4:8]).max())
    _emit({"phase": "golden", "error0": res.error0, "error": res.error,
           "rel_err0": rel0, "rel_err": rel, "traj_t_max_err": t_err,
           "traj_q_max_err": q_err, "iterations": res.iterations})
    _require(rel0 <= 1e-6 and rel <= 1e-6, "golden chi2 outside 1e-6")
    # the CPU test's gate; the card's scatter-adds are atomics, but their
    # order changes sums at ~1e-16 relative, far inside it
    _require(t_err <= 1e-9 and q_err <= 1e-9, "golden trajectory beyond 1e-9")
    _require(bool((seq == golden[:, 8]).all()), "golden sequence ids")


def _sphere_vro_log(n_poses=2500, seed=0, fail_frac=0.01):
    """Odometry plus short-range loop closures over ``sphere_ground_truth``,
    drawn as ``make_sphere_graph`` draws them, with ``fail_frac`` of the
    loop closures carrying the failed-edge sentinel."""
    import numpy as np
    import torch

    from graph_slam_tpu_torch.core import se3
    from graph_slam_tpu_torch.datasets import sphere_ground_truth
    from graph_slam_tpu_torch.datasets.synthetic import _so3_exp
    from graph_slam_tpu_torch.io import VROLog
    from graph_slam_tpu_torch.io.vro_log import FAILED_INFO_SENTINEL

    r = np.random.default_rng(seed)
    Rs, ts = sphere_ground_truth(n_poses)
    n_extra = 3 * n_poses
    cand_i = r.integers(0, n_poses - 1, size=3 * n_extra)
    cand_j = cand_i + r.integers(2, 50, size=3 * n_extra)
    keep = cand_j < n_poses
    ii = np.concatenate([np.arange(n_poses - 1), cand_i[keep][:n_extra]])
    jj = np.concatenate([np.arange(1, n_poses), cand_j[keep][:n_extra]])
    Rij = np.einsum("kji,kjl->kil", Rs[ii], Rs[jj])
    tij = np.einsum("kji,kj->ki", Rs[ii], ts[jj] - ts[ii])
    noise_R = np.stack([_so3_exp(w) for w in
                        r.normal(size=(len(ii), 3)) * 0.02 * 0.3])
    Rij = Rij @ noise_R
    tij = tij + r.normal(size=(len(ii), 3)) * 0.02
    xi = se3.logmap(se3.Pose(torch.as_tensor(Rij), torch.as_tensor(tij)))
    info = np.tile(np.diag([100.0, 100.0, 100.0, 25.0, 25.0, 25.0]),
                   (len(ii), 1, 1))
    loops = np.arange(n_poses - 1, len(ii))
    failed = r.choice(loops, size=int(fail_frac * len(loops)), replace=False)
    info[failed] = np.eye(6) * FAILED_INFO_SENTINEL
    log = VROLog(jj, ii, xi.numpy(), info)
    return log, (Rs, ts), len(failed)


def phase_sphere():
    import numpy as np
    import torch

    from graph_slam_tpu_torch.io import read_vro_log, write_vro_log
    from graph_slam_tpu_torch.pipelines import run_pose_graph

    log, (Rs, ts), n_failed = _sphere_vro_log()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sphere2500_vro.log")
        write_vro_log(path, log)
        log = read_vro_log(path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_pose_graph(log, bucket=256)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = len(res.seq_ids)
    est = res.values.pose_t[:n].cpu().numpy()
    gt = (ts[res.seq_ids] - ts[0]) @ Rs[0]      # gauge: pose 0 at identity
    ate = float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))
    drop = res.error0 / res.error
    _emit({"phase": "sphere", "records": len(log), "failed_records": n_failed,
           "poses": n, "tangent_dim": int(res.values.pose_t.shape[0]) * 6,
           "error0": res.error0, "error": res.error, "chi2_drop_x": drop,
           "iterations": res.iterations, "wall_s": wall, "ate_rmse_m": ate,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    _require(drop >= 100.0, f"sphere2500 chi2 dropped only {drop:.1f}x")


def phase_pcg():
    import torch

    from graph_slam_tpu_torch.datasets import make_sphere_graph
    from graph_slam_tpu_torch.graph import gn_optimize, total_error

    graph, values, _ = make_sphere_graph(2500, 4.0, seed=0,
                                         dtype=torch.float32, bucket=256)
    e0 = float(total_error(graph, values))
    gn_optimize(graph, values, iterations=2, solver="pcg", damping=1e-3,
                pcg_iters=10)                                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gn_optimize(graph, values, iterations=200, solver="pcg",
                      damping=1e-3, pcg_iters=10)
    err = float(res.error)
    wall = time.perf_counter() - t0
    drop = e0 / err
    _emit({"phase": "pcg", "dtype": "float32", "iterations": 200,
           "pcg_iters": 10, "error0": e0, "error": err, "chi2_drop_x": drop,
           "reference_chi2_drop_x": SPHERE_HEADLINE_DROP_REF,
           "wall_s": wall, "gn_iters_per_s": 200 / wall})
    _require(drop >= 100.0, f"PCG-10 headline chi2 dropped only {drop:.1f}x")


def _camera_path(n):
    """World-from-camera poses: a few cm and up to ~2 degrees per frame,
    pitched ~8 degrees down so the floor stays in view."""
    import numpy as np

    from graph_slam_tpu_torch.datasets.synthetic import _so3_exp

    poses = []
    for f in range(n):
        w = np.array([-0.14 + 0.04 * np.sin(0.15 * f), 0.2 * np.sin(0.17 * f),
                      0.05 * np.sin(0.2 * f)])
        t = np.array([0.4 * np.sin(0.1 * f), 0.05 * np.sin(0.2 * f),
                      0.3 * np.sin(0.08 * f)])
        poses.append((_so3_exp(w), t))
    return poses


def _plane_run(K, n_frames, batched, dtype):
    """Carry the two room planes over ``n_frames`` rendered frames on
    ground-truth relative poses; returns (calls, worst angle deg, worst
    distance m, seconds in propagation)."""
    import numpy as np
    import torch

    from graph_slam_tpu_torch.core import se3
    from graph_slam_tpu_torch.datasets.synthetic import _render_plane_frame
    from graph_slam_tpu_torch.planes import (oriented_plane, plane_tangent_cov,
                                             propagate_plane, propagate_planes)

    scene = [(np.array([0.0, 0.0, 1.0, -4.0]), 150.0),
             (np.array([0.0, 1.0, 0.0, -0.8]), 80.0)]
    dev = "cuda"
    poses = _camera_path(n_frames)

    def gt_planes(f):
        R, t = poses[f]
        out = []
        for plane_w, _ in scene:
            p = np.concatenate([R.T @ plane_w[:3], [plane_w[3] + plane_w[:3] @ t]])
            out.append(p * (1.0 if p[3] >= 0 else -1.0))   # fit's sign: d >= 0
        return np.stack(out)

    def frame(f):
        inten, depth = _render_plane_frame(K, *poses[f], scene, noise=0.002,
                                           seed=100 + f)
        return (torch.as_tensor(inten, device=dev),
                torch.as_tensor(depth, device=dev).to(dtype))

    def sn_sd(planes, cov):
        B = oriented_plane.basis(planes[:, :3])
        return B @ cov[:, :2, :2] @ B.transpose(-1, -2), cov[:, 2, 2]

    inten, depth = frame(0)
    masks = torch.stack([(inten == v) & (depth > 0) for _, v in scene])
    planes = torch.as_tensor(gt_planes(0), device=dev, dtype=dtype)
    hh, ww = depth.shape
    vv, uu = torch.meshgrid(torch.arange(hh, device=dev, dtype=dtype),
                            torch.arange(ww, device=dev, dtype=dtype),
                            indexing="ij")
    pts = torch.stack([(uu - K.cx) * depth / K.fx, (vv - K.cy) * depth / K.fy,
                       depth], -1).reshape(-1, 3)
    cov = plane_tangent_cov(planes, pts, masks.reshape(2, -1))
    S_n, S_d = sn_sd(planes, cov)
    counts = masks.sum(dim=(1, 2))
    S_t = torch.eye(3, device=dev, dtype=dtype) * 1e-4

    calls, worst_deg, worst_m, busy = 0, 0.0, 0.0, 0.0
    for f in range(1, n_frames):
        (Ri, ti), (Rj, tj) = poses[f - 1], poses[f]
        T = se3.Pose(torch.as_tensor(Ri.T @ Rj, device=dev, dtype=dtype),
                     torch.as_tensor(Ri.T @ (tj - ti), device=dev, dtype=dtype))
        inten, depth = frame(f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if batched:
            res = propagate_planes(K, planes, S_n, S_d, masks, counts, T, S_t,
                                   inten, depth)
            calls += 1
        else:
            parts = [propagate_plane(K, planes[k], S_n[k], S_d[k], masks[k],
                                     counts[k], T, S_t, inten, depth)
                     for k in range(2)]
            calls += 2
            res = type(parts[0])(*(torch.stack(x) for x in zip(*parts)))
        torch.cuda.synchronize()
        busy += time.perf_counter() - t0
        _require(bool(res.ok.all()), f"frame {f}: a plane was not kept "
                                     f"(counts {res.count.tolist()})")
        gt = gt_planes(f)
        est = res.plane.double().cpu().numpy()
        cosang = np.clip(np.abs(np.sum(est[:, :3] * gt[:, :3], 1)), 0, 1)
        worst_deg = max(worst_deg, float(np.degrees(np.arccos(cosang)).max()))
        worst_m = max(worst_m, float(np.abs(np.abs(est[:, 3]) - gt[:, 3]).max()))
        planes, masks, counts = res.plane, res.mask, res.count
        S_n, S_d = sn_sd(planes, res.cov)
    _require(worst_deg <= 1.0 and worst_m <= 0.01,
             f"refit planes off ground truth: {worst_deg:.3f} deg, "
             f"{worst_m * 100:.2f} cm")
    return calls, worst_deg, worst_m, busy


def phase_planes():
    import torch

    from graph_slam_tpu_torch.config import RS435, SR4000
    from graph_slam_tpu_torch.planes.region_grow import region_grow

    before = region_grow.launches
    out = {"phase": "planes", "dtype": "float32"}
    for name, K, n, batched in (("sr4000", SR4000, 50, True),
                                ("rs435", RS435, 10, False)):
        calls, deg, m, busy = _plane_run(K, n, batched, torch.float32)
        out[name] = {"frames": n, "calls": calls, "worst_angle_deg": deg,
                     "worst_dist_m": m, "ms_per_call": 1e3 * busy / calls,
                     "entry": "propagate_planes" if batched
                     else "propagate_plane"}
    launched = region_grow.launches - before
    expected = out["sr4000"]["calls"] + out["rs435"]["calls"]
    out["kernel_launches"] = launched
    _emit(out)
    _require(launched == expected, f"region_grow launched {launched} times "
                                   f"for {expected} propagation calls")


def real_frame_grow_inputs(n_frames=4):
    """The fill's inputs on real frames: the arguments of the last
    ``region_grow`` call of a short propagation run of each camera."""
    import torch

    from graph_slam_tpu_torch.config import RS435, SR4000
    from graph_slam_tpu_torch.planes import propagation

    calls = {}
    real = propagation.region_grow

    def recorder(*args, steps=64):
        calls[tuple(args[0].shape)] = (list(args), steps)
        return real(*args, steps=steps)

    propagation.region_grow = recorder
    try:
        _plane_run(SR4000, n_frames, True, torch.float32)
        _plane_run(RS435, n_frames, False, torch.float32)
    finally:
        propagation.region_grow = real
    return calls


def phase_frames():
    """The kernel on the seed, member and gates of rendered frames, where
    the warped seed covers most of each plane and the fill exits early."""
    rows = [grow_row(args, steps)
            for _, (args, steps) in sorted(real_frame_grow_inputs().items())]
    _emit({"phase": "frames", "shapes": rows})
    _require(len(rows) == 2, "expected one fill shape per camera")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from graph_slam_tpu_torch.kernels import build
    from graph_slam_tpu_torch.planes.region_grow import region_grow

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)

    t0 = time.perf_counter()
    built = build.ensure_built("region_grow")
    build.library("region_grow")
    _emit({"phase": "build",
           "library": os.path.relpath(build.library_path("region_grow"), ROOT),
           "built_now": built, "seconds": time.perf_counter() - t0,
           "torch": torch.__version__, "cuda": torch.version.cuda})

    timing = phase_kernel()[MAIN_PATH_SHAPE]

    # the main path: every launch from here to the end is counted
    region_grow.launches = 0
    phase_golden()
    phase_sphere()
    phase_pcg()
    phase_planes()
    launches = region_grow.launches
    _require(launches > 0, "the main path never launched region_grow")
    phase_frames()

    _emit({"kernels": [{
        "name": "region_grow", "route": "cuda",
        "source": "graph_slam_tpu_torch/csrc/region_grow.cu",
        "replaces": "graph_slam_tpu/planes/pallas_grow.py:78",
        "launches": launches, "max_abs_err": timing["mismatches"],
        "shape": timing["shape"], "ms": timing["device_us"] / 1e3,
        "call_ms": timing["us"] / 1e3,
        "plain_ms": timing["plain_us"] / 1e3,
        "bound_ms": timing["bound_us"] / 1e3, "bound_by": timing["bound_by"],
        "library_ms": None}]})
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
