#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py [--vio-frames N] [--rescue-frames N]
                          [--online-frames N]

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
6. posegraph — the rest of the pose-graph backend: (a) ``run_g2o_file`` on
             the g2o golden and the golden VRO log through
             ``backend="g2o"`` and ``"gtsam"``, against their pins; (b) a
             sphere2500-size graph (2,500 poses, 2,499 odometry edges,
             2,500 loop closures, 5% of them corrupted) written with
             ``write_g2o`` and read back through ``run_g2o_file(
             loop_gate="pcm", init="chordal")``: every planted outlier
             rejected, >= 95% of the true loops kept, chi2 and ATE within
             1% of the solve without the planted rows, with PCM's device
             and host-clique times, chordal and LM times and peak memory;
             (c) ``gnc_optimize(kind="tls", solver="pcg")`` on that graph
             without PCM (outliers rejected, chi2 within 1e-4 of the
             outlier-free optimum, ATE within 1% after an LM polish over
             its inliers), then ``run_pose_graph(loop_gate="pcm",
             init="chordal", robust="gnc-tls")`` on a 500-pose sphere VRO
             log with 5% of its loops corrupted; (d) the JAX bench's
             ``chordal``, ``gather_pcg``, ``banded_direct`` and ``banded``
             configurations in float32, each to chi2 < 0.1 e0; (e) its
             ``multigraph`` fleet, 64 graphs of 250 poses, against each
             graph's own ``gn_optimize``; (f) card against CPU in float64:
             PCM's decisions, chordal poses, ``lm_optimize_g2o``'s history
             and ``marginalize_poses`` on a 500-pose sphere. It launches no
             hand-written kernel.
7. ba      — bundle adjustment: (a) ``tests/goldens/ba_fixture.json`` in
             float64, e0 and the optimum of LM, the square-root and the
             normal-equations Schur within 1e-6 of their pins; (b) the JAX
             bench's ``ba_schur`` (100 poses x 10,000 landmarks, float32):
             20 GN iterations of PCG-25 to chi2 < 0.1 e0, and a float64
             copy through the normal-equations Schur; (c) its ``ba_sqrt``
             (the same graph at bucket 64, 8 square-root steps); (d) its
             ``ba_sqrt_100k``, the slice at full width: 320 poses x 100,000
             landmarks, float32, 4 square-root steps with ``step_clip=1``,
             exact and bf16x3 assembly, each to a finite chi2 < 0.1 e0,
             with build, table, cold and warm step times and peak memory;
             (e) card against CPU in float64 on a 12-pose, 400-landmark
             graph: both Schur forms, LM and the pose marginals within
             1e-9; (f) ``two_frame_ba`` and ``run_ba_imu`` (float64 and
             float32) on the card. It launches no hand-written kernel.
8. planes  — the plane-rescue propagation over rendered frames of the
             two-plane room: 50 SR4000 frames through ``propagate_planes``
             and 10 RealSense frames through ``propagate_plane``, every call
             launching the region-grow kernel.

9. vio    — the VIO scan replay, ``run_vio(engine="scan",
             plane_mode="off")``, on the plane-aided VIO scenario of 2,000
             frames (``--vio-frames``): 200 Hz VN100 IMU, 20 samples a
             frame, every 20th VO edge failed and carried by the IMU; a
             cold and a warm replay in float64 (ATE within 1e-9 of the
             path: the scenario is exact), one in float32, the final
             dense batch LM over every frame, from the replay and from
             perturbed values; the fixed-lag step on a perturbed window of
             the replay's arena, a 200-frame replay and its LM from
             perturbed values, each on the card against the CPU; host
             syncs per record.
10. rescue — the flagship, ``run_vio(engine="scan", plane_mode="rescue")``
             with SR4000 frames of the two-plane room rendered on demand,
             on the same scenario at 2,000 frames (``--rescue-frames``)
             with every 100th VO edge failed and rescued by planes, the JAX
             bench's ``vio_planes_2k`` configuration: a cold and a warm
             replay in float64 (ATE within 2% of the path; at a length
             pinned in ``RESCUE_JAX``, the JAX package's rescue steps,
             plane factors and landmarks there, and at 2,000 frames its
             float64 ATE within 1%), one in float32, the
             final dense LM over the rescue graph and its plane columns
             from the replay and from perturbed values, a 200-frame rescue
             replay on the card against the CPU, host syncs per rescue,
             the rescue's sub-phase times, how many predictions ran the
             fresh extraction, and a plane-free replay of the same log.
11. online — the online engine, ``run_vio(engine="online")`` (the default
             of ``run_vio``), on the ``rescue`` phase's scenario at 2,000
             frames (``--online-frames``): (a) the flagship rescue at the
             JAX bench's ``compare_online`` configuration, cold and warm
             (rescues, plane factors and landmarks as in the ``rescue``
             phase, ATE within 2% of the path and within 1% of the JAX
             package's online figure pinned below), beside a plane-free
             online replay of the same log; (b) its first 200 frames on
             the card against the CPU; (c) the default ``VioConfig()`` on
             its first 300 frames (full-arena dense updates, final LM);
             (d) ``plane_mode="always"`` on its first 200 frames; (e) the
             incremental optimizer against a batch solve on a 1,000-pose
             corridor, with flat per-update time; (f) a checkpoint of
             (a)'s graph saved and loaded bit-equal; host syncs per frame
             and per rescue.
12. frontend — the visual frontend and ``OnlineSlam`` at 640 x 480
             (RS435) on ``frontend_reference_ate.py``'s rendered box room
             (frames rendered on the card, held bit-equal to the same
             renderer on the CPU), ``global_loop_k=2``, every other setting
             the default: (a) Harris over 1,000 frames and (b) SIFT over
             300, each held to the JAX package's run of the same frames
             (statuses on >= 99% of frames, keyframes within 1%, ATE
             within 2%), (a) with a global loop edge; (c) the
             first 64 frames of (a) on the card and on the CPU (statuses
             equal, trajectories within 1e-5 m), their per-phase times
             with the card synchronised at each phase's ends, host syncs
             a frame, each extractor alone; frames/s and peak memory.
13. cli    — the command line, ``graph_slam_tpu_torch.cli.main(argv)`` (what
             ``python -m graph_slam_tpu_torch`` calls) in this process:
             (a) ``slam --camera rs435 --global-loop-k 2`` over a .gsf store
             of (12a)'s first 300 frames (rendered on the card), against
             ``OnlineSlam`` fed the decoded frames (statuses equal,
             trajectory within 1e-6 m) and the JAX package's run of them
             (pinned below: statuses on >= 99% of frames, keyframes within
             1%, ATE within 2%), then ``evaluate`` against the path (the
             same ATE); (b) ``tsdf --n 512 --size 8`` over (a): the mesh on
             the room's faces, the device extraction bit-equal to the plain
             numpy one, ms an integration beside its bound, peak memory,
             and 10 frames at 128^3 card against CPU (flipped voxels
             counted); (c) ``map --voxel 0.02``, ``filter`` and ``mesh`` of
             its PCD (read back equal to the cloud written) and ``video
             --every 50``; (d) ``serve --port 0`` in a thread, (a)'s frames
             streamed over loopback (statuses as (a)'s, trajectory within
             1e-6 m of an in-process session with its settings; frames/s);
             (e) ``vio --frames --plane-mode rescue`` on the ``online``
             phase's scenario written to files (VRO log, VN100 log, times,
             SR4000 .gsf frames) at its configuration, held to the rescue's
             gates; (f) one ``python -m graph_slam_tpu_torch posegraph``
             subprocess against the golden chi2, ``presets`` and the native
             IO runtime.
14. sharded — multi-device solving (``graph_slam_tpu_torch.parallel``,
             one process a rank over ``torch.distributed``): (a)
             ``dryrun_multichip(4, backend="gloo")``, four ranks sharing
             the card: sphere2500 PCG-50 (float32), the 16 x 480
             landmark-sharded square-root BA, the 12-frame VIO window, an
             8 x 60-pose fleet and a dense-H step, each to the reference's
             convergence bar, printed beside ``MULTICHIP_r05.json``'s chi2;
             (b) one NCCL rank: sphere2500 PCG-50 within 5e-2 of
             ``gn_optimize``; (c) float64, four gloo ranks on the card
             against four on the CPU: the 48-pose dense GN and the
             121-landmark square-root BA within 1e-9, every card rank
             bit-equal to rank 0; (d) ``g2o --sharded 1 --iters 15``
             through ``cli.main`` against the golden pin (1e-3); (e) the
             dry run over NCCL on distinct cards, only where the machine
             has two or more. Wall times, ms per all_reduce and bytes
             reduced per GN iteration are reported; gloo on one card
             reduces through host memory and measures no interconnect.
15. profile — the replays of phases 9, 10 and 11 on their scenarios'
             first 101 frames (timed in those phases; the rescue's and the
             online engine's each end with a rescue), one GN iteration of
             (7d) and (12c)'s 64 frames again under ``torch.profiler``:
             launches per record (per iteration, per frame), device busy
             share, top device ops. It runs after every timed run, as a
             profiler session slows the process's later launches.

Phases 3-15 are the main path, driven on the port's default device (the
card): the kernel's launch counter is set to 0 just before phases 3-8 and
read just after (phases 6 and 7 on their own are held to 0 launches),
again around phase 9, which launches no hand-written kernel, around phase
10 and around phase 11, where each rescue whose previous frame had planes
launches it once, around phase 12 (held to 0: the frontend's work is
torch operations, cuDNN, cuBLAS and cuSOLVER), around phase 13 (its
``vio`` run's predictions, each one launch), around phase 14 (held to
0: the sharded solvers' work is torch operations and collectives; it runs
in the ranks that ``launch`` spawns, each of which sends back its own
count, and the phase's count is the parent's plus the ranks'), and
around each replay that phase 15 profiles (each held to its predictions, at least one in the
rescue's and the online engine's). The
region-grow kernel is timed on the fill inputs of real frames (phase
``frames``) and of a rescue, and the script
prints the kernel summary line and, last, ``{"ok": true, "device":
{...}}``. Any failed check raises, so the
exit code is non-zero and no result line is printed. It needs one CUDA card
and the repository beside it; it imports no JAX.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens")
SPHERE_HEADLINE_DROP_REF = 256.5   # BENCH_r05.json, same graph (accuracy)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# the shapes timed: SR4000 and RealSense frames at P = 8, then the main
# path's own (propagate_planes at P = 2, propagate_plane at P = 1)
GROW_SHAPES = [(8, 144, 176), (8, 480, 640), (2, 144, 176), (1, 480, 640)]
MAIN_PATH_SHAPE = (1, 480, 640)
# frames of each replay the profile phase profiles: the profiler's
# post-processing costs ~0.25 ms a kernel (~6 min for a 2,000-frame online
# replay's 1.4 M kernels), so it profiles a prefix of each scenario: the
# shortest that holds a rescue, whose last record is the failed one into
# frame 100 (``fail_every=100``)
PROFILE_FRAMES = 101
_T0 = time.perf_counter()


def _require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def _emit(obj):
    """One JSON line; a phase's line carries the seconds since the script
    started."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - _T0)
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
    return {"error0": e0, "error": err, "wall_s": wall}


# -- the pose-graph backend: g2o, PCM, chordal, GNC, solvers, fleet ---------

PG_POSES = 2500            # make_sphere_graph poses of the robust solve
PG_OUTLIERS = 0.05         # share of its loop closures corrupted
PG_PIPELINE_POSES = 500    # _sphere_vro_log poses through the three options
PG_HELD = 1e-9             # card vs CPU, float64
PG_FLEET = (64, 250)       # bench.py's multigraph: graphs, poses each
PG_MARG_POSES = 500        # the sphere of lm_optimize_g2o and marginalization
G2O_BACKEND_PIN = 0.1673486302270372     # tests/test_g2o_schedule.py:91
GTSAM_BACKEND_PIN = 5.613857156515794    # tests/test_g2o_schedule.py:88


class _Timed:
    """Wraps module functions, for the length of a ``with`` block, so that
    each call's seconds (the card synchronised before and after) are summed
    under a key; the last call's arguments and result are kept too."""

    def __init__(self, *targets):
        self.targets = targets        # (module, function name, key)
        self.s, self.calls, self.last = {}, {}, {}
        self._saved = []

    def __enter__(self):
        import torch

        for module, name, key in self.targets:
            fn = getattr(module, name)

            def timed(*args, _fn=fn, _key=key, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*args, **kw)
                torch.cuda.synchronize()
                self.s[_key] = self.s.get(_key, 0.0) + time.perf_counter() - t0
                self.calls[_key] = self.calls.get(_key, 0) + 1
                self.last[_key] = (args, out)
                return out

            self._saved.append((module, name, fn))
            setattr(module, name, timed)
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self._saved):
            setattr(module, name, fn)
        self._saved.clear()


def _corrupt_loops(graph, frac, seed=7, scale=3.0):
    """``tests/test_pcm.py``'s ``_corrupt`` on the port's tables: ``frac``
    of the active loop closures (rows with j - i > 1) get a random rotation
    and a translation drawn at ``scale``. Returns (graph, bad rows, the
    other loop rows)."""
    import numpy as np
    import torch

    from graph_slam_tpu_torch.datasets.synthetic import _so3_exp

    bt = graph.between
    act, i, j = (x.cpu().numpy() for x in (bt.active, bt.i, bt.j))
    idx = np.flatnonzero(act)
    loops = idx[(j[idx] - i[idx]) > 1]
    rng = np.random.default_rng(seed)
    bad = rng.choice(loops, size=int(round(frac * len(loops))), replace=False)
    R, t = bt.meas_R.cpu().numpy().copy(), bt.meas_t.cpu().numpy().copy()
    for e in bad:
        R[e] = _so3_exp(rng.normal(size=3))
        t[e] = rng.normal(size=3) * scale
    dev, dt = bt.meas_R.device, bt.meas_R.dtype
    return graph._replace(between=bt._replace(
        meas_R=torch.as_tensor(R, dtype=dt, device=dev),
        meas_t=torch.as_tensor(t, dtype=dt, device=dev))), bad, \
        np.setdiff1d(loops, bad)


def _write_graph_g2o(path, graph, values):
    """The graph's active between rows and its live poses as a g2o file."""
    import numpy as np

    from graph_slam_tpu_torch.core import so3
    from graph_slam_tpu_torch.io import write_g2o

    n = int(values.num_poses)
    bt = graph.between
    rows = np.flatnonzero(bt.active.cpu().numpy())
    S = bt.sqrt_info.cpu().numpy()[rows]
    q = so3.matrix_to_quat(bt.meas_R[rows]).cpu().numpy()
    edges = zip(bt.i.cpu().numpy()[rows], bt.j.cpu().numpy()[rows],
                bt.meas_t.cpu().numpy()[rows], q,
                np.einsum("fki,fkj->fij", S, S))
    write_g2o(path, values.pose_t[:n].cpu().numpy(),
              so3.matrix_to_quat(values.pose_R[:n]).cpu().numpy(), edges)


def _rms(est_t, gt_t):
    import numpy as np

    return float(np.sqrt(np.mean(np.sum((est_t - gt_t) ** 2, axis=1))))


def _pg_goldens(out):
    """(a) the g2o golden and the golden VRO log through both backends."""
    from graph_slam_tpu_torch.graph import LMParams
    from graph_slam_tpu_torch.io import read_vro_log
    from graph_slam_tpu_torch.pipelines import run_g2o_file, run_pose_graph

    pins = json.load(open(os.path.join(GOLDEN, "chi2.json")))
    res = run_g2o_file(os.path.join(GOLDEN, "sphere200_noisy.g2o"),
                       LMParams(relative_error_tol=1e-12,
                                absolute_error_tol=1e-12), bucket=64)
    log = read_vro_log(os.path.join(GOLDEN, "posegraph_vro.log"))
    g2o = run_pose_graph(log, bucket=64, backend="g2o")
    gtsam = run_pose_graph(log, bucket=64, backend="gtsam")
    out.update({"g2o_error0": res.error0, "g2o_error": res.error,
           "g2o_rel_err0": abs(res.error0 - pins["g2o_error0"])
           / pins["g2o_error0"],
           "g2o_rel_err": abs(res.error - pins["g2o_error"])
           / pins["g2o_error"],
           "vro_g2o_backend_error": g2o.error,
           "vro_g2o_backend_rel_err": abs(g2o.error - G2O_BACKEND_PIN)
           / G2O_BACKEND_PIN,
           "vro_gtsam_backend_error": gtsam.error,
           "vro_gtsam_backend_abs_err": abs(gtsam.error - GTSAM_BACKEND_PIN)})
    _require(out["g2o_rel_err0"] <= 1e-6 and out["g2o_rel_err"] <= 1e-6,
             "g2o golden chi2 outside 1e-6")
    _require(out["vro_g2o_backend_rel_err"] <= 1e-4,
             "backend='g2o' golden chi2 outside 1e-4")
    _require(out["vro_gtsam_backend_abs_err"] <= 1e-6,
             "backend='gtsam' golden chi2 outside 1e-6")


def _pg_robust(tmp, rec):
    """(b) PCM + chordal + LM through ``run_g2o_file`` on a sphere2500-size
    graph with planted outliers, against the outlier-free solve; its
    numbers go in ``rec``; returns what (c) and (f) reuse."""
    import torch

    from graph_slam_tpu_torch.datasets import make_sphere_graph
    from graph_slam_tpu_torch.graph import init, pcm
    from graph_slam_tpu_torch.pipelines import posegraph, run_g2o_file

    graph, values, (Rs, ts) = make_sphere_graph(
        PG_POSES, edges_per_pose=2.0, seed=0, dtype=torch.float64)
    graph_bad, bad, good = _corrupt_loops(graph, PG_OUTLIERS)
    # the outlier-free solve: the same graph with the planted rows removed
    bt = graph_bad.between
    keep = torch.ones_like(bt.active)
    keep[torch.as_tensor(bad, device=keep.device)] = False
    inlier_graph = graph_bad._replace(between=bt._replace(
        active=bt.active & keep))
    clean_path = os.path.join(tmp, "sphere2500_inliers.g2o")
    bad_path = os.path.join(tmp, "sphere2500_outliers.g2o")
    _write_graph_g2o(clean_path, inlier_graph, values)
    _write_graph_g2o(bad_path, graph_bad, values)
    timed = _Timed((pcm, "_loop_arrays", "pcm_upload"),
                   (pcm, "_unary_m2", "pcm_unary"),
                   (pcm, "_pairwise_m2", "pcm_pairwise"),
                   (pcm, "max_clique", "pcm_clique"),
                   (posegraph, "chordal_initialize", "chordal"),
                   (init, "project_so3", "chordal_svd"),
                   (posegraph, "lm_optimize", "lm"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timed:
        res = run_g2o_file(bad_path, loop_gate="pcm", init="chordal")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the first batched SVD of a process also pays cuSOLVER's set-up: the
    # chordal step again, warm, on the gated graph
    with _Timed((init, "project_so3", "chordal_svd_warm")) as warm:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        init.chordal_initialize(res.graph, values)
        torch.cuda.synchronize()
        chordal_warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    clean = run_g2o_file(clean_path, init="chordal")
    clean_s = time.perf_counter() - t0

    n = PG_POSES
    active = res.graph.between.active.cpu().numpy()
    kept = float(active[good].mean())
    ate = _rms(res.values.pose_t[:n].cpu().numpy(), ts)
    ate_clean = _rms(clean.values.pose_t[:n].cpu().numpy(), ts)
    ms = {k: v * 1e3 for k, v in timed.s.items()}
    out = {"poses": n, "loops_L": len(good) + len(bad),
           "outliers": len(bad), "outliers_rejected": int((~active[bad]).sum()),
           "true_loops_kept": kept, "error0": res.error0, "error": res.error,
           "error_outlier_free": clean.error,
           "chi2_rel_to_outlier_free": abs(res.error - clean.error)
           / clean.error,
           "ate_m": ate, "ate_outlier_free_m": ate_clean,
           "ate_rel_to_outlier_free": abs(ate - ate_clean) / ate_clean,
           "pcm_device_ms": ms["pcm_unary"] + ms["pcm_pairwise"],
           "pcm_unary_ms": ms["pcm_unary"],
           "pcm_pairwise_ms": ms["pcm_pairwise"],
           "pcm_upload_ms": ms["pcm_upload"],
           "pcm_host_clique_ms": ms["pcm_clique"],
           "chordal_ms": ms["chordal"], "chordal_svd_ms": ms["chordal_svd"],
           "chordal_warm_ms": chordal_warm_s * 1e3,
           "chordal_svd_warm_ms": warm.s["chordal_svd_warm"] * 1e3,
           "lm_iterations": res.iterations, "lm_s": ms["lm"] / 1e3,
           "wall_s": wall, "outlier_free_wall_s": clean_s,
           "peak_mem_gb": peak}
    rec.update(out)
    _require(out["outliers_rejected"] == len(bad),
             f"PCM kept {len(bad) - out['outliers_rejected']} planted "
             "outliers")
    _require(kept >= 0.95, f"PCM kept only {kept:.3f} of the true loops")
    _require(out["chi2_rel_to_outlier_free"] <= 0.01
             and out["ate_rel_to_outlier_free"] <= 0.01,
             "the gated solve is not within 1% of the outlier-free one")
    (lp, odo_cov), m2_card = timed.last["pcm_pairwise"]
    m2o_card = timed.last["pcm_unary"][1]
    return dict(graph_bad=graph_bad, inlier_graph=inlier_graph,
                values=values, bad=bad, good=good, ts=ts, ate_clean=ate_clean,
                error_clean=clean.error, gated=res.graph, lp=lp,
                     odo_cov=odo_cov, m2_card=m2_card, m2o_card=m2o_card)


def _pg_gnc(b, out):
    """(c) GNC-TLS at full width on (b)'s corrupted graph without PCM, then
    the three options together on a VRO log with corrupted loops; the
    numbers go in ``out``."""
    import torch

    from graph_slam_tpu_torch.graph import (gn_optimize, gnc_optimize,
                                            lm_optimize)

    g = b["graph_bad"]
    cand = (g.between.j - g.between.i) != 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gnc_optimize(g, b["values"], candidates=cand, kind="tls",
                       solver="pcg", damping=1e-3)
    inliers = res.inliers.cpu().numpy()
    gnc_s = time.perf_counter() - t0
    # the anneal's fixed budget (25 x 3 GN steps of PCG-50) leaves the
    # sphere's low-frequency modes unconverged: chi2 sits within ~1e-5 of
    # the optimum while ATE can differ by tens of percent, and the
    # inlier graph alone under the same budget does the same. So ATE is
    # held after an LM polish over GNC's inliers, and chi2 as it is.
    bt = g.between
    polish = lm_optimize(g._replace(between=bt._replace(
        active=bt.active & res.inliers)), res.values)
    budget = gn_optimize(b["inlier_graph"], b["values"], iterations=75,
                         solver="pcg", damping=1e-3, pcg_iters=50)
    ate = _rms(res.values.pose_t[:PG_POSES].cpu().numpy(), b["ts"])
    ate_polish = _rms(polish.values.pose_t[:PG_POSES].cpu().numpy(), b["ts"])
    out.update({
        "gnc_s": gnc_s, "gnc_outliers_rejected":
        int((~inliers[b["bad"]]).sum()),
        "gnc_true_loops_rejected": int((~inliers[b["good"]]).sum()),
        "gnc_error": float(res.error), "gnc_error_raw": float(res.error_raw),
        "gnc_chi2_rel_to_outlier_free": abs(float(res.error)
                                            - b["error_clean"])
        / b["error_clean"],
        "gnc_ate_m": ate, "same_budget_inlier_ate_m": _rms(
            budget.values.pose_t[:PG_POSES].cpu().numpy(), b["ts"]),
        "polished_ate_m": ate_polish, "polish_lm_iterations":
        int(polish.iterations),
        "polished_ate_rel_to_outlier_free": abs(ate_polish - b["ate_clean"])
        / b["ate_clean"]})
    _require(out["gnc_outliers_rejected"] == len(b["bad"]),
             "GNC kept a planted outlier")
    _require(out["gnc_chi2_rel_to_outlier_free"] <= 1e-4,
             "GNC's chi2 is not within 1e-4 of the outlier-free optimum")
    _require(out["polished_ate_rel_to_outlier_free"] <= 0.01,
             "GNC's polished ATE is not within 1% of the outlier-free solve")
    _pg_pipeline(out)


def _pg_pipeline(out):
    """``run_pose_graph(loop_gate="pcm", init="chordal", robust="gnc-tls")``
    on ``_sphere_vro_log`` with 5% of its valid loop closures corrupted,
    against a plain LM on the clean log."""
    import numpy as np
    import torch

    from graph_slam_tpu_torch.config import SlamParams
    from graph_slam_tpu_torch.core import se3
    from graph_slam_tpu_torch.datasets.synthetic import _so3_exp
    from graph_slam_tpu_torch.io import VROLog
    from graph_slam_tpu_torch.pipelines import run_pose_graph

    n = PG_PIPELINE_POSES
    log, (Rs, ts), _ = _sphere_vro_log(n)
    valid = log.valid
    loops = np.flatnonzero(valid & (np.arange(len(log)) >= n - 1))
    rng = np.random.default_rng(11)
    bad = rng.choice(loops, size=int(round(PG_OUTLIERS * len(loops))),
                     replace=False)
    xi = log.xi.copy()
    for k in bad:
        T = se3.Pose(torch.as_tensor(_so3_exp(rng.normal(size=3))),
                     torch.as_tensor(rng.normal(size=3) * 3.0))
        xi[k] = se3.logmap(T).numpy()
    bad_log = VROLog(log.id_to, log.id_from, xi, log.info)
    # a failed loop record writes no row: record k is row k - (failed
    # records before it); this log fails loops only
    row = np.arange(len(log)) - np.concatenate([[0], np.cumsum(~valid)[:-1]])
    good = np.setdiff1d(loops, bad)
    t0 = time.perf_counter()
    res = run_pose_graph(bad_log, SlamParams(robust="gnc-tls"),
                         loop_gate="pcm", init="chordal")
    wall = time.perf_counter() - t0
    # the outlier-free solve: the same log without the corrupted records
    keep = np.ones(len(log), bool)
    keep[bad] = False
    clean = run_pose_graph(VROLog(log.id_to[keep], log.id_from[keep],
                                  log.xi[keep], log.info[keep]))
    gt = (ts[res.seq_ids] - ts[0]) @ Rs[0]      # gauge: pose 0 at identity
    ate = _rms(res.values.pose_t[:len(res.seq_ids)].cpu().numpy(), gt)
    ate_clean = _rms(clean.values.pose_t[:len(clean.seq_ids)].cpu().numpy(),
                     gt)
    active = res.graph.between.active.cpu().numpy()
    out.update({"pipeline_poses": n, "pipeline_loops": len(loops),
           "pipeline_outliers": len(bad),
           "pipeline_outliers_rejected": int((~active[row[bad]]).sum()),
           "pipeline_true_loops_kept": float(active[row[good]].mean()),
           "pipeline_ate_m": ate, "pipeline_ate_outlier_free_m": ate_clean,
           "pipeline_ate_rel": abs(ate - ate_clean) / ate_clean,
           "pipeline_s": wall})
    _require(out["pipeline_outliers_rejected"] == len(bad),
             "the pcm + chordal + gnc-tls pipeline kept a planted outlier")
    _require(out["pipeline_true_loops_kept"] >= 0.95,
             "the pipeline kept under 95% of the true loops")
    _require(out["pipeline_ate_rel"] <= 0.01,
             "the pipeline's ATE is not within 1% of the outlier-free solve")


def _pg_bench_configs(pcg, out):
    """(d) ``bench.py``'s chordal, gather_pcg, banded_direct and banded
    configurations on ``make_sphere_graph(2500)`` in float32, each to the
    bench's bar chi2 < 0.1 e0. ``pcg`` is the ``pcg`` phase's 200-GN run on
    the same graph."""
    import torch

    from graph_slam_tpu_torch.datasets import make_sphere_graph
    from graph_slam_tpu_torch.graph import (band_halfwidth,
                                            banded_direct_gn_optimize,
                                            banded_gn_optimize,
                                            build_incidence,
                                            chordal_initialize, gn_optimize,
                                            total_error)

    graph, values, _ = make_sphere_graph(2500, 4.0, seed=0,
                                         dtype=torch.float32, bucket=256)
    e0 = float(total_error(graph, values))
    out["error0"] = e0

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        err = float(fn())
        return err, time.perf_counter() - t0

    def chordal_path():
        v1 = chordal_initialize(graph, values)
        return gn_optimize(graph, v1, iterations=5, solver="pcg",
                           damping=1e-3, pcg_iters=10).error

    chordal_path()                                          # warm-up
    err, wall = timed(chordal_path)
    out["chordal"] = {"error": err, "wall_s": wall,
                      "gn200_wall_s": pcg["wall_s"],
                      "speedup_vs_gn200": pcg["wall_s"] / wall,
                      "chi2_rel_to_gn200": (err - pcg["error"]) / pcg["error"]}

    t0 = time.perf_counter()
    inc = build_incidence(graph, values)
    build_s = time.perf_counter() - t0
    gn_optimize(graph, values, iterations=2, solver="pcg", damping=1e-3,
                pcg_iters=10, inc=inc)                      # warm-up
    err, wall = timed(lambda: gn_optimize(
        graph, values, iterations=200, solver="pcg", damping=1e-3,
        pcg_iters=10, inc=inc).error)
    out["gather_pcg"] = {"error": err, "wall_s": wall,
                         "gn_iters_per_s": 200 / wall,
                         "incidence_build_s": build_s,
                         "incidence_k": int(inc.idx.shape[1]),
                         "chi2_rel_to_scatter": abs(err - pcg["error"])
                         / pcg["error"]}
    _require(out["gather_pcg"]["chi2_rel_to_scatter"] <= 1e-3,
             "the gather path's chi2 is not within 1e-3 of the scatter's")

    W = band_halfwidth(graph)
    banded_direct_gn_optimize(graph, values, iterations=1, band_w=W,
                              damping=1e-6)                 # warm-up
    err, wall = timed(lambda: banded_direct_gn_optimize(
        graph, values, iterations=50, band_w=W, damping=1e-6)[1])
    conv = None
    for k in (2, 4, 8):
        if float(banded_direct_gn_optimize(graph, values, iterations=k,
                                           band_w=W, damping=1e-6)[1]) \
                < 0.1 * e0:
            conv = k
            break
    out["banded_direct"] = {"error": err, "wall_s": wall,
                            "gn_iters_per_s": 50 / wall, "band_halfwidth": W,
                            "superblock": max(W, 32),
                            "iters_to_0.1x_chi2": conv}

    banded_gn_optimize(graph, values, iterations=2, band_w=W, damping=1e-3,
                       pcg_iters=10)                        # warm-up
    err, wall = timed(lambda: banded_gn_optimize(
        graph, values, iterations=200, band_w=W, damping=1e-3,
        pcg_iters=10)[1])
    out["banded"] = {"error": err, "wall_s": wall,
                     "gn_iters_per_s": 200 / wall}
    for name in ("chordal", "gather_pcg", "banded_direct", "banded"):
        _require(out[name]["error"] < 0.1 * e0,
                 f"{name}: chi2 {out[name]['error']:.4g} not below 0.1 e0 "
                 f"= {0.1 * e0:.4g}")


def _pg_fleet(out):
    """(e) ``bench.py``'s multigraph: 64 graphs of 250 poses, PCG-10, 50
    iterations, float32, against the single-graph rate."""
    import torch

    from graph_slam_tpu_torch.datasets import make_sphere_graph
    from graph_slam_tpu_torch.graph import (gn_optimize, gn_optimize_many,
                                            stack_pytrees, total_error)

    b, n = PG_FLEET
    pairs = [make_sphere_graph(n, 4.0, seed=s, dtype=torch.float32,
                               bucket=64)[:2] for s in range(b)]
    graphs = stack_pytrees([g for g, _ in pairs])
    arenas = stack_pytrees([v for _, v in pairs])
    kw = dict(solver="pcg", damping=1e-3, pcg_iters=10)
    gn_optimize_many(graphs, arenas, iterations=2, **kw)    # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gn_optimize_many(graphs, arenas, iterations=50, **kw)
    errs = res.error.cpu().numpy()
    fleet_s = time.perf_counter() - t0
    gn_optimize(*pairs[0], iterations=2, **kw)              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    float(gn_optimize(*pairs[0], iterations=50, **kw).error)
    single_s = time.perf_counter() - t0
    e0s = [float(total_error(g, v)) for g, v in pairs]
    worst = max(float(e / e0) for e, e0 in zip(errs, e0s))
    held = {}
    for k in (0, b // 3, 2 * b // 3, b - 1):
        single = float(gn_optimize(*pairs[k], iterations=50, **kw).error)
        held[k] = abs(float(errs[k]) - single) / single
    out.update({"graphs": b, "poses": n, "iterations": 50,
                "fleet_s": fleet_s,
           "fleet_graph_gn_iters_per_s": b * 50 / fleet_s,
           "single_graph_gn_iters_per_s": 50 / single_s,
           "fleet_vs_single": (b * 50 / fleet_s) / (50 / single_s),
           "worst_chi2_over_e0": worst,
           "own_gn_rel_chi2": {str(k): v for k, v in held.items()}})
    _require(worst < 0.1, f"a fleet graph reached only {worst:.3g} e0")
    _require(max(held.values()) <= 1e-4,
             "a fleet graph is not within 1e-4 of its own gn_optimize")


def _pg_card_vs_cpu(b, out):
    """(f) float64 card against CPU: (b)'s PCM decisions, chordal poses,
    ``lm_optimize_g2o``'s history on a 500-pose sphere, and
    ``marginalize_poses`` of every other interior pose of it, optimized."""
    import numpy as np
    import torch

    from graph_slam_tpu_torch.datasets import make_sphere_graph
    from graph_slam_tpu_torch.graph import (chordal_initialize, gn_optimize,
                                            lm_optimize_g2o,
                                            marginalize_poses, pcm,
                                            total_error)
    from graph_slam_tpu_torch.utils import chi2_quantile

    # PCM: the host clique and mask are numpy over the device's m2, so the
    # card's decisions equal the CPU's exactly when every unary and pair
    # test falls the same way on both
    lp_cpu = _to(b["lp"], "cpu")
    t0 = time.perf_counter()
    m2o = pcm._unary_m2(lp_cpu, b["odo_cov"]).numpy()
    m2 = pcm._pairwise_m2(lp_cpu, b["odo_cov"]).numpy()
    cpu_s = time.perf_counter() - t0
    m2o_card = b["m2o_card"].cpu().numpy()
    m2_card = b["m2_card"].cpu().numpy()
    thr = chi2_quantile(6, 1e-4)
    out["pcm_unary_bit_equal"] = bool(((m2o <= thr) == (m2o_card <= thr))
                                      .all())
    adj, adj_card = (np.maximum(x, x.T) <= thr for x in (m2, m2_card))
    out["pcm_pairs_bit_equal"] = bool((adj == adj_card).all())
    # reported, not gated: an outlier pair's m2 reaches 1e5 through a log
    # near pi, and card and CPU round it apart by ~1e-9 relative
    scale = np.maximum(np.abs(m2), 1.0)
    out["pcm_m2_max_rel_err"] = float((np.abs(m2_card - m2) / scale).max())
    out["pcm_cpu_s"] = cpu_s
    _require(out["pcm_unary_bit_equal"] and out["pcm_pairs_bit_equal"],
             "PCM's decisions differ between the card and the CPU")

    g, v = b["gated"], b["values"]
    ch = chordal_initialize(g, v)
    ch_cpu = chordal_initialize(_to(g, "cpu"), _to(v, "cpu"))
    out["chordal_max_abs_err"] = max(
        float((getattr(ch, f).cpu() - getattr(ch_cpu, f)).abs().max())
        for f in ("pose_R", "pose_t"))

    g5, v5, _ = make_sphere_graph(PG_MARG_POSES, 4.0, seed=0,
                                  dtype=torch.float64)
    h = lm_optimize_g2o(g5, v5).history.cpu().numpy()
    h_cpu = lm_optimize_g2o(_to(g5, "cpu"), _to(v5, "cpu")).history.numpy()
    out["lm_g2o_history_max_rel_err"] = float(np.max(np.abs(h - h_cpu)
                                                     / h_cpu))

    full = gn_optimize(g5, v5, iterations=10, damping=1e-9).values
    drop = np.arange(1, PG_MARG_POSES - 1, 2)
    t0 = time.perf_counter()
    m_card = marginalize_poses(g5, full, drop)
    marg_s = time.perf_counter() - t0
    m_cpu = marginalize_poses(_to(g5, "cpu"), _to(full, "cpu"), drop)
    worst = 0.0
    for name in ("prior_pose", "between"):
        for a, c in zip(getattr(m_card[0], name), getattr(m_cpu[0], name)):
            a, c = a.cpu(), c.cpu()
            if a.is_floating_point():
                worst = max(worst, float(((a - c).abs() / c.abs().clamp(
                    min=1.0)).max()) if a.numel() else 0.0)
            else:
                _require(torch.equal(a, c), f"marginalized {name} indices "
                         "differ between the card and the CPU")
    e_card = float(total_error(*m_card[:2]))
    e_cpu = float(total_error(*m_cpu[:2]))
    out.update({"marginalized_poses": len(drop),
                "marginalize_s": marg_s,
                "marginalized_between_rows":
                    int(m_card[0].between.active.sum()),
                "marginalize_table_max_rel_err": worst,
                "marginalize_chi2_rel_err": abs(e_card - e_cpu) / e_cpu})
    for key in ("chordal_max_abs_err",
                "lm_g2o_history_max_rel_err", "marginalize_table_max_rel_err",
                "marginalize_chi2_rel_err"):
        _require(out[key] <= PG_HELD, f"{key} = {out[key]:.3g} above "
                 f"{PG_HELD}")


def phase_posegraph(pcg):
    """The pose-graph backend on the card: (a) goldens, (b) a sphere2500-size
    robust solve through ``run_g2o_file``, (c) GNC, (d) the bench's solver
    configurations, (e) the fleet, (f) card against CPU. The phase's line
    is printed whether or not a check fails, with what was measured."""
    import torch

    from graph_slam_tpu_torch.planes.region_grow import region_grow

    t_phase = time.perf_counter()
    out = {"phase": "posegraph"}
    try:
        _pg_goldens(out.setdefault("goldens", {}))
        with tempfile.TemporaryDirectory() as tmp:
            b = _pg_robust(tmp, out.setdefault("robust", {}))
        _pg_gnc(b, out.setdefault("gnc", {}))
        _pg_card_vs_cpu(b, out.setdefault("card_vs_cpu", {}))
        del b
        torch.cuda.empty_cache()
        _pg_bench_configs(pcg, out.setdefault("bench_configs", {}))
        _pg_fleet(out.setdefault("fleet", {}))
    finally:
        out["seconds"] = time.perf_counter() - t_phase
        _emit(out)
    _require(region_grow.launches == 0,
             "the pose-graph phase launched region_grow")


# -- bundle adjustment: goldens, the bench's BA configurations, card vs CPU --

BA_100K = (320, 100_000)   # bench.py's ba_sqrt_100k: poses, landmarks
BA_HELD = 1e-9             # card vs CPU, float64, relative
BA_JAX_100K_CHI2 = 145748.234375   # BENCH_r05.json, the bf16x3 run (accuracy)


def _ba_fixture(dtype):
    """``tests/goldens/ba_fixture.json`` built as ``tests/test_goldens.py``
    builds it: Cal3DS2 projections through a mounted camera, point priors,
    a pose prior."""
    import numpy as np

    from graph_slam_tpu_torch.graph import GraphBuilder

    fx = json.load(open(os.path.join(GOLDEN, "ba_fixture.json")))
    b = GraphBuilder()
    for R, t in fx["init_poses"]:
        b.add_pose((np.asarray(R), np.asarray(t)))
    pR, pt = fx["prior_pose"]
    b.add_prior_pose(0, (np.asarray(pR), np.asarray(pt)),
                     sigmas=np.full(6, 1e-6))
    for q, p in enumerate(fx["init_points"]):
        b.add_point(np.asarray(p))
        b.add_prior_point(q, np.asarray(p), sigma=fx["point_prior_sigma"])
    body = (np.asarray(fx["body_R"]), np.asarray(fx["body_t"]))
    for k, q, uv in fx["obs"]:
        b.add_projection_factor(k, q, np.asarray(uv), fx["cal"],
                                body_pose=body, sigma=1.0)
    return b.build(bucket=8, dtype=dtype)


def _ba_golden(out):
    """(a) the golden BA fixture in float64: e0 and the optimum of LM, the
    square-root and the normal-equations Schur against the pins."""
    import torch

    from graph_slam_tpu_torch.graph import (LMParams, ba_gn_optimize,
                                            ba_gn_optimize_sqrt, lm_optimize,
                                            total_error)

    pins = json.load(open(os.path.join(GOLDEN, "chi2.json")))
    graph, values = _ba_fixture(torch.float64)
    e0 = float(total_error(graph, values))
    lm = lm_optimize(graph, values, LMParams(relative_error_tol=1e-14,
                                             absolute_error_tol=1e-14))
    sq = ba_gn_optimize_sqrt(graph, values, iterations=25, damping=1e-6)[1]
    ne = ba_gn_optimize(graph, values, iterations=25, damping=1e-6)[1]
    out.update({"error0": e0, "error_lm": float(lm.error),
                "error_sqrt": float(sq), "error_schur": float(ne),
                "lm_iterations": lm.iterations})
    rels = {"rel_err0": abs(e0 - pins["ba_error0"]) / pins["ba_error0"]}
    for k in ("lm", "sqrt", "schur"):
        rels[f"rel_err_{k}"] = abs(out[f"error_{k}"] - pins["ba_error"]) \
            / pins["ba_error"]
    out.update(rels)
    _require(max(rels.values()) <= 1e-6,
             f"BA golden outside 1e-6 of its pins: {rels}")


def _timed_s(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _ba_schur(out):
    """(b) the bench's ``ba_schur``: 100 poses x 10,000 landmarks, float32,
    bucket 256, 20 GN iterations of PCG-25 to chi2 < 0.1 e0; and a float64
    copy through the normal-equations Schur (the bench's x64 variant)."""
    import torch

    from graph_slam_tpu_torch.datasets import make_ba_graph
    from graph_slam_tpu_torch.graph import (ba_gn_optimize, gn_optimize,
                                            total_error)

    graph, values, _ = make_ba_graph(100, 10000, obs_per_point=4, seed=0,
                                     dtype=torch.float32, bucket=256)
    e0 = float(total_error(graph, values))
    gn_optimize(graph, values, iterations=1, solver="pcg", damping=1e-2,
                pcg_iters=25)                               # warm-up
    res, wall = _timed_s(lambda: gn_optimize(
        graph, values, iterations=20, solver="pcg", damping=1e-2,
        pcg_iters=25))
    out["pcg"] = {"error0": e0, "error": float(res.error),
                  "ms_per_iter": wall / 20 * 1e3,
                  "projections": int(graph.projection.active.sum())}
    _require(float(res.error) < 0.1 * e0,
             f"ba_schur PCG: chi2 {float(res.error):.4g} not below 0.1 e0")

    g64, v64 = _cast(graph, torch.float64), _cast(values, torch.float64)
    torch.cuda.reset_peak_memory_stats()
    (_, err), wall = _timed_s(lambda: ba_gn_optimize(
        g64, v64, iterations=20, damping=1e-3))
    out["schur_f64"] = {"error": float(err), "ms_per_iter": wall / 20 * 1e3,
                        "U_bytes": 6 * 256 * 3 * v64.point.shape[0] * 8,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    _require(float(err) < 0.1 * e0,
             f"ba_schur f64 Schur: chi2 {float(err):.4g} not below 0.1 e0")


def _cast(x, dtype):
    """A factor graph or arena with its floating tensors cast to ``dtype``."""
    if isinstance(x, tuple):
        return type(x)(*(_cast(f, dtype) for f in x))
    return x.to(dtype) if x.is_floating_point() else x


def _ba_sqrt_run(n_poses, n_points, bucket, iters, chunk, damping,
                 step_clip=None, precision=None):
    """The bench's ``bench_ba_sqrt`` on the port: build, tables, a cold and
    a warm call of ``iters`` square-root steps (the card synchronised
    around each), chi2 and peak memory. Returns (the numbers, the job that
    the profile phase replays)."""
    import torch

    from graph_slam_tpu_torch.datasets import make_ba_graph
    from graph_slam_tpu_torch.graph import (build_point_obs,
                                            landmark_classes, layout_of,
                                            sqrt_schur_gn_step, total_error)

    torch.cuda.reset_peak_memory_stats()
    (graph, values, _), build_s = _timed_s(lambda: make_ba_graph(
        n_poses, n_points, obs_per_point=4, seed=0, dtype=torch.float32,
        bucket=bucket))
    lay = layout_of(values)
    tabs, obs_s = _timed_s(lambda: [
        torch.as_tensor(t, device=values.pose_t.device)
        for t in build_point_obs(graph, lay.point_cap)])
    e0 = float(total_error(graph, values))

    step = dict(damping=damping, chunk=chunk, step_clip=step_clip,
                assembly_precision=precision,
                classes=landmark_classes(graph, lay, tabs[0], tabs[1]))

    def solve():
        v = values
        for _ in range(iters):
            v = sqrt_schur_gn_step(graph, v, *tabs, **step)
        return v

    _, cold = _timed_s(solve)
    v, warm = _timed_s(solve)
    err = float(total_error(graph, v))
    out = {"poses": int(values.num_poses),
           "landmarks": int(values.num_points), "Dp": lay.point_off,
           "point_cap": lay.point_cap, "K": int(tabs[0].shape[1]),
           "projections": int(graph.projection.active.sum()),
           "iterations": iters, "chunk": chunk, "damping": damping,
           "step_clip": step_clip, "assembly_precision": precision,
           "build_s": build_s, "build_point_obs_s": obs_s,
           "ms_per_iter_cold": cold / iters * 1e3,
           "ms_per_iter_warm": warm / iters * 1e3,
           "error0": e0, "error": err,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    _require(err == err and err < 0.1 * e0,
             f"sqrt-Schur {n_poses}x{n_points}: chi2 {err:.4g} not finite "
             f"and below 0.1 e0 = {0.1 * e0:.4g}")
    return out, (graph, values, tabs, step, warm / iters)


def _rel_max(a, b):
    a, b = a.cpu().double(), b.cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


def _ba_card_vs_cpu(out):
    """(e) float64 card against CPU on ``make_ba_graph(12, 400, seed 3)``:
    the square-root and normal-equations Schur, LM and the pose
    marginals."""
    import torch

    from graph_slam_tpu_torch.datasets import make_ba_graph
    from graph_slam_tpu_torch.graph import (ba_gn_optimize,
                                            ba_gn_optimize_sqrt, lm_optimize,
                                            pose_marginals_all)

    g, v, _ = make_ba_graph(12, 400, obs_per_point=4, seed=3,
                            dtype=torch.float64, bucket=64)
    gc, vc = _to(g, "cpu"), _to(v, "cpu")
    runs = {
        "sqrt": lambda g, v: ba_gn_optimize_sqrt(g, v, iterations=8,
                                                 damping=1e-4, chunk=128),
        "schur": lambda g, v: ba_gn_optimize(g, v, iterations=8,
                                             damping=1e-4),
        "lm": lambda g, v: (lambda r: (r.values, r.error))(
            lm_optimize(g, v)),
    }
    worst = 0.0
    for name, fn in runs.items():
        (va, ea), (vb, eb) = fn(g, v), fn(gc, vc)
        d = {"chi2": abs(float(ea) - float(eb)) / float(eb),
             "pose_t": _rel_max(va.pose_t, vb.pose_t),
             "pose_R": _rel_max(va.pose_R, vb.pose_R),
             "point": _rel_max(va.point, vb.point)}
        out[name] = dict(d, error=float(ea))
        worst = max(worst, *d.values())
    opt = runs["lm"](gc, vc)[0]
    m = _rel_max(pose_marginals_all(g, _to(opt, v.pose_t.device), 12),
                 pose_marginals_all(gc, opt, 12))
    out["pose_marginals_all"] = m
    out["max_rel_err"] = max(worst, m)
    _require(out["max_rel_err"] <= BA_HELD,
             f"BA card vs CPU: {out['max_rel_err']:.3g} above {BA_HELD}")


def _ba_pipelines(out):
    """(f) ``two_frame_ba`` on ``tests/test_ba.py``'s scene and
    ``run_ba_imu`` on six frames of the VIO scenario with 25 landmarks,
    float64 (normal-equations Schur) and float32 (square-root Schur)."""
    import numpy as np
    import torch

    from graph_slam_tpu_torch.config import SR4000
    from graph_slam_tpu_torch.core import se3
    from graph_slam_tpu_torch.datasets import make_vio_plane_scenario
    from graph_slam_tpu_torch.pipelines import BaImuConfig, run_ba_imu
    from graph_slam_tpu_torch.vision import (Cal3DS2, project_point,
                                             two_frame_ba)

    K = Cal3DS2.make(SR4000.fx, SR4000.fy, SR4000.cx, SR4000.cy, SR4000.k1,
                     SR4000.k2)

    def project(local):
        return project_point(K, torch.as_tensor(local, device=K.fx.device)
                             ).cpu().numpy()

    r = np.random.default_rng(0)
    pts = np.stack([r.uniform(-1, 1, 40), r.uniform(-0.8, 0.8, 40),
                    r.uniform(1.5, 3.5, 40)], axis=1)
    xi = torch.tensor([0.03, -0.05, 0.04, 0.12, -0.06, 0.08],
                      dtype=torch.float64)
    T = se3.expmap(xi)
    Rg, tg = T.R.numpy(), T.t.numpy()
    pts_j = (pts - tg) @ Rg
    T0 = se3.retract(T, torch.full((6,), 0.02, dtype=torch.float64))
    (R, t), info, err = two_frame_ba(pts, project(pts), project(pts_j),
                                     SR4000, (T0.R.numpy(), T0.t.numpy()))
    out["two_frame"] = {"R_err": float(np.abs(R - Rg).max()),
                        "t_err": float(np.abs(t - tg).max()),
                        "info_min_eig": float(np.linalg.eigvalsh(info).min()),
                        "error": err}
    _require(out["two_frame"]["R_err"] <= 1e-5
             and out["two_frame"]["t_err"] <= 1e-4
             and out["two_frame"]["info_min_eig"] > 0,
             f"two_frame_ba: {out['two_frame']}")

    _, times, stream, params, _, _, (Rs, ts) = make_vio_plane_scenario(
        n_frames=6, render=False, return_gt=True)
    W = np.stack([r.uniform(-2, 2, 25), r.uniform(-2, 2, 25),
                  r.uniform(2.5, 5, 25)], axis=1)
    frames = []
    for f in range(6):
        local = (W - ts[f]) @ Rs[f]
        frames.append({"uv": project(local), "pts3": local})
    cfg = BaImuConfig(use_imu=True, solver="schur", schur_iters=8, bucket=16)
    for name, dt in (("ba_imu_f64", torch.float64),
                     ("ba_imu_f32", torch.float32)):
        res, wall = _timed_s(lambda: run_ba_imu(
            frames, lambda i, j: [(k, k) for k in range(25)], times, stream,
            params, SR4000, cfg=cfg, dtype=dt))
        pos = float(np.abs(res.values.pose_t[:6].cpu().double().numpy()
                           - ts).max())
        out[name] = {"error0": res.error0, "error": res.error,
                     "max_position_err_m": pos, "wall_s": wall,
                     "landmarks": res.n_landmarks,
                     "imu_factors": res.n_imu_factors}
        _require(res.error < 1e-3 and pos <= 2e-2
                 and res.n_landmarks == 25 and res.n_imu_factors == 5,
                 f"run_ba_imu {name}: {out[name]}")


def phase_ba():
    """Bundle adjustment on the card: (a) the golden fixture, (b) the
    bench's ``ba_schur``, (c) its ``ba_sqrt``, (d) ``ba_sqrt_100k`` and its
    bf16x3 variant, (e) card against CPU, (f) two-frame BA and BA+IMU.
    Returns the job the profile phase replays ((d)'s graph). The phase's
    line is printed whether or not a check fails, with what was
    measured."""
    import torch

    t_phase = time.perf_counter()
    out = {"phase": "ba"}
    job = None
    try:
        _ba_golden(out.setdefault("a_golden", {}))
        _ba_schur(out.setdefault("b_ba_schur", {}))
        out["c_ba_sqrt"], _ = _ba_sqrt_run(100, 10000, 64, 8, 2048, 1e-4)
        d = out.setdefault("d_ba_sqrt_100k", {})
        d["exact"], job = _ba_sqrt_run(*BA_100K, 64, 4, 4096, 1e-3,
                                       step_clip=1.0)
        d["bf16x3"], _ = _ba_sqrt_run(*BA_100K, 64, 4, 4096, 1e-3,
                                      step_clip=1.0, precision="high")
        d["jax_bf16x3_chi2_BENCH_r05"] = BA_JAX_100K_CHI2
        d["exact_chi2_over_jax"] = d["exact"]["error"] / BA_JAX_100K_CHI2
        d["bf16x3_chi2_over_exact"] = d["bf16x3"]["error"] \
            / d["exact"]["error"]
        torch.cuda.empty_cache()
        _ba_card_vs_cpu(out.setdefault("e_card_vs_cpu", {}))
        _ba_pipelines(out.setdefault("f_pipelines", {}))
    finally:
        out["seconds"] = time.perf_counter() - t_phase
        _emit(out)
    return job


def _profile_ba(job):
    """(g) one GN iteration of (d) under ``torch.profiler``: its launches,
    the device busy share against the warm iteration's wall (timed in
    (d), without the profiler), top device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from graph_slam_tpu_torch.graph import sqrt_schur_gn_step

    graph, values, tabs, step, wall_s = job
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sqrt_schur_gn_step(graph, values, *tabs, **step)
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    return {"wall_s_per_iter": wall_s, "device_busy_s_per_iter": busy_s,
            "device_busy_share": busy_s / wall_s,
            "launches_per_iter": sum(r[1] for r in rows),
            "top_device_ops": [{"name": k[:90], "count": c, "ms": us / 1e3}
                               for us, c, k in rows[:12]]}


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


def _record_grow_args():
    """Wrap the propagation's ``region_grow`` to keep, by seed shape, the
    arguments of its last call; returns (the calls, undo)."""
    from graph_slam_tpu_torch.planes import propagation

    calls, real = {}, propagation.region_grow

    def recorder(*args, steps=64):
        calls[tuple(args[0].shape)] = (list(args), steps)
        return real(*args, steps=steps)

    propagation.region_grow = recorder
    return calls, lambda: setattr(propagation, "region_grow", real)


def real_frame_grow_inputs(n_frames=4):
    """The fill's inputs on real frames: the arguments of the last
    ``region_grow`` call of a short propagation run of each camera."""
    import torch

    from graph_slam_tpu_torch.config import RS435, SR4000

    calls, undo = _record_grow_args()
    try:
        _plane_run(SR4000, n_frames, True, torch.float32)
        _plane_run(RS435, n_frames, False, torch.float32)
    finally:
        undo()
    return calls


def phase_frames():
    """The kernel on the seed, member and gates of rendered frames, where
    the warped seed covers most of each plane and the fill exits early."""
    rows = [grow_row(args, steps)
            for _, (args, steps) in sorted(real_frame_grow_inputs().items())]
    _emit({"phase": "frames", "shapes": rows})
    _require(len(rows) == 2, "expected one fill shape per camera")


def _ate(est_R, est_t, gt_R, gt_t):
    """The bench's accuracy pair: translational ATE RMSE after a rigid
    (Umeyama, no scale) alignment, and the mean geodesic rotation error in
    degrees after a rotation-average alignment."""
    import numpy as np

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


VIO_CFG = dict(engine="scan", plane_mode="off", optimize_step=10,
               max_imu_window=64, window=16)
VIO_ATE_F64 = 1e-9       # ATE over path length, float64 (exact scenario)
VIO_HELD_GN = 1e-9       # windowed_gn, card vs CPU, max abs over the arena
VIO_HELD_REPLAY = 1e-8   # replay and LM, card vs CPU (abs; chi2 relative)


def _vio_replay(scenario, dtype, final_batch=False):
    """One timed ``run_vio`` on the card; returns (result, seconds)."""
    import torch

    from graph_slam_tpu_torch.pipelines import VioConfig, run_vio

    log, times, stream, params = scenario[:4]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_vio(log, times, stream, params, dtype=dtype,
                  cfg=VioConfig(**VIO_CFG, final_batch=final_batch))
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _vio_checks(res, scenario, label):
    """The phase's gates on one replay; returns its accuracy numbers."""
    import numpy as np
    import torch

    from graph_slam_tpu_torch.io.vro_log import FAILED_INFO_SENTINEL

    log, *_, (gt_R, gt_t) = scenario
    n = len(res.seq_ids)
    valid = int((log.info[:, 0, 0] != FAILED_INFO_SENTINEL).sum())
    step = VIO_CFG["optimize_step"]
    scheduled = sum(1 for f in range(2, n + 1) if f % step == 0)
    v = res.values
    _require(v.pose_t.device.type == "cuda", f"{label}: not on the card")
    _require(res.n_imu_factors == n - 1,
             f"{label}: {res.n_imu_factors} IMU factors for {n} frames")
    _require(res.n_vo_edges == valid,
             f"{label}: {res.n_vo_edges} VO edges, {valid} valid records")
    _require(len(res.chi2_log.rows) == scheduled + 1,
             f"{label}: chi2 log has {len(res.chi2_log.rows)} entries, "
             f"{scheduled} optimizations scheduled")
    finite = all(bool(torch.isfinite(x[:n]).all())
                 for x in (v.pose_R, v.pose_t, v.vel, v.bias))
    chi2 = [r[3] for r in res.chi2_log.rows]
    finite = finite and bool(np.isfinite(chi2).all()) and \
        bool(np.isfinite([res.error0, res.error]).all())
    seqs = np.asarray(res.seq_ids, int)
    ate, rot = _ate(v.pose_R[:n].double().cpu().numpy(),
                    v.pose_t[:n].double().cpu().numpy(), gt_R[seqs],
                    gt_t[seqs])
    path = float(np.linalg.norm(np.diff(gt_t, axis=0), axis=1).sum())
    return {"finite": finite, "ate_mm": ate * 1e3, "ate_rot_deg": rot,
            "ate_over_path": ate / path, "path_m": path,
            "error0": res.error0, "error": res.error,
            "window_chi2_max": float(np.max(chi2[:-1])) if len(chi2) > 1
            else None, "optimizations": scheduled}


def _count_syncs(scenario, replay=None):
    """Host syncs of one ``run_vio`` (``replay``, default ``_vio_replay``;
    setup and read-back included), as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            (replay or _vio_replay)(scenario, torch.float64)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _device_rows(prof):
    """(device µs, launches, name) of every device op a profiler session
    saw, the largest first."""
    import torch

    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    return sorted(rows, reverse=True)


def _profile_replay(scenario, wall_s, replay=None):
    """One more replay of ``scenario`` (``replay``, default
    ``_vio_replay``) under ``torch.profiler`` (device activity only): its
    kernel launches and top device ops, and the device busy share, its
    kernels' time over ``wall_s``, the wall of the same replay timed
    without the profiler (which slows the host); and the rescue
    predictions it ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res, prof_wall = (replay or _vio_replay)(scenario, torch.float64)
    rows = _device_rows(prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    return {"records": len(scenario[0]), "wall_s": wall_s,
            "profiled_wall_s": prof_wall, "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall_s,
            "device_kernels": sum(r[1] for r in rows),
            "launches_per_record": sum(r[1] for r in rows)
            / len(scenario[0]),
            "top_device_ops": [{"name": k[:90], "count": c, "ms": us / 1e3}
                               for us, c, k in rows[:12]],
            "predictions": res.plane_stack.n_predict
            if res.plane_stack is not None else 0}


def _to(x, device):
    """A factor graph or variable arena (NamedTuples of tensors, tables
    nested) copied to ``device``."""
    if isinstance(x, tuple):
        return type(x)(*(_to(f, device) for f in x))
    return x.to(device)


def _perturbed(values, lo, hi, seed, scale=0.01):
    """A CPU copy of the arena with the poses, velocities and biases of
    frames ``lo``..``hi - 1`` moved: rotations by ``scale`` rad,
    translations and velocities by ``scale`` m (m/s), biases by a tenth."""
    import numpy as np
    import torch

    from graph_slam_tpu_torch.core import so3

    r = np.random.default_rng(seed)
    v = _to(values, "cpu")
    n = hi - lo

    def noise(*shape):
        return torch.as_tensor(r.normal(size=shape) * scale, dtype=v.vel.dtype)

    v.pose_R[lo:hi] = so3.expmap(noise(n, 3)) @ v.pose_R[lo:hi]
    v.pose_t[lo:hi] += noise(n, 3)
    v.vel[lo:hi] += noise(n, 3)
    v.bias[lo:hi] += 0.1 * noise(n, 6)
    return v


def _max_diff(a, b, n):
    return max(float((getattr(a, f)[:n].cpu() - getattr(b, f)[:n].cpu())
                     .abs().max()) for f in ("pose_R", "pose_t", "vel",
                                             "bias"))


def windowed_gn_held(res, records, seed=1, device="cuda"):
    """The fixed-lag step on ``device`` against the CPU, at the replay's
    shapes: the last window of the replay's graph (the suffix starts and
    per-table caps the scan engine uses), its free frames perturbed, two
    damped GN iterations from the same values on both."""
    from graph_slam_tpu_torch.graph import total_error
    from graph_slam_tpu_torch.graph.online import window_graph, windowed_gn
    from graph_slam_tpu_torch.pipelines.vio_scan import (_window_caps,
                                                         _window_starts)

    W = VIO_CFG["window"]
    n = len(res.seq_ids)
    caps = _window_caps(res.graph, W)
    starts = _window_starts({"prior_pose": 1, "prior_vel": 1,
                             "prior_bias": 1, "between": records,
                             "imu": res.n_imu_factors}, caps)
    v0 = _perturbed(res.values, n - W, n, seed)
    out = []
    for dev in (device, "cpu"):
        win = window_graph(_to(res.graph, dev), starts, caps)
        v = _to(v0, dev)
        e0 = float(total_error(win, v))
        v, e = windowed_gn(win, v, [n - W] * 3 + [0, 0], (W, W, W), 1e-6, 2)
        out.append((e0, float(e), v))
    (e0, e, v), (_, e_cpu, v_cpu) = out
    return {"window": W, "chi2_perturbed": e0, "chi2_after": e,
            "chi2_after_cpu": e_cpu, "max_abs_err": _max_diff(v, v_cpu, n),
            "on_card": v.pose_t.device.type == "cuda"}


def lm_held(res, seed=2, device="cuda", against_cpu=True):
    """The final batch LM on ``device`` from the replay's values with every
    frame but the first perturbed; against the same LM on the CPU."""
    from graph_slam_tpu_torch.graph import LMParams, lm_optimize, total_error

    n = len(res.seq_ids)
    v0 = _perturbed(res.values, 1, n, seed)
    t0 = time.perf_counter()
    card = lm_optimize(_to(res.graph, device), _to(v0, device), LMParams())
    out = {"frames": n, "error0": float(total_error(res.graph,
                                                     _to(v0, device))),
           "error": float(card.error), "iterations": card.iterations,
           "lm_s": time.perf_counter() - t0, "values": card.values}
    if against_cpu:
        cpu = lm_optimize(_to(res.graph, "cpu"), v0, LMParams())
        out.update(error_cpu=float(cpu.error), iterations_cpu=cpu.iterations,
                   max_abs_err=_max_diff(card.values, cpu.values, n))
    return out


def replay_held(scenario, device="cuda"):
    """The same ``run_vio`` on ``device`` and on the CPU (float64)."""
    from graph_slam_tpu_torch.pipelines import VioConfig, run_vio

    log, times, stream, params = scenario[:4]
    card, cpu = (run_vio(log, times, stream, params, device=dev,
                         cfg=VioConfig(**VIO_CFG, final_batch=False))
                 for dev in (device, "cpu"))
    chi2 = max(abs(a[3] - b[3]) / max(1.0, abs(b[3]))
               for a, b in zip(card.chi2_log.rows, cpu.chi2_log.rows))
    return {"frames": len(cpu.seq_ids),
            "counts_equal": (card.n_imu_factors, card.n_vo_edges)
            == (cpu.n_imu_factors, cpu.n_vo_edges),
            "max_abs_err": _max_diff(card.values, cpu.values,
                                     len(cpu.seq_ids)),
            "chi2_rel_err": chi2,
            "on_card": card.values.pose_t.is_cuda}


def _imu_jacobian_at_identity():
    """The IMU row's Jacobian on the card at delta = 0 with every rotation
    the identity (``logmap`` on its Taylor branch): finite, and equal to
    the same rows' on the CPU."""
    import torch

    from graph_slam_tpu_torch.graph import factors

    def rows(device):
        eye = torch.eye(3, dtype=torch.float64, device=device).expand(4, 3, 3)
        z3 = torch.zeros(4, 3, dtype=torch.float64, device=device)
        z6 = torch.zeros(4, 6, dtype=torch.float64, device=device)
        g = torch.tensor([0.0, 0.0, -9.81], dtype=torch.float64,
                         device=device).expand(4, 3)
        dt = torch.full((4,), 0.1, dtype=torch.float64, device=device)
        H = torch.full((4, 3, 3), 0.01, dtype=torch.float64, device=device)
        return factors._ImuRows(eye, z3, z3, z6, eye, 0.5 * g * 0.01,
                                g * 0.1, z6, eye, z3, z3, H, H, H, H, H, z6,
                                dt, g)

    out = []
    for device in ("cuda", "cpu"):
        r = rows(device)
        out.append(factors._imu_jacobian(r, factors._imu_parts(r)))
    J, J_cpu = out
    _require(bool(torch.isfinite(J).all()),
             "IMU Jacobian not finite at identity on the card")
    err = float((J.cpu() - J_cpu).abs().max())
    _require(err <= 1e-12, f"IMU Jacobian at identity: card vs CPU {err}")
    return err


def phase_vio(n_frames):
    import numpy as np
    import torch

    from graph_slam_tpu_torch.datasets import make_vio_plane_scenario

    t0 = time.perf_counter()
    scenario = make_vio_plane_scenario(n_frames=n_frames, fail_every=20,
                                       render=False, return_gt=True)
    gen_s = time.perf_counter() - t0
    records = len(scenario[0])
    _require(scenario[3].gravity.device.type == "cuda", "params not on card")
    out = {"phase": "vio", "frames": n_frames, "records": records,
           "failed_records": records - int(scenario[0].valid.sum()),
           "config": VIO_CFG, "scenario_s": gen_s,
           "imu_jacobian_identity_card_vs_cpu": _imu_jacobian_at_identity()}

    cold, cold_s = _vio_replay(scenario, torch.float64)
    torch.cuda.reset_peak_memory_stats()
    warm, warm_s = _vio_replay(scenario, torch.float64)
    warm_peak = torch.cuda.max_memory_allocated() / 1e9
    out["f64"] = dict(_vio_checks(warm, scenario, "f64 warm"),
                      cold_s=cold_s, warm_s=warm_s,
                      cold_frames_per_s=n_frames / cold_s,
                      warm_frames_per_s=n_frames / warm_s,
                      warm_loop_s=warm.timers["replay_scan"]["total_s"],
                      warm_peak_mem_gb=warm_peak)
    cold_chk = _vio_checks(cold, scenario, "f64 cold")
    _require(cold_chk["finite"] and out["f64"]["finite"],
             "f64 replay not finite")
    # the bench's gate is 2% of the path; the scenario's edges and IMU are
    # exact, so a float64 replay sits at the rounding floor (3e-14 read)
    for chk in (cold_chk, out["f64"]):
        _require(chk["ate_over_path"] <= VIO_ATE_F64,
                 f"ATE {chk['ate_mm']:.3g} mm over {VIO_ATE_F64:g} of the "
                 f"{chk['path_m']:.3f} m path")
    del cold

    # the fixed-lag step with work to do, on the card against the CPU, at
    # the phase's shapes (its window over the whole replay's arena)
    held = windowed_gn_held(warm, records)
    out["windowed_gn_held"] = held
    _require(held["on_card"], "windowed_gn did not run on the card")
    _require(held["max_abs_err"] <= VIO_HELD_GN,
             f"windowed_gn card vs CPU {held['max_abs_err']:.3g}")
    _require(held["chi2_after"] <= 1e-3 * held["chi2_perturbed"],
             f"windowed_gn: chi2 {held['chi2_perturbed']:.3g} -> "
             f"{held['chi2_after']:.3g}")
    del warm

    f32, f32_s = _vio_replay(scenario, torch.float32)
    out["f32"] = dict(_vio_checks(f32, scenario, "f32"), wall_s=f32_s,
                      frames_per_s=n_frames / f32_s)
    del f32

    # the final dense batch LM over every frame (D = 15 x frames): a
    # (D, D) float64 H, so only at the default size; once from the replay
    # (the reference's output) and once from perturbed values, which it
    # must bring back to the exact trajectory
    if 15 * n_frames <= 30000:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fb, fb_s = _vio_replay(scenario, torch.float64, final_batch=True)
        chk = _vio_checks(fb, scenario, "final batch")
        _require(chk["finite"], "final batch not finite")
        _require(chk["ate_over_path"] <= VIO_ATE_F64,
                 f"final batch ATE {chk['ate_mm']:.3g} mm")
        out["final_batch"] = dict(
            chk, wall_s=fb_s, lm_s=fb.timers["final_batch"]["total_s"],
            tangent_dim=15 * int(fb.values.pose_t.shape[0]),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        lm = lm_held(fb, against_cpu=False)
        v = lm.pop("values")
        seqs = np.asarray(fb.seq_ids, int)
        ate, _ = _ate(v.pose_R[:n_frames].cpu().numpy(),
                      v.pose_t[:n_frames].cpu().numpy(),
                      *(g[seqs] for g in scenario[-1]))
        lm["ate_over_path"] = ate / chk["path_m"]
        out["final_batch_from_perturbed"] = lm
        _require(lm["error"] <= 1e-12 * lm["error0"]
                 and lm["ate_over_path"] <= VIO_ATE_F64,
                 f"LM from perturbed values: chi2 {lm['error0']:.3g} -> "
                 f"{lm['error']:.3g}, ATE {ate:.3g} m")
        del fb, v
        torch.cuda.empty_cache()
    else:
        out["final_batch"] = "not run: dense H beyond 30,000 tangent dims"

    # host syncs per record: the slope between two replay lengths
    short = [make_vio_plane_scenario(n_frames=k, fail_every=20, render=False,
                                     return_gt=True) for k in (100, 200)]
    syncs = [_count_syncs(sc) for sc in short]
    out["host_syncs"] = {"replay_100_frames": syncs[0],
                         "replay_200_frames": syncs[1],
                         "per_record": (syncs[1] - syncs[0])
                         / (len(short[1][0]) - len(short[0][0]))}

    # the whole replay and the final LM on the card against the CPU, on
    # the 200-frame scenario (a CPU run at the phase's size is too slow)
    held = replay_held(short[1])
    out["replay_held_200_frames"] = held
    _require(held["on_card"] and held["counts_equal"]
             and held["max_abs_err"] <= VIO_HELD_REPLAY
             and held["chi2_rel_err"] <= VIO_HELD_REPLAY,
             f"200-frame replay card vs CPU: {held}")
    small, _ = _vio_replay(short[1], torch.float64)
    lm = lm_held(small)
    del lm["values"]
    out["lm_held_200_frames"] = lm
    _require(lm["max_abs_err"] <= VIO_HELD_REPLAY
             and abs(lm["error"] - lm["error_cpu"]) <= VIO_HELD_REPLAY
             * max(1.0, lm["error_cpu"]),
             f"200-frame LM card vs CPU: {lm}")

    # the replay to profile at the end, with its wall timed here, before
    # any profiler session
    sc = _prefix(scenario, PROFILE_FRAMES)
    job = (sc, _vio_replay(sc, torch.float64)[1])
    _emit(out)
    return out, job


RESCUE_CFG = dict(engine="scan", plane_mode="rescue", optimize_step=10,
                  max_imu_window=64, window=16)
RESCUE_ATE_PATH = 0.02   # the JAX bench's gate: ATE <= 2% of the path
# the JAX package's run of the rescue scenario at RESCUE_CFG, by frame
# count: the ATE RMSE (m, Umeyama-aligned as ``_ate``), rescue steps,
# plane factors and landmarks, float64 on the CPU, each from
#     JAX_PLATFORMS=cpu python3 rescue_reference_ate.py --frames N
# Beyond 2,000 frames the ATE is not pinned: a few rescues' fresh
# extractions are near-ties that the RANSAC draws decide, so the port's
# own ATE moves with its seed (over seeds 0-2: 1.7265-1.7861 mm at 5,000
# frames, JAX 1.7267; 9.670-10.851 mm at 27,000, JAX 10.525; ROADMAP,
# "Decided").
RESCUE_JAX = {
    2000: {"ate_m": 0.001651213, "rescue_steps": 19, "n_plane_factors": 74,
           "landmarks": 38},
    5000: {"rescue_steps": 49, "n_plane_factors": 198, "landmarks": 100},
    10000: {"rescue_steps": 99, "n_plane_factors": 398, "landmarks": 200},
    27000: {"rescue_steps": 269, "n_plane_factors": 898, "landmarks": 450},
}
RESCUE_ATE_REL = 0.01    # the port's ATE within 1% of JAX's at that length
RESCUE_HELD = 1e-8       # 200-frame rescue replay, card vs CPU


def _rescue_replay(scenario, dtype, device=None, final_batch=False):
    """One timed rescue ``run_vio`` on ``device`` (``None``: the card);
    returns (result, seconds)."""
    import torch

    from graph_slam_tpu_torch.pipelines import VioConfig, run_vio

    log, times, stream, params, frames, K = scenario[:6]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_vio(log, times, stream, params, frames=frames, intrinsics=K,
                  dtype=dtype, device=device,
                  cfg=VioConfig(**RESCUE_CFG, final_batch=final_batch))
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _failed_new_records(log):
    """Records whose VO edge failed on a frame not seen before: the ones
    the rescue takes."""
    from graph_slam_tpu_torch.io.vro_log import FAILED_INFO_SENTINEL

    seen, n = {int(log.id_from[0])}, 0
    for k in range(len(log)):
        if int(log.id_from[k]) not in seen:
            continue
        new = int(log.id_to[k]) not in seen
        seen.add(int(log.id_to[k]))
        n += new and bool(log.info[k, 0, 0] == FAILED_INFO_SENTINEL)
    return n


def _rescue_checks(res, scenario, label, want=None):
    """The rescue gates on one card replay (``want`` rescue steps, default
    the failed new-frame records); returns its numbers."""
    import numpy as np
    import torch

    log, *_, (gt_R, gt_t) = scenario
    n = len(res.seq_ids)
    steps = res.timers.get("rescue_step", {}).get("calls", 0)
    want = _failed_new_records(log) if want is None else want
    lms = len(res.plane_book.world)
    v = res.values
    _require(steps == want, f"{label}: {steps} rescue steps for {want} "
                            "failed new-frame records")
    _require(res.n_plane_factors > 0 and lms >= 2,
             f"{label}: {res.n_plane_factors} plane factors, {lms} "
             "landmarks")
    _require(v.pose_t.device.type == "cuda" and v.plane.device.type == "cuda",
             f"{label}: not on the card")
    chi2 = [r[3] for r in res.chi2_log.rows]
    finite = all(bool(torch.isfinite(x[:n]).all())
                 for x in (v.pose_R, v.pose_t, v.vel, v.bias)) and \
        bool(torch.isfinite(v.plane[:lms]).all()) and \
        bool(np.isfinite(chi2).all()) and \
        bool(np.isfinite([res.error0, res.error]).all())
    _require(finite, f"{label}: a value or chi2 is not finite")
    seqs = np.asarray(res.seq_ids, int)
    ate, rot = _ate(v.pose_R[:n].double().cpu().numpy(),
                    v.pose_t[:n].double().cpu().numpy(), gt_R[seqs],
                    gt_t[seqs])
    path = float(np.linalg.norm(np.diff(gt_t, axis=0), axis=1).sum())
    return {"rescue_steps": steps, "predictions": res.plane_stack.n_predict,
            "extractions": res.plane_stack.n_extract,
            "n_plane_factors": res.n_plane_factors, "landmarks": lms,
            "finite": finite, "ate_mm": ate * 1e3, "ate_rot_deg": rot,
            "ate_over_path": ate / path, "path_m": path,
            "error0": res.error0, "error": res.error,
            "ms_per_rescue_step": res.timers["rescue_step"]["mean_ms"],
            "rescue_sub_ms": {k: t["mean_ms"] for k, t in res.timers.items()
                              if k.startswith("rescue_")
                              and k != "rescue_step"}}


def _count_rescue_syncs(scenario, replay=None):
    """Host syncs of one rescue ``run_vio`` on the card (``replay``, default
    ``_rescue_replay``; set-up and read-back included), as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them; and the
    predictions it ran."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res, _ = (replay or _rescue_replay)(scenario, torch.float64)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    rescues = res.timers.get("rescue_step", {}).get("calls", 0)
    return (sum("synchroniz" in str(w.message) for w in caught), rescues,
            res.plane_stack.n_predict)


def _rescue_lm(res, seed=3):
    """The final dense LM over the rescue graph on the card: from the
    replay's values, and from values whose frames (all but the first) and
    plane landmarks are moved (``_perturbed``; landmarks by 0.01 rad and
    0.01 m along their chart)."""
    import numpy as np
    import torch

    from graph_slam_tpu_torch.graph import LMParams, lm_optimize, total_error
    from graph_slam_tpu_torch.planes import oriented_plane

    n, k = len(res.seq_ids), len(res.plane_book.world)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    own = lm_optimize(res.graph, res.values, LMParams())
    own_s = time.perf_counter() - t0
    v0 = _perturbed(res.values, 1, n, seed)
    r = np.random.default_rng(seed + 1)
    v0.plane[:k] = oriented_plane.retract(
        v0.plane[:k], torch.as_tensor(r.normal(size=(k, 3)) * 0.01,
                                      dtype=v0.plane.dtype))
    v0 = _to(v0, "cuda")
    e0 = float(total_error(res.graph, v0))
    t0 = time.perf_counter()
    moved = lm_optimize(res.graph, v0, LMParams())
    moved_s = time.perf_counter() - t0
    return {"tangent_dim": 15 * int(res.values.pose_t.shape[0])
            + 3 * int(res.values.plane.shape[0]),
            "from_replay": {"error0": res.error, "error": float(own.error),
                            "iterations": own.iterations, "lm_s": own_s},
            "from_perturbed": {"error0": e0, "error": float(moved.error),
                               "iterations": moved.iterations,
                               "lm_s": moved_s,
                               "chi2_drop_x": e0 / max(float(moved.error),
                                                       1e-300)},
            "on_card": moved.values.plane.is_cuda}


def rescue_held(scenario):
    """The same 200-frame rescue ``run_vio`` on the card and on the CPU
    (float64): the uniforms are drawn on the CPU, so both make the same
    RANSAC draws."""
    import torch

    card, _ = _rescue_replay(scenario, torch.float64)
    cpu, _ = _rescue_replay(scenario, torch.float64, device="cpu")
    n = len(cpu.seq_ids)
    chi2 = max(abs(a[3] - b[3]) / max(1.0, abs(b[3]))
               for a, b in zip(card.chi2_log.rows, cpu.chi2_log.rows))
    counts = [(r.n_plane_factors, len(r.plane_book.world),
               r.n_imu_factors, r.n_vo_edges) for r in (card, cpu)]
    return {"frames": n, "counts_card": counts[0], "counts_cpu": counts[1],
            "counts_equal": counts[0] == counts[1],
            "max_abs_err_pos_m": float((card.values.pose_t[:n].cpu()
                                        - cpu.values.pose_t[:n]).abs().max()),
            "max_abs_err": _max_diff(card.values, cpu.values, n),
            "chi2_rel_err": chi2, "on_card": card.values.pose_t.is_cuda,
            "predictions": card.plane_stack.n_predict}


def phase_rescue(n_frames):
    """The flagship rescue replay; returns (the phase's line, the card
    predictions it ran, the region-grow arguments of a rescue with the
    most planes)."""
    import numpy as np
    import torch

    from graph_slam_tpu_torch.datasets import make_vio_plane_scenario

    t0 = time.perf_counter()
    scenario = make_vio_plane_scenario(n_frames=n_frames, fail_every=100,
                                       render="lazy", return_gt=True)
    out = {"phase": "rescue", "frames": n_frames,
           "records": len(scenario[0]),
           "failed_new_records": _failed_new_records(scenario[0]),
           "config": RESCUE_CFG, "scenario_s": time.perf_counter() - t0}
    predictions = 0
    steps_s = out["steps_s"] = {}

    def lap(name):
        nonlocal t0
        steps_s[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    calls, undo = _record_grow_args()
    try:
        cold, cold_s = _rescue_replay(scenario, torch.float64)
    finally:
        undo()
    torch.cuda.reset_peak_memory_stats()
    warm, warm_s = _rescue_replay(scenario, torch.float64)
    warm_peak = torch.cuda.max_memory_allocated() / 1e9
    cold_chk = _rescue_checks(cold, scenario, "f64 cold")
    out["f64"] = dict(_rescue_checks(warm, scenario, "f64 warm"),
                      cold_s=cold_s, warm_s=warm_s,
                      cold_frames_per_s=n_frames / cold_s,
                      warm_frames_per_s=n_frames / warm_s,
                      cold_ms_per_rescue_step=cold_chk["ms_per_rescue_step"],
                      warm_peak_mem_gb=warm_peak)
    predictions += cold_chk["predictions"] + out["f64"]["predictions"]
    pin = RESCUE_JAX.get(n_frames, {})
    for chk in (cold_chk, out["f64"]):
        _require(chk["ate_over_path"] <= RESCUE_ATE_PATH,
                 f"rescue ATE {chk['ate_mm']:.3f} mm beyond "
                 f"{RESCUE_ATE_PATH:g} of the {chk['path_m']:.3f} m path")
        if "ate_m" in pin:
            rel = abs(chk["ate_mm"] / 1e3 - pin["ate_m"]) / pin["ate_m"]
            chk["ate_rel_to_jax"] = rel
            _require(rel <= RESCUE_ATE_REL,
                     f"rescue ATE {chk['ate_mm']:.6f} mm vs the JAX "
                     f"package's {pin['ate_m'] * 1e3:.6f} mm: {rel:.3g}")
        for k in ("rescue_steps", "n_plane_factors", "landmarks"):
            _require(chk[k] == pin.get(k, chk[k]),
                     f"rescue {k} {chk[k]} != the JAX package's "
                     f"{pin.get(k)}")
    out["jax"] = pin or "not pinned at this length"
    del cold
    # the same scenario without planes: what the rescue costs the replay
    free, free_s = _vio_replay(scenario, torch.float64)
    out["plane_free_same_log"] = {"wall_s": free_s,
                                  "frames_per_s": n_frames / free_s,
                                  "rescue_over_plane_free_wall":
                                  warm_s / free_s}
    del free
    lap("f64_replays")

    # the final dense LM over every frame and landmark: a (D, D) float64 H
    if 15 * n_frames <= 30000:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lm = _rescue_lm(warm)
        lm["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["final_lm"] = lm
        _require(lm["on_card"], "the rescue LM did not run on the card")
        _require(lm["from_perturbed"]["chi2_drop_x"] >= 1e3,
                 f"rescue LM from perturbed values: {lm['from_perturbed']}")
        torch.cuda.empty_cache()
    else:
        out["final_lm"] = "not run: dense H beyond 30,000 tangent dims"
    lap("final_lm")

    f32, f32_s = _rescue_replay(scenario, torch.float32)
    out["f32"] = dict(_rescue_checks(f32, scenario, "f32"), wall_s=f32_s,
                      frames_per_s=n_frames / f32_s)
    predictions += out["f32"]["predictions"]
    del f32
    lap("f32_replay")

    # 200 frames, every 20th edge failed: card against CPU
    short = make_vio_plane_scenario(n_frames=200, fail_every=20,
                                    render="lazy", return_gt=True)
    held = rescue_held(short)
    predictions += held["predictions"]
    out["rescue_held_200_frames"] = held
    _require(held["on_card"] and held["counts_equal"]
             and held["max_abs_err_pos_m"] <= RESCUE_HELD
             and held["chi2_rel_err"] <= RESCUE_HELD,
             f"200-frame rescue card vs CPU: {held}")
    lap("held_200_frames")

    # host syncs per rescue: the slope between two failure rates
    sparse = make_vio_plane_scenario(n_frames=200, fail_every=40,
                                     render="lazy", return_gt=True)
    counts = [_count_rescue_syncs(sc) for sc in (short, sparse)]
    predictions += sum(c[2] for c in counts)
    out["host_syncs"] = {
        "replay_200_every_20": counts[0][:2],
        "replay_200_every_40": counts[1][:2],
        "per_rescue": (counts[0][0] - counts[1][0])
        / max(1, counts[0][1] - counts[1][1])}
    lap("host_syncs")

    # the replay to profile at the end, timed here
    sc = _prefix(scenario, PROFILE_FRAMES)
    res, wall = _rescue_replay(sc, torch.float64)
    predictions += res.plane_stack.n_predict
    _emit(out)
    return out, predictions, calls[max(calls)], (sc, wall)


ONLINE_CFG = dict(engine="online", plane_mode="rescue", optimize_step=10,
                  max_imu_window=64, bucket=64, window=16)
# the JAX package's ATE RMSE (m) of its ONLINE engine on the 2,000-frame
# rescue scenario at ONLINE_CFG, float64 on the CPU, as ``_ate``:
#     JAX_PLATFORMS=cpu python3 rescue_reference_ate.py --frames 2000 \
#         --engine online
ONLINE_ATE_JAX_M = 0.001651278053
ONLINE_ATE_JAX_FRAMES = 2000
ONLINE_HELD = 1e-8       # 200 frames, card vs CPU
INCREMENTAL_BATCH = 1e-6  # incremental vs batch chi2, relative


def _online_replay(scenario, cfg, dtype=None, device=None):
    """One timed ``run_vio`` of ``cfg`` (a ``VioConfig``) with the
    scenario's frames on ``device`` (``None``: the card); returns (result,
    seconds)."""
    import torch

    from graph_slam_tpu_torch.pipelines import run_vio

    log, times, stream, params, frames, K = scenario[:6]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_vio(log, times, stream, params, frames=frames, intrinsics=K,
                  dtype=dtype or torch.float64, device=device, cfg=cfg)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _online_cfg(**kw):
    from graph_slam_tpu_torch.pipelines import VioConfig

    return VioConfig(**dict(ONLINE_CFG, final_batch=False, **kw))


def _online_flagship(scenario, dtype=None, device=None):
    """The flagship through the online engine (``ONLINE_CFG``)."""
    return _online_replay(scenario, _online_cfg(), dtype, device)


def _prefix(scenario, n):
    """The first ``n`` frames of a scenario: the records between them, the
    ground truth cut to them (the stream, times and frames are shared)."""
    from graph_slam_tpu_torch.io import VROLog

    log, times, stream, params, frames, K, (gt_R, gt_t) = scenario
    keep = (log.id_to < n) & (log.id_from < n)
    return (VROLog(log.id_to[keep], log.id_from[keep], log.xi[keep],
                   log.info[keep]), times, stream, params, frames, K,
            (gt_R[:n], gt_t[:n]))


def corridor_sequence(n, seed=0, loop_every=5, loop_span=20,
                      meas_noise=0.01):
    """A loopy corridor (``tests/test_online_engine.py``'s, in numpy):
    the ground-truth chain, the edges ``(i, j, (R, t))`` with rotation and
    translation noise, odometry every frame and a loop closure every
    ``loop_every`` frames back ``loop_span``; and the generator."""
    import numpy as np

    from graph_slam_tpu_torch.datasets.synthetic import _so3_exp

    r = np.random.default_rng(seed)
    gt = [(np.eye(3), np.zeros(3))]
    for k in range(1, n):
        w = np.array([0.0, 0.0, 0.03 * np.sin(k / 37.0)])
        v = np.array([0.3, 0.02 * np.cos(k / 23.0), 0.0])
        R, t = gt[-1]
        gt.append((R @ _so3_exp(w), t + R @ v))

    def noisy_between(i, j):
        (Ri, ti), (Rj, tj) = gt[i], gt[j]
        dR = _so3_exp(r.normal(size=3) * meas_noise * 0.3)
        return (Ri.T @ Rj @ dR, Ri.T @ (tj - ti) + r.normal(size=3)
                * meas_noise)

    edges = []
    for k in range(1, n):
        edges.append((k - 1, k, noisy_between(k - 1, k)))
        if k % loop_every == 0 and k >= loop_span:
            edges.append((k - loop_span, k, noisy_between(k - loop_span, k)))
    return gt, edges, r


def incremental_vs_batch(n=1000):
    """``tests/test_online_engine.py``'s 1,000-frame proof on the card: one
    PCG ``IncrementalOptimizer`` update per appended frame (odometry-
    composed estimates), then a polish of warm updates, against a batch PCG
    LM from perturbed values polished by dense GN steps; per-update wall
    times."""
    import numpy as np
    import torch

    from graph_slam_tpu_torch.core import se3
    from graph_slam_tpu_torch.datasets.synthetic import _so3_exp
    from graph_slam_tpu_torch.graph import (GraphBuilder, IncrementalOptimizer,
                                            LMParams, OnlineGraph,
                                            empty_arena, empty_graph,
                                            gn_optimize, lm_optimize)

    info_sqrt = np.linalg.cholesky(np.diag([100.0] * 3 + [25.0] * 3)).T
    gt, edges, r = corridor_sequence(n)

    b = GraphBuilder()
    for k, (R, t) in enumerate(gt):
        if k == 0:
            b.add_pose((R, t))
        else:
            d = r.normal(size=6) * 0.05
            b.add_pose((R @ _so3_exp(d[:3]), t + R @ d[3:]))
    b.add_prior_pose(0, gt[0], sigmas=np.full(6, 1e-6))
    for i, j, T in edges:
        b.add_between(i, j, T, sqrt_info=info_sqrt)
    graph, values = b.build(bucket=64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = lm_optimize(graph, values, LMParams(
        solver="pcg", pcg_iters=200, relative_error_tol=1e-12,
        absolute_error_tol=1e-12))
    # the polish in exact (dense) Newton steps: PCG polish steps stop
    # short of the optimum by ~1e-6 relative in chi2 at this size
    batch = gn_optimize(graph, batch.values, iterations=5, solver="dense",
                        damping=1e-12)
    chi2_batch = float(batch.error)
    batch_s = time.perf_counter() - t0

    og = OnlineGraph(empty_graph(prior_pose_cap=2, between_cap=2048),
                     empty_arena(pose_cap=1024))
    inc = IncrementalOptimizer(iters_per_update=1, damping=1e-9,
                               solver="pcg", pcg_iters=60)
    pose0 = se3.Pose(*(torch.as_tensor(x) for x in gt[0]))
    og.set_pose(0, pose0)
    og.add_prior_pose(0, pose0, np.diag(np.full(6, 1e6)))
    dev = og.values.pose_t.device
    meas = [se3.Pose(torch.as_tensor(T[0], device=dev),
                     torch.as_tensor(T[1], device=dev))
            for _, _, T in edges]
    ei, times = 0, []
    for k in range(1, n):
        og.set_pose(k, se3.compose(og.pose(k - 1), meas[ei]))
        while ei < len(edges) and edges[ei][1] <= k:
            og.add_between(edges[ei][0], edges[ei][1], meas[ei], info_sqrt)
            ei += 1
        t0 = time.perf_counter()
        float(inc.update(og).error)          # waits for the update
        times.append(time.perf_counter() - t0)
    chi2_inc = float(IncrementalOptimizer(
        iters_per_update=8, damping=1e-12, solver="pcg",
        pcg_iters=300).update(og).error)
    err = (og.values.pose_t[:n] - batch.values.pose_t[:n]).norm(dim=1)
    early = float(np.median(times[50:150]))
    late = float(np.median(times[-100:]))
    return {"frames": n, "chi2_incremental": chi2_inc,
            "chi2_batch": chi2_batch,
            "chi2_rel_diff": abs(chi2_inc - chi2_batch) / chi2_batch,
            "update_ms_median_50_150": early * 1e3,
            "update_ms_median_last_100": late * 1e3,
            "batch_s": batch_s, "pos_max_diff_m": float(err.max()),
            "on_card": og.values.pose_t.is_cuda}


def checkpoint_held(og, tmp):
    """``save_state`` of a card graph, ``load_state`` on the card: every
    array bit-equal, the slot counters and ``error()`` equal."""
    import torch

    from graph_slam_tpu_torch.graph import OnlineGraph

    path = os.path.join(tmp, "online_state.npz")
    t0 = time.perf_counter()
    og.save_state(path)
    save_s = time.perf_counter() - t0
    back = OnlineGraph.load_state(path)
    leaves = [(a, b) for ta, tb in zip(og.graph, back.graph)
              for a, b in zip(ta, tb)] + list(zip(og.values, back.values))
    return {"arrays": len(leaves),
            "bit_equal": all(b.is_cuda and torch.equal(a, b)
                             for a, b in leaves),
            "slots_equal": back._n == og._n,
            "error": og.error(), "error_loaded": back.error(),
            "bytes": os.path.getsize(path), "save_s": save_s}


def phase_online(n_frames, scan_counts):
    """The online engine (``engine="online"``) on the card: (a) the
    flagship rescue replay at full length, with a plane-free replay of the
    same log; (b) its first 200 frames on the card against the CPU; (c)
    the default ``VioConfig()`` on its first 300; (d) ``plane_mode=
    "always"`` on its first 200; (e) incremental against batch on a
    1,000-pose corridor; (f) a checkpoint of (a)'s graph. ``scan_counts``
    are the ``rescue`` phase's (plane factors, landmarks) on the same
    scenario, or None. Returns (the phase's line, the card predictions
    it ran, the replay to profile)."""
    import numpy as np
    import torch

    from graph_slam_tpu_torch.datasets import make_vio_plane_scenario
    from graph_slam_tpu_torch.pipelines import VioConfig
    from graph_slam_tpu_torch.planes.region_grow import region_grow

    t0 = time.perf_counter()
    scenario = make_vio_plane_scenario(n_frames=n_frames, fail_every=100,
                                       render="lazy", return_gt=True)
    out = {"phase": "online", "frames": n_frames,
           "records": len(scenario[0]),
           "failed_new_records": _failed_new_records(scenario[0]),
           "config": ONLINE_CFG, "scenario_s": time.perf_counter() - t0}
    predictions = 0

    # (a) the flagship, cold and warm
    cold, cold_s = _online_flagship(scenario)
    torch.cuda.reset_peak_memory_stats()
    warm, warm_s = _online_flagship(scenario)
    warm_peak = torch.cuda.max_memory_allocated() / 1e9
    cold_chk = _rescue_checks(cold, scenario, "online cold")
    chk = out["a_f64"] = dict(
        _rescue_checks(warm, scenario, "online warm"), cold_s=cold_s,
        warm_s=warm_s, cold_frames_per_s=n_frames / cold_s,
        warm_frames_per_s=n_frames / warm_s,
        cold_ms_per_rescue_step=cold_chk["ms_per_rescue_step"],
        ms_per_new_frame=warm.timers["new_frame"]["mean_ms"],
        ms_per_update=warm.timers["optimize"]["mean_ms"],
        updates=warm.timers["optimize"]["calls"],
        warm_peak_mem_gb=warm_peak)
    predictions += cold_chk["predictions"] + chk["predictions"]
    for c in (cold_chk, chk):
        _require(c["ate_over_path"] <= RESCUE_ATE_PATH,
                 f"online ATE {c['ate_mm']:.3f} mm beyond "
                 f"{RESCUE_ATE_PATH:g} of the {c['path_m']:.3f} m path")
        if n_frames == ONLINE_ATE_JAX_FRAMES:
            rel = abs(c["ate_mm"] / 1e3 - ONLINE_ATE_JAX_M) / ONLINE_ATE_JAX_M
            c["ate_rel_to_jax"] = rel
            _require(rel <= RESCUE_ATE_REL,
                     f"online ATE {c['ate_mm']:.6f} mm vs the JAX "
                     f"package's {ONLINE_ATE_JAX_M * 1e3:.6f} mm: {rel:.3g}")
    out["ate_jax_mm"] = ONLINE_ATE_JAX_M * 1e3 \
        if n_frames == ONLINE_ATE_JAX_FRAMES else "not pinned at this length"
    if scan_counts is not None:
        _require((chk["n_plane_factors"], chk["landmarks"]) == scan_counts,
                 f"online (plane factors, landmarks) "
                 f"{(chk['n_plane_factors'], chk['landmarks'])} != the scan "
                 f"engine's {scan_counts}")
    out["scan_counts"] = scan_counts
    del cold
    free, free_s = _online_replay(scenario, _online_cfg(plane_mode="off"))
    _require(free.timers["fused_frame"]["calls"] == n_frames - 1,
             "the plane-free online replay left the fast path")
    out["a_plane_free_same_log"] = {
        "wall_s": free_s, "frames_per_s": n_frames / free_s,
        "ms_per_fused_frame": free.timers["fused_frame"]["mean_ms"],
        "rescue_over_plane_free_wall": warm_s / free_s}
    del free

    with tempfile.TemporaryDirectory() as tmp:
        ck = out["f_checkpoint"] = checkpoint_held(warm.plane_stack.og, tmp)
    _require(ck["bit_equal"] and ck["slots_equal"]
             and ck["error"] == ck["error_loaded"],
             f"checkpoint not bit-equal: {ck}")
    del warm

    # (b) the first 200 frames, card against CPU
    short = _prefix(scenario, 200)
    card, _ = _online_flagship(short)
    cpu, cpu_s = _online_flagship(short, device="cpu")
    predictions += card.plane_stack.n_predict
    n = len(cpu.seq_ids)
    counts = [(r.n_plane_factors, len(r.plane_book.world), r.n_imu_factors,
               r.n_vo_edges, r.timers["rescue_step"]["calls"])
              for r in (card, cpu)]
    held = out["b_held_200_frames"] = {
        "frames": n, "counts_card": counts[0], "counts_cpu": counts[1],
        "max_abs_err_pos_m": float((card.values.pose_t[:n].cpu()
                                    - cpu.values.pose_t[:n]).abs().max()),
        "max_abs_err": _max_diff(card.values, cpu.values, n),
        "chi2_rel_err": max(abs(a[3] - b[3]) / max(1.0, abs(b[3]))
                            for a, b in zip(card.chi2_log.rows,
                                            cpu.chi2_log.rows)),
        "cpu_s": cpu_s, "on_card": card.values.pose_t.is_cuda}
    _require(held["on_card"] and counts[0] == counts[1]
             and held["max_abs_err_pos_m"] <= ONLINE_HELD
             and held["chi2_rel_err"] <= ONLINE_HELD,
             f"200-frame online replay card vs CPU: {held}")
    del card, cpu

    # (c) the default configuration on the first 300 frames; its last
    # full-arena update falls on the last frame, so the final LM starts at
    # the optimum and may move chi2 by rounding only: the LM is held to
    # not raising it, and to bringing perturbed values back (>= 1e3x)
    pre300 = _prefix(scenario, 300)
    res, wall = _online_replay(pre300, VioConfig())
    c = _rescue_checks(res, pre300, "default config")
    predictions += c["predictions"]
    lm = _rescue_lm(res)
    out["c_default_300_frames"] = dict(
        c, wall_s=wall, frames_per_s=300 / wall,
        tangent_dim=lm["tangent_dim"],
        ms_per_update=res.timers["optimize"]["mean_ms"],
        updates=res.timers["optimize"]["calls"],
        final_lm_s=res.timers["final_batch"]["total_s"],
        lm_from_perturbed=lm["from_perturbed"])
    _require(c["ate_over_path"] <= RESCUE_ATE_PATH
             and res.error <= res.error0 * (1.0 + 1e-12)
             and lm["on_card"]
             and lm["from_perturbed"]["chi2_drop_x"] >= 1e3,
             f"default config: ATE {c['ate_mm']:.3f} mm, final LM chi2 "
             f"{res.error0:.16g} -> {res.error:.16g}, from perturbed "
             f"values {lm['from_perturbed']}")
    del res

    # (d) plane_mode="always" on the first 200 frames
    before = region_grow.launches
    res, wall = _online_replay(short, _online_cfg(plane_mode="always"))
    launched = region_grow.launches - before
    c = _rescue_checks(res, short, "always", want=len(res.seq_ids) - 1)
    predictions += c["predictions"]
    out["d_always_200_frames"] = dict(c, wall_s=wall,
                                      frames_per_s=200 / wall,
                                      region_grow_launches=launched)
    _require(c["ate_over_path"] <= RESCUE_ATE_PATH
             and launched == c["predictions"] >= 190,
             f"always: {launched} launches, {c['predictions']} predictions,"
             f" ATE {c['ate_mm']:.3f} mm")
    del res

    # host syncs a frame (the plane-free fast path, two lengths) and a
    # rescue (two failure rates)
    free = [make_vio_plane_scenario(n_frames=k, fail_every=20, render=False,
                                    return_gt=True) for k in (100, 200)]
    syncs = [_count_syncs(sc, lambda s, dt: _online_replay(
        s, _online_cfg(plane_mode="off"), dt)) for sc in free]
    rates = [make_vio_plane_scenario(n_frames=200, fail_every=k,
                                     render="lazy", return_gt=True)
             for k in (20, 40)]
    counts = [_count_rescue_syncs(sc, _online_flagship) for sc in rates]
    predictions += sum(x[2] for x in counts)
    out["host_syncs"] = {
        "plane_free_100_frames": syncs[0], "plane_free_200_frames": syncs[1],
        "per_frame_plane_free": (syncs[1] - syncs[0])
        / (len(free[1][0]) - len(free[0][0])),
        "rescue_200_every_20": counts[0][:2],
        "rescue_200_every_40": counts[1][:2],
        "per_rescue": (counts[0][0] - counts[1][0])
        / max(1, counts[0][1] - counts[1][1])}

    # (e) incremental against batch on a 1,000-pose corridor
    inc = out["e_incremental_vs_batch"] = incremental_vs_batch()
    _require(inc["on_card"] and inc["chi2_rel_diff"] < INCREMENTAL_BATCH,
             f"incremental vs batch chi2: {inc}")
    _require(inc["update_ms_median_last_100"]
             < 3.0 * inc["update_ms_median_50_150"],
             f"per-update time not flat: {inc}")

    # the replay to profile at the end, timed here
    sc = _prefix(scenario, PROFILE_FRAMES)
    res, wall = _online_flagship(sc)
    predictions += res.plane_stack.n_predict
    _emit(out)
    return out, predictions, (sc, wall)


FRONTEND_HARRIS_FRAMES = 1000
FRONTEND_SIFT_FRAMES = 300
FRONTEND_HELD_FRAMES = 64      # (c): the first frames of (a), card vs CPU
FRONTEND_HELD = 1e-5           # (c): trajectories, card vs CPU, m
FRONTEND_STATUS_SHARE = 0.99   # statuses as JAX's on at least this share
FRONTEND_KEYFRAMES_REL = 0.01  # keyframe count within this of JAX's
FRONTEND_ATE_REL = 0.02        # ATE within 2% of JAX's
# The JAX package's runs of the same frames, on the CPU in float64 (JAX
# 0.9.0; ``JAX_PLATFORMS=cpu python3 frontend_reference_ate.py --frames
# 1000`` and ``... --frames 300 --features sift``, 417 s and 271 s): each
# printed its statuses, one letter a frame, "F" then "SK" repeated then a
# last "S" -- every second frame a keyframe -- as built here.
FRONTEND_JAX = {
    "harris": {"frames": 1000, "keyframes": 500, "ate_m": 0.0005363304169709378,
               "lookback_edges": 2475, "global_edges": 1299,
               "statuses": "F" + "SK" * 499 + "S"},
    "sift": {"frames": 300, "keyframes": 150, "ate_m": 0.00048457549064933063,
             "lookback_edges": 725, "global_edges": 334,
             "statuses": "F" + "SK" * 149 + "S"},
}


class _SyncedTimer:
    """A ``PhaseTimer`` whose phases start and end with the card
    synchronised, so each phase's time holds its own device work."""

    def __init__(self):
        from graph_slam_tpu_torch.utils.profiling import PhaseTimer

        self._inner = PhaseTimer()

    def __call__(self, phase):
        import contextlib

        import torch

        @contextlib.contextmanager
        def timed():
            torch.cuda.synchronize()
            with self._inner(phase):
                yield
                torch.cuda.synchronize()

        return timed()

    def summary(self):
        return self._inner.summary()


def _render_frames(n):
    """The ``n`` frames of ``frontend_reference_ate.room_path(n)``,
    rendered on the card; its first and last frames are held bit-equal to
    the same renderer's on the CPU."""
    import torch

    import frontend_reference_ate as fra
    from graph_slam_tpu_torch.config import RS435

    frames = list(fra.path_frames(RS435, n, device="cuda"))
    tex, rays = fra.room_scene(RS435, "cpu")
    R, t = fra.room_path(n)
    for k in (0, n - 1):
        want = fra.render_room_frame(RS435, R[k], t[k], tex, rays)
        for got, ref in zip(frames[k], want):
            _require(torch.equal(got.cpu(), ref),
                     f"frame {k} rendered on the card differs from the "
                     "CPU's")
    return frames


def _slam(features, device=None):
    from graph_slam_tpu_torch.config import RS435, SlamParams
    from graph_slam_tpu_torch.pipelines import OnlineSlam

    return OnlineSlam(cam=RS435, params=SlamParams(), features=features,
                      global_loop_k=2, device=device)


def _slam_run(features, frames, device=None, timers=None):
    """``OnlineSlam`` over ``frames`` then one final ``optimize()``: (the
    session, its status letters, the loop's wall s, the final optimize's
    wall s)."""
    import torch

    import frontend_reference_ate as fra

    slam = _slam(features, device)
    if timers is not None:
        slam.timers = timers
    sync = torch.cuda.synchronize if slam._device.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    statuses = "".join(fra.STATUS_LETTER[slam.process_frame(img, d, seq_id=k)]
                       for k, (img, d) in enumerate(frames))
    sync()
    t1 = time.perf_counter()
    slam.optimize()
    sync()
    return slam, statuses, t1 - t0, time.perf_counter() - t1


def _slam_checks(slam, statuses, features, n_path):
    """The run against the path and against the JAX package's run."""
    import numpy as np

    import frontend_reference_ate as fra

    ref = FRONTEND_JAX[features]
    _, t, _, seqs = slam.trajectory()
    _, gt_t = fra.room_path(n_path)
    ate = fra.ate(np.asarray(t, np.float64), gt_t[np.asarray(seqs)])
    bt = slam.og.graph.between
    act = bt.active.cpu().numpy()
    lookback, global_ = fra.loop_edges(bt.i.cpu().numpy()[act],
                                       bt.j.cpu().numpy()[act],
                                       slam.params.lookback_nodes)
    same = sum(a == b for a, b in zip(statuses, ref["statuses"]))
    out = {"frames": len(statuses), "keyframes": slam.num_keyframes,
           "failed": statuses.count("X"), "lookback_edges": lookback,
           "global_edges": global_, "ate_m": ate, "jax_ate_m": ref["ate_m"],
           "ate_diff_m": ate - ref["ate_m"],
           "status_share_as_jax": same / len(ref["statuses"]),
           "jax_keyframes": ref["keyframes"],
           "jax_loop_edges": [ref["lookback_edges"], ref["global_edges"]],
           "error": slam.error()}
    _require(len(statuses) == ref["frames"],
             f"{features}: {len(statuses)} frames, JAX ran {ref['frames']}")
    _require(out["status_share_as_jax"] >= FRONTEND_STATUS_SHARE,
             f"{features}: statuses as JAX's on "
             f"{out['status_share_as_jax']:.4f} of the frames")
    _require(abs(slam.num_keyframes - ref["keyframes"])
             <= FRONTEND_KEYFRAMES_REL * ref["keyframes"],
             f"{features}: {slam.num_keyframes} keyframes vs JAX's "
             f"{ref['keyframes']}")
    _require(abs(ate - ref["ate_m"]) <= FRONTEND_ATE_REL * ref["ate_m"],
             f"{features}: ATE {ate * 1e3:.4f} mm vs JAX's "
             f"{ref['ate_m'] * 1e3:.4f} mm")
    return out


def _per_frame(timers, n_frames):
    return {k: v["total_s"] * 1e3 / n_frames for k, v in timers.items()}


def _extractor_ms(frame, reps=20):
    """Each extractor alone on one 640 x 480 frame (tensors on the card):
    ms a call on the card (CUDA events, warm) and on the CPU (wall, one
    warm call)."""
    import torch

    from graph_slam_tpu_torch.config import RS435
    from graph_slam_tpu_torch.vision import extract_features, sift_features

    host = [x.cpu() for x in frame]
    out = {}
    for name, fn in (("harris", extract_features), ("sift", sift_features)):
        fn(RS435, *frame)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        for _ in range(reps):
            fn(RS435, *frame)
        end.record()
        end.synchronize()
        fn(RS435, *host)
        t0 = time.perf_counter()
        fn(RS435, *host)
        out[name] = {"card_ms": start.elapsed_time(end) / reps,
                     "cpu_ms": (time.perf_counter() - t0) * 1e3}
    return out


def _count_frontend_syncs(frames):
    """Host syncs of an ``OnlineSlam`` run over ``frames``: the ones
    ``torch.cuda.set_sync_debug_mode("warn")`` reports (implicit syncs in
    torch ops: the SVD's and solves' status reads, blocking copies) and the
    explicit stream synchronisations of the one-copy read-backs."""
    import torch

    explicit = [0]
    plain = torch.cuda.Stream.synchronize

    def counted(self):
        explicit[0] += 1
        return plain(self)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.Stream.synchronize = counted
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _slam_run("harris", frames)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.Stream.synchronize = plain
    implicit = sum("synchroniz" in str(w.message) for w in caught)
    return {"implicit": implicit, "explicit": explicit[0],
            "per_frame": (implicit + explicit[0]) / len(frames)}


def phase_frontend(smi):
    """The visual frontend and ``OnlineSlam`` on the card at 640 x 480
    (RS435), on ``frontend_reference_ate.py``'s rendered box room with
    ``global_loop_k=2`` and every other setting the default: (a) Harris
    over 1,000 frames and (b) SIFT over 300, each held to the JAX
    package's run of the same frames (statuses, keyframes, ATE) with at
    least one global loop edge in (a); (c) the first 64 frames of (a) on
    the card and on the CPU, statuses equal and trajectories within 1e-5
    m; the per-phase times of (c) with the card synchronised at each
    phase's ends, the host syncs a frame, and each extractor alone.
    Returns (the phase's line, (a)'s first frames for the profile)."""
    import numpy as np
    import torch

    out = {"phase": "frontend", "card": smi}
    t0 = time.perf_counter()
    harris_frames = _render_frames(FRONTEND_HARRIS_FRAMES)
    sift_frames = _render_frames(FRONTEND_SIFT_FRAMES)
    out["render_s"] = time.perf_counter() - t0

    for features, frames in (("harris", harris_frames),
                             ("sift", sift_frames)):
        torch.cuda.reset_peak_memory_stats()
        slam, statuses, loop_s, opt_s = _slam_run(features, frames)
        chk = _slam_checks(slam, statuses, features, len(frames))
        chk.update(loop_s=loop_s, final_optimize_s=opt_s,
                   frames_per_s=len(frames) / loop_s,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   ms_per_frame_by_phase=_per_frame(slam.timers.summary(),
                                                    len(frames)),
                   phase_calls={k: v["calls"] for k, v in
                                slam.timers.summary().items()})
        out["a_harris" if features == "harris" else "b_sift"] = chk
        del slam
    _require(out["a_harris"]["global_edges"] >= 1,
             "the Harris run closed no global loop")

    # (c) card against CPU on the first frames of (a)
    held = harris_frames[:FRONTEND_HELD_FRAMES]
    card, st_card, card_s, _ = _slam_run("harris", held)
    cpu, st_cpu, cpu_s, _ = _slam_run(
        "harris", [[x.cpu() for x in f] for f in held], device="cpu")
    t_card, t_cpu = card.trajectory()[1], cpu.trajectory()[1]
    diff = float(np.abs(t_card - t_cpu).max()) \
        if t_card.shape == t_cpu.shape else float("inf")
    out["c_card_vs_cpu"] = {"frames": len(held), "statuses_equal":
                            st_card == st_cpu, "keyframes": card.num_keyframes,
                            "max_abs_m": diff, "card_loop_s": card_s,
                            "cpu_loop_s": cpu_s}
    _require(st_card == st_cpu, "card and CPU statuses differ")
    _require(diff <= FRONTEND_HELD,
             f"card vs CPU trajectories {diff:.3g} m apart")
    synced, _, synced_s, _ = _slam_run("harris", held, timers=_SyncedTimer())
    out["c_ms_per_frame_synced"] = dict(
        _per_frame(synced.timers.summary(), len(held)),
        wall=synced_s * 1e3 / len(held))
    out["c_syncs"] = _count_frontend_syncs(held)
    out["extractors_640x480"] = _extractor_ms(harris_frames[0])
    out["seconds"] = time.perf_counter() - t0
    _emit(out)
    return out, (held, card_s)


def _profile_frontend(job):
    """(c)'s 64 frames again under the profiler: launches a frame, device
    busy share against the same run's wall without the profiler, top
    device ops."""
    from torch.profiler import ProfilerActivity, profile

    frames, wall_s = job
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, prof_s, _ = _slam_run("harris", frames)
    rows = _device_rows(prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    return {"frames": len(frames), "wall_s": wall_s,
            "profiled_wall_s": prof_s, "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall_s,
            "launches_per_frame": sum(r[1] for r in rows) / len(frames),
            "top_device_ops": [{"name": k[:90], "count": c, "ms": us / 1e3}
                               for us, c, k in rows[:12]]}


# -- the command line: ``python -m graph_slam_tpu_torch`` from RGB-D frames --

CLI_FRAMES = 300          # (a): the first frames of the frontend's Harris path
CLI_TSDF_N = 512          # (b): the fused grid, 8 m a side
CLI_TSDF_SIZE = 8.0
CLI_HELD_N = 128          # (b): card against CPU on the first frames
CLI_HELD_FRAMES = 10
CLI_FLIP_SHARE = 1e-4     # (b): weights may differ on this share of voxels
CLI_TSDF_HELD = 1e-5      # (b): tsdf, card vs CPU, where both updated
CLI_ROOM_SHARE = 0.99     # (b): vertices within 2 voxels of a face of the room
CLI_SLAM_HELD = 1e-6      # (a), (d): CLI and service against in-process runs, m
CLI_VIO_FRAMES = 2000     # (e): the rescue phase's scenario
# (a)'s JAX reference: the JAX package's OnlineSlam (float64, CPU, JAX
# 0.9.0) on the same decoded .gsf frames, ``global_loop_k=2``:
#     JAX_PLATFORMS=cpu python3 frontend_reference_ate.py --frames 300 \
#         --path 1000 --gsf DIR
# (100 s on a CPU), which printed these statuses, one letter a frame
CLI_JAX = {"frames": 300, "keyframes": 150, "ate_m": 0.0005764502266528189,
           "lookback_edges": 725, "global_edges": 290,
           "statuses": "F" + "SK" * 149 + "S"}
# the online phase's in-process flagship on the same scenario (PERF.md):
# rescues, plane factors, landmarks, ATE mm
CLI_IN_PROCESS = {"rescues": 19, "plane_factors": 74, "landmarks": 38,
                  "ate_mm": 1.6518}


def _cli(*argv):
    """``graph_slam_tpu_torch.cli.main(argv)`` in this process (the function
    ``python -m graph_slam_tpu_torch`` calls), the card synchronised at both
    ends: (its standard output, seconds)."""
    import io

    import torch

    from graph_slam_tpu_torch import cli

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    torch.cuda.synchronize()
    _require(rc in (None, 0), f"{argv[0]} returned {rc}")
    return buf.getvalue(), time.perf_counter() - t0


@contextlib.contextmanager
def _captured(owner, name):
    """Record what ``owner.name`` returns while the block runs (the same
    calls, only observed)."""
    seen = []
    plain = getattr(owner, name)

    def observed(*args, **kw):
        out = plain(*args, **kw)
        seen.append(out)
        return out

    setattr(owner, name, observed)
    try:
        yield seen
    finally:
        setattr(owner, name, plain)


def _room_share(verts, voxel, tol_voxels=2):
    """Share of mesh vertices within ``tol_voxels`` voxels of a face of the
    box room (``frontend_reference_ate.ROOM``), and their median distance.
    The mesh is in the SLAM session's frame, whose origin is the first
    camera pose of the path."""
    import numpy as np

    import frontend_reference_ate as fra

    R, t = fra.room_path(FRONTEND_HARRIS_FRAMES)
    verts = verts @ R[0].T + t[0]
    d = np.full(len(verts), np.inf)
    for axis, (lo, hi) in enumerate(fra.ROOM):
        d = np.minimum(d, np.minimum(np.abs(verts[:, axis] - lo),
                                     np.abs(verts[:, axis] - hi)))
    return float((d <= tol_voxels * voxel).mean()), float(np.median(d))


def _cli_slam(tmp, out):
    """(a): ``slam`` over a .gsf store of the Harris path's first frames,
    against ``OnlineSlam`` fed the decoded frames in this process, against
    the JAX package's run of them, and ``evaluate``. Returns (frames dir,
    trajectory log, the decoded frames' statuses)."""
    import numpy as np
    import torch

    import frontend_reference_ate as fra
    from graph_slam_tpu_torch.config import RS435, SlamParams
    from graph_slam_tpu_torch.core import so3
    from graph_slam_tpu_torch.io import (FrameStore, read_trajectory,
                                         write_trajectory)
    from graph_slam_tpu_torch.pipelines import OnlineSlam

    frames_dir = os.path.join(tmp, "frames")
    a = out["a_slam"] = {"frames": CLI_FRAMES}
    a["write_gsf_s"] = fra.write_gsf(RS435, CLI_FRAMES, frames_dir,
                                     path=FRONTEND_HARRIS_FRAMES,
                                     device="cuda")
    a["gsf_mb"] = sum(os.path.getsize(os.path.join(frames_dir, f))
                      for f in os.listdir(frames_dir)) / 1e6
    slam_dir = os.path.join(tmp, "slam")
    with _captured(OnlineSlam, "process_frame") as seen:
        stdout, a["cli_s"] = _cli("slam", "--camera", "rs435",
                                  "--global-loop-k", "2", "--frames",
                                  frames_dir, "--out-dir", slam_dir)
    statuses = "".join(fra.STATUS_LETTER[s] for s in seen)
    a["stdout"] = stdout.splitlines()[:2]
    traj_path = os.path.join(slam_dir, "trajectory.log")
    traj = read_trajectory(traj_path)

    store = FrameStore(frames_dir)
    slam = OnlineSlam(cam=RS435, params=SlamParams(), global_loop_k=2)
    ref = "".join(fra.STATUS_LETTER[slam.process_frame(*store(k), seq_id=k)]
                  for k in range(CLI_FRAMES))
    slam.optimize()
    _, t, q, seqs = slam.trajectory()
    same_shape = traj.t.shape == t.shape
    a["statuses_equal_in_process"] = statuses == ref
    a["max_abs_m_in_process"] = float(np.abs(traj.t - t).max()) \
        if same_shape else float("inf")
    _require(a["statuses_equal_in_process"] and same_shape
             and bool((traj.seq == seqs).all()),
             "slam: the CLI's statuses or keyframes differ from the "
             "in-process run's")
    _require(a["max_abs_m_in_process"] <= CLI_SLAM_HELD,
             f"slam: CLI vs in-process {a['max_abs_m_in_process']:.3g} m")

    gt_R, gt_t = fra.room_path(FRONTEND_HARRIS_FRAMES)
    ate = fra.ate(traj.t, gt_t[traj.seq])
    same = sum(x == y for x, y in zip(statuses, CLI_JAX["statuses"]))
    a.update(keyframes=len(traj.seq), failed=statuses.count("X"), ate_m=ate,
             jax_keyframes=CLI_JAX["keyframes"], jax_ate_m=CLI_JAX["ate_m"],
             ate_diff_m=ate - CLI_JAX["ate_m"],
             status_share_as_jax=same / len(CLI_JAX["statuses"]))
    _require(len(statuses) == CLI_JAX["frames"]
             and a["status_share_as_jax"] >= FRONTEND_STATUS_SHARE,
             f"slam: statuses as JAX's on {a['status_share_as_jax']:.4f}")
    _require(abs(len(traj.seq) - CLI_JAX["keyframes"])
             <= FRONTEND_KEYFRAMES_REL * CLI_JAX["keyframes"],
             f"slam: {len(traj.seq)} keyframes vs JAX's "
             f"{CLI_JAX['keyframes']}")
    _require(abs(ate - CLI_JAX["ate_m"]) <= FRONTEND_ATE_REL
             * CLI_JAX["ate_m"], f"slam: ATE {ate * 1e3:.4f} mm vs "
             f"JAX's {CLI_JAX['ate_m'] * 1e3:.4f} mm")

    gt_path = os.path.join(tmp, "gt.log")
    qg = so3.matrix_to_quat(torch.as_tensor(gt_R[traj.seq])).numpy()
    write_trajectory(gt_path, np.arange(len(traj.seq)), gt_t[traj.seq], qg,
                     traj.seq)
    ev_json = os.path.join(tmp, "evaluate.json")
    ev_out, a["evaluate_s"] = _cli("evaluate", "--est", traj_path, "--gt",
                                   gt_path, "--json", ev_json)
    a["evaluate_ate_m"] = json.load(open(ev_json))["ate"]["rmse"]
    _require(f"ATE  rmse {ate:.6f} m" in ev_out
             and abs(a["evaluate_ate_m"] - ate) <= 1e-9 * ate,
             f"evaluate: ATE {a['evaluate_ate_m']} vs the smoke's {ate}")
    return frames_dir, traj_path, statuses


def _cli_tsdf(tmp, out, frames_dir, traj_path):
    """(b): ``tsdf --n 512 --size 8`` over (a), the mesh against the room
    and against the plain numpy extraction of the same volume, the
    integration's time beside its bound, and card against CPU at 128^3."""
    import numpy as np
    import torch

    import graph_slam_tpu_torch.mapping as mapping
    from graph_slam_tpu_torch.config import RS435
    from graph_slam_tpu_torch.io import FrameStore, Trajectory, read_trajectory
    from graph_slam_tpu_torch.mapping import tsdf

    b = out["b_tsdf"] = {"n": CLI_TSDF_N, "size_m": CLI_TSDF_SIZE}
    mesh_path = os.path.join(tmp, "mesh.ply")
    torch.cuda.reset_peak_memory_stats()
    with _captured(mapping, "fuse_trajectory") as vols, \
            _captured(mapping, "extract_mesh") as meshes:
        stdout, b["cli_s"] = _cli(
            "tsdf", "--traj", traj_path, "--frames", frames_dir, "--out",
            mesh_path, "--n", str(CLI_TSDF_N), "--size", str(CLI_TSDF_SIZE),
            "--camera", "rs435")
    b["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    b["stdout"] = stdout.strip()
    vol, (V, F) = vols[0], meshes[0]
    traj = read_trajectory(traj_path)
    b["integrations"] = len(traj.seq)
    voxel = float(vol.voxel)
    b["vertices"], b["faces"] = len(V), len(F)
    b["room_share"], b["median_face_distance_m"] = _room_share(V, voxel)
    _require(len(F) > 0, "tsdf: empty mesh")
    _require(b["room_share"] >= CLI_ROOM_SHARE,
             f"tsdf: {b['room_share']:.4f} of the vertices within 2 voxels "
             "of the room")
    _require(vol.tsdf.device.type == "cuda", "tsdf: the grid is not on the "
             "card")

    # the device-side extraction against the plain numpy one
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    V2, F2 = tsdf.extract_mesh(vol)
    b["extract_ms"] = (time.perf_counter() - t0) * 1e3
    host = [x.cpu().numpy() for x in vol]
    t0 = time.perf_counter()
    Vn, Fn = tsdf.extract_mesh_numpy(*host)
    b["extract_numpy_ms"] = (time.perf_counter() - t0) * 1e3
    b["extract_bit_equal"] = bool(np.array_equal(V, Vn)
                                  and np.array_equal(F, Fn)
                                  and np.array_equal(V2, Vn))
    _require(b["extract_bit_equal"], "tsdf: the device extraction differs "
             "from the numpy one")
    del host

    # ms an integration, warm, on the 512^3 grid: CUDA events around 10
    store = FrameStore(frames_dir)
    depth = torch.as_tensor(store(0)[1], device="cuda")
    R = torch.eye(3, dtype=torch.float64, device="cuda")
    t = torch.as_tensor(traj.t[0], device="cuda")
    tsdf.integrate(vol, RS435, depth, R, t)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(10):
        tsdf.integrate(vol, RS435, depth, R, t)
    ev[1].record()
    ev[1].synchronize()
    b["integrate_ms"] = ev[0].elapsed_time(ev[1]) / 10
    b["integrate_bound_ms"] = 4 * CLI_TSDF_N ** 3 * 4 / HBM_BYTES_PER_S * 1e3
    b["integrate_bound_by"] = "bytes"
    del vol

    # card against CPU on the first frames at 128^3
    head = Trajectory(*(x[:CLI_HELD_FRAMES] for x in
                        (traj.ids, traj.t, traj.quat, traj.seq)))
    origin = traj.t.mean(0) - CLI_TSDF_SIZE / 2.0
    card = mapping.fuse_trajectory(head, store, RS435, origin, CLI_TSDF_SIZE,
                                   n=CLI_HELD_N)
    t0 = time.perf_counter()
    cpu = mapping.fuse_trajectory(head, store, RS435, origin, CLI_TSDF_SIZE,
                                  n=CLI_HELD_N, device="cpu")
    b["cpu_fuse_s"] = time.perf_counter() - t0
    wc, wp = card.weight.cpu(), cpu.weight
    both = (wc > 0) & (wc == wp)
    b["held"] = {"n": CLI_HELD_N, "frames": CLI_HELD_FRAMES,
                 "flipped_voxels": int((wc != wp).sum()),
                 "updated_voxels": int((wp > 0).sum()),
                 "tsdf_max_abs": float((card.tsdf.cpu() - cpu.tsdf)[both]
                                       .abs().max())}
    _require(b["held"]["flipped_voxels"] <= CLI_FLIP_SHARE * wp.numel(),
             f"tsdf: {b['held']['flipped_voxels']} voxels flipped card vs "
             "CPU")
    _require(b["held"]["tsdf_max_abs"] <= CLI_TSDF_HELD,
             f"tsdf: card vs CPU {b['held']['tsdf_max_abs']:.3g}")


def _cli_maps(tmp, out, frames_dir, traj_path):
    """(c): ``map`` (defaults, ``--voxel 0.02``), ``filter`` and ``mesh`` of
    its PCD, ``video --every 50`` over (a)'s first 100 poses."""
    import numpy as np

    from graph_slam_tpu_torch.config import RS435
    from graph_slam_tpu_torch.io import (FrameStore, read_trajectory,
                                         write_trajectory)
    from graph_slam_tpu_torch.mapping import (accumulate_cloud, read_pcd,
                                              voxel_filter)

    c = out["c_maps"] = {}
    pcd = os.path.join(tmp, "map.pcd")
    _, c["map_s"] = _cli("map", "--traj", traj_path, "--frames", frames_dir,
                         "--out", pcd, "--camera", "rs435", "--voxel", "0.02")
    pts, cols = read_pcd(pcd)
    traj = read_trajectory(traj_path)
    want, want_c = voxel_filter(*accumulate_cloud(
        traj, FrameStore(frames_dir), RS435, stride=7, skip=2), voxel=0.02)
    c["points"] = len(pts)
    _require(len(pts) > 0 and np.array_equal(pts.astype(np.float32),
                                             want.astype(np.float32))
             and np.array_equal(cols, want_c),
             "map: the PCD read back differs from the cloud written")
    filt = os.path.join(tmp, "filtered.pcd")
    _, c["filter_s"] = _cli("filter", "--pcd", pcd, "--out", filt)
    c["filtered_points"] = len(read_pcd(filt)[0])
    mesh_out, c["mesh_s"] = _cli("mesh", "--pcd", pcd, "--out",
                                 os.path.join(tmp, "map_mesh.ply"))
    c["mesh_faces"] = int(mesh_out.split(" faces")[0].split()[-1])
    _require(c["filtered_points"] > 0 and c["mesh_faces"] > 0,
             "filter or mesh: nothing left")
    head = os.path.join(tmp, "traj100.log")
    write_trajectory(head, traj.ids[:100], traj.t[:100], traj.quat[:100],
                     traj.seq[:100])
    snaps = os.path.join(tmp, "snaps")
    _, c["video_s"] = _cli("video", "--traj", head, "--frames", frames_dir,
                           "--out-dir", snaps, "--every", "50", "--camera",
                           "rs435")
    c["snapshots"] = sorted(f for f in os.listdir(snaps)
                            if f.endswith(".ply"))
    _require(len(c["snapshots"]) == len(range(0, min(100, len(traj.seq)),
                                              50)) + 1,
             f"video: {len(c['snapshots'])} snapshots")


def _cli_serve(out, frames_dir, statuses):
    """(d): ``serve --port 0`` in a thread of this process on the card, its
    (a) frames streamed over loopback as .gsf bytes, against (a)'s statuses
    and an in-process session with the service's settings."""
    import io
    import threading

    import numpy as np

    import frontend_reference_ate as fra
    from graph_slam_tpu_torch import cli
    from graph_slam_tpu_torch.config import RS435, SlamParams
    from graph_slam_tpu_torch.io import FrameStore
    from graph_slam_tpu_torch.pipelines import OnlineSlam
    from graph_slam_tpu_torch.serving import SlamClient, recv_msg, send_msg

    d = out["d_serve"] = {"frames": CLI_FRAMES}
    store = FrameStore(frames_dir)
    blobs = [open(store.path(k), "rb").read() for k in range(CLI_FRAMES)]
    buf = io.StringIO()
    errors = []

    def serve():
        try:
            cli.main(["serve", "--camera", "rs435", "--port", "0"])
        except BaseException as e:        # reported by the main thread
            errors.append(e)

    with contextlib.redirect_stdout(buf):
        th = threading.Thread(target=serve, daemon=True)
        th.start()
        deadline = time.perf_counter() + 120
        while "SLAM service on" not in buf.getvalue():
            _require(time.perf_counter() < deadline and not errors,
                     f"serve did not come up: {errors}")
            time.sleep(0.05)
        port = int(buf.getvalue().split("SLAM service on ")[1]
                   .split(" ")[0].rsplit(":", 1)[1])
        client = SlamClient("127.0.0.1", port, timeout=600.0)
        t0 = time.perf_counter()
        replies = []
        for k, blob in enumerate(blobs):
            send_msg(client.sock, {"type": "frame", "seq": k}, blob)
            replies.append(recv_msg(client.sock)[0])
        d["frames_per_s"] = CLI_FRAMES / (time.perf_counter() - t0)
        summary = client.finish()
        th.join(timeout=120)
    _require(not th.is_alive() and not errors, f"serve: {errors}")
    got = "".join(fra.STATUS_LETTER.get(r.get("status"), "?")
                  for r in replies)
    _require(all(r["type"] == "pose" and r["seq"] == k
                 for k, r in enumerate(replies)),
             "serve: a reply is missing or not a pose")
    slam = OnlineSlam(cam=RS435, params=SlamParams(optimize_step=10),
                      features="harris")
    ref = "".join(fra.STATUS_LETTER[slam.process_frame(*store(k), seq_id=k)]
                  for k in range(CLI_FRAMES))
    slam.optimize()
    _, t, _, seqs = slam.trajectory()
    st = np.asarray(summary["t"])
    d.update(keyframes=summary["keyframes"], statuses_equal_slam=got ==
             statuses, statuses_equal_in_process=got == ref,
             max_abs_m_in_process=float(np.abs(st - t).max())
             if st.shape == t.shape else float("inf"))
    _require(got == statuses == ref, "serve: statuses differ from (a)'s or "
             "the in-process session's")
    _require(list(summary["seq"]) == list(seqs)
             and d["max_abs_m_in_process"] <= CLI_SLAM_HELD,
             f"serve: trajectory {d['max_abs_m_in_process']:.3g} m from the "
             "in-process session")


def _cli_vio(tmp, out):
    """(e): ``vio --frames --plane-mode rescue`` on the rescue phase's
    scenario written to files, held to the rescue phase's gates; returns
    its region-grow launches."""
    import numpy as np

    import graph_slam_tpu_torch.pipelines.vio as vio_module
    from graph_slam_tpu_torch.datasets import make_vio_plane_scenario
    from graph_slam_tpu_torch.io import FrameStore, write_vro_log
    from graph_slam_tpu_torch.planes.region_grow import region_grow

    e = out["e_vio"] = {"frames": CLI_VIO_FRAMES,
                        "in_process": CLI_IN_PROCESS}
    t0 = time.perf_counter()
    scenario = make_vio_plane_scenario(n_frames=CLI_VIO_FRAMES,
                                       fail_every=100, render="lazy",
                                       return_gt=True)
    log, times, stream, _, frames, _, _ = scenario
    vro = os.path.join(tmp, "vro.log")
    write_vro_log(vro, log)
    imu = os.path.join(tmp, "imu_vn100.log")
    np.savetxt(imu, np.column_stack([np.asarray(stream.t),
                                     np.asarray(stream.acc),
                                     np.asarray(stream.gyr),
                                     np.zeros((len(stream.t), 3))]),
               fmt="%.17g")
    times_path = os.path.join(tmp, "times.log")
    with open(times_path, "w") as f:
        f.writelines(f"{s} {t!r}\n" for s, t in sorted(times.items()))
    store = FrameStore(os.path.join(tmp, "sr4000"))
    for k in range(CLI_VIO_FRAMES):
        store.save(k, *frames(k))
    cfg = os.path.join(tmp, "online_flagship.json")
    with open(cfg, "w") as f:
        json.dump({"vio": {k: v for k, v in ONLINE_CFG.items()
                           if k != "plane_mode"} | {"final_batch": False}},
                  f)
    e["write_s"] = time.perf_counter() - t0
    before = region_grow.launches
    with _captured(vio_module, "run_vio") as runs:
        stdout, e["cli_s"] = _cli(
            "vio", "--vro", vro, "--imu", imu, "--times", times_path,
            "--frames", store.dir, "--plane-mode", "rescue", "--camera",
            "sr4000", "--extrinsic", "identity", "--config", cfg,
            "--out-dir", os.path.join(tmp, "vio"))
    launches = region_grow.launches - before
    e["stdout"] = stdout.strip().splitlines()
    chk = _rescue_checks(runs[0], scenario, "cli vio")
    e.update({k: chk[k] for k in ("rescue_steps", "predictions",
                                  "n_plane_factors", "landmarks", "ate_mm",
                                  "ate_over_path")},
             launches=launches, frames_per_s=CLI_VIO_FRAMES / e["cli_s"])
    _require(chk["ate_over_path"] <= RESCUE_ATE_PATH,
             f"vio: ATE {chk['ate_over_path']:.4%} of the path")
    _require(launches == chk["predictions"] > 0,
             f"vio: region_grow launched {launches} times for "
             f"{chk['predictions']} predictions")
    return launches


def _cli_module(tmp, out):
    """(f): one ``python -m graph_slam_tpu_torch posegraph`` subprocess on
    the card against the golden chi2; ``presets``; the native runtime."""
    import sys as _sys

    from graph_slam_tpu_torch import native

    f = out["f_module"] = {}
    pins = json.load(open(os.path.join(GOLDEN, "chi2.json")))
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_sys.executable, "-m", "graph_slam_tpu_torch", "posegraph", "--vro",
         os.path.join(GOLDEN, "posegraph_vro.log"), "--out-dir",
         os.path.join(tmp, "posegraph")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    f["posegraph_s"] = time.perf_counter() - t0
    _require(proc.returncode == 0, f"python -m graph_slam_tpu_torch "
             f"posegraph: {proc.stderr[-800:]}")
    line = next(x for x in proc.stdout.splitlines() if x.startswith("chi2:"))
    f["posegraph_stdout"] = line
    f["chi2"] = float(line.split("-> ")[1].split(" ")[0])
    f["chi2_pin"] = pins["vro_error"]
    _require(abs(f["chi2"] - pins["vro_error"]) <= 1e-6,
             f"posegraph: chi2 {f['chi2']} vs the pin {pins['vro_error']}")
    presets, _ = _cli("presets")
    f["presets"] = len(presets.splitlines())
    f["native_available"] = native.available()
    _require(f["presets"] == 26 and f["native_available"],
             f"{f['presets']} presets, native {f['native_available']}")


def phase_cli(smi):
    """The command line on the card: ``graph_slam_tpu_torch.cli.main`` in
    this process (and one ``python -m`` subprocess) from a 640 x 480 .gsf
    store to a trajectory, a point-cloud map, a 512^3 TSDF mesh, the SLAM
    service, the VIO rescue and the golden pose graph. Returns the
    region-grow launches of its ``vio`` run."""
    out = {"phase": "cli", "card": smi}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        frames_dir, traj_path, statuses = _cli_slam(tmp, out)
        _cli_tsdf(tmp, out, frames_dir, traj_path)
        _cli_maps(tmp, out, frames_dir, traj_path)
        _cli_serve(out, frames_dir, statuses)
        launches = _cli_vio(tmp, out)
        _cli_module(tmp, out)
    out["seconds"] = time.perf_counter() - t0
    _emit(out)
    return launches


def _multichip_r05():
    """config -> (chi2_0, chi2) of the JAX package's dry run in
    ``MULTICHIP_r05.json`` (8 virtual CPU devices): accuracy figures to
    print beside the port's; its wall times are no target."""
    with open(os.path.join(ROOT, "MULTICHIP_r05.json")) as f:
        tail = json.load(f)["tail"]
    rows = [json.loads(x) for x in tail.splitlines() if x.startswith("{")]
    return {r["config"]: (r["chi2_0"], r["chi2"]) for r in rows}


def _held(a, b, tol, what):
    """Every array of two results (nested tuples of arrays and numbers)
    within ``tol`` (the chi2 and other scalars relative); the largest
    gap."""
    import numpy as np

    def leaves(x):
        if isinstance(x, (tuple, list)):
            return [y for v in x for y in leaves(v)]
        return [np.asarray(x, dtype=np.float64)]

    worst = 0.0
    for x, y in zip(leaves(a), leaves(b), strict=True):
        gap = float(np.abs(x - y).max()) if x.size else 0.0
        if x.ndim == 0:
            gap /= max(abs(float(y)), 1e-300)
        _require(gap <= tol, f"{what}: {gap} > {tol}")
        worst = max(worst, gap)
    return worst


def phase_sharded(smi):
    """Multi-device solving on the card (``graph_slam_tpu_torch.parallel``,
    one process a rank). (a) the dry run on 4 gloo ranks sharing the card;
    (b) one NCCL rank: sphere2500 PCG-50 against ``gn_optimize``; (c) the
    48-pose dense GN and the 121-landmark square-root BA (float64) on 4
    gloo ranks on the card against 4 on the CPU, every rank bit-equal to
    rank 0; (d) ``g2o --sharded 1`` through ``cli.main``; (e) the dry run
    over NCCL on distinct cards where there are two or more. Gloo on one
    card reduces through host memory: its times measure no interconnect."""
    import torch

    from graph_slam_tpu_torch.datasets import (make_ba_graph,
                                               make_sphere_graph)
    from graph_slam_tpu_torch.graph import gn_optimize, total_error
    from graph_slam_tpu_torch.parallel import (launch, sharded_ba_sqrt,
                                               sharded_gn)
    from graph_slam_tpu_torch.parallel.dryrun import dryrun_multichip
    from graph_slam_tpu_torch.parallel.launch import run_calls

    out = {"phase": "sharded", "card": smi,
           "cards": torch.cuda.device_count()}
    t_phase = time.perf_counter()
    ref = _multichip_r05()

    # (a) the dry run, 4 gloo ranks on one card
    t0 = time.perf_counter()
    rows = dryrun_multichip(4, backend="gloo")
    out["a_dryrun_s"] = time.perf_counter() - t0
    for row in rows:
        name = row["config"]
        if name.startswith("fleet-"):
            name = "fleet-16x60-pose-dp"        # its run had 8 devices
        row["multichip_r05"] = {"config": name, "chi2_0": ref[name][0],
                                "chi2": ref[name][1]} if name in ref else None
    out["a_dryrun"] = rows

    # (b) one NCCL rank on the card: sphere2500, PCG-50, 8 iterations
    g, v, _ = make_sphere_graph(n_poses=2500, edges_per_pose=4.0, seed=0,
                                dtype=torch.float32, bucket=256)
    e0 = float(total_error(g, v))
    t0 = time.perf_counter()
    vals, err = launch(1, sharded_gn, g, v, iterations=8, damping=1e-6,
                       solver="pcg", pcg_iters=50)[0]
    b = out["b_nccl_1rank"] = {"s": time.perf_counter() - t0,
                               "chi2_0": e0, "chi2": float(err)}
    res = gn_optimize(g, v, iterations=8, solver="pcg", pcg_iters=50,
                      damping=1e-6)
    b["gn_optimize_chi2"] = float(res.error)
    b["rel"] = abs(b["chi2"] - b["gn_optimize_chi2"]) / b["gn_optimize_chi2"]
    _require(b["chi2"] < 1e-2 * e0 and b["rel"] <= 5e-2,
             f"1-rank NCCL sphere2500: {b}")

    # (c) float64, 4 gloo ranks on the card against 4 on the CPU
    gs, vs, _ = make_sphere_graph(n_poses=48, edges_per_pose=3.0, seed=0,
                                  dtype=torch.float64, bucket=16,
                                  device="cpu")
    gb, vb, _ = make_ba_graph(n_poses=8, n_points=121, obs_per_point=3,
                              seed=4, dtype=torch.float64, bucket=1,
                              device="cpu")
    calls = [(sharded_gn, (gs, vs), dict(iterations=6, damping=1e-4,
                                         solver="dense")),
             (sharded_ba_sqrt, (gb, vb), dict(iterations=6, damping=1e-3,
                                              chunk=16))]
    t0 = time.perf_counter()
    card = launch(4, run_calls, calls, backend="gloo")
    c = out["c_card_vs_cpu"] = {"card_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    cpu = launch(4, run_calls, calls, device="cpu")
    c["cpu_s"] = time.perf_counter() - t0
    for r in range(1, 4):
        _held(card[r], card[0], 0.0, f"card rank {r} against rank 0")
    c["dense_gap"] = _held(card[0][0], cpu[0][0], 1e-9,
                           "dense GN card vs CPU")
    c["ba_sqrt_gap"] = _held(card[0][1], cpu[0][1], 1e-9,
                             "square-root BA card vs CPU")
    c["chi2"] = [float(card[0][0][1]), float(card[0][1][1])]

    # (d) the command line, one rank on the card
    pins = json.load(open(os.path.join(GOLDEN, "chi2.json")))
    with tempfile.TemporaryDirectory() as tmp:
        stdout, secs = _cli("g2o", "--input",
                            os.path.join(GOLDEN, "sphere200_noisy.g2o"),
                            "--out-dir", tmp, "--sharded", "1", "--iters",
                            "15")
    line = next(x for x in stdout.splitlines() if x.startswith("chi2:"))
    d = out["d_cli"] = {"s": secs, "stdout": line,
                        "chi2": float(line.split("-> ")[1].split(" ")[0]),
                        "pin": pins["g2o_error"]}
    _require("over 1 devices" in line
             and abs(d["chi2"] - d["pin"]) <= 1e-3 * d["pin"],
             f"g2o --sharded 1: {line} against the pin {d['pin']}")

    # (e) NCCL over distinct cards, where the machine has them
    if out["cards"] >= 2:
        t0 = time.perf_counter()
        out["e_nccl_dryrun"] = dryrun_multichip(min(4, out["cards"]))
        out["e_s"] = time.perf_counter() - t0
    else:
        out["e_nccl_dryrun"] = "not run: one card"
    out["seconds"] = time.perf_counter() - t_phase
    _emit(out)


def phase_profiles(vio_job, rescue_job, online_job, ba_job, frontend_job):
    """The VIO, rescue and online prefix replays and one GN iteration of
    ``ba_sqrt_100k`` again under the profiler, after every timed run of
    the script: a profiler session leaves the process slower to launch
    kernels, so nothing is timed after one. Returns the region-grow
    launches of the rescue's and the online engine's profiled replays,
    each held to its predictions."""
    from graph_slam_tpu_torch.planes.region_grow import region_grow

    region_grow.launches = 0
    out = {"phase": "profile", "vio": _profile_replay(*vio_job)}
    _require(region_grow.launches == 0, "the VIO path launched region_grow")
    out["ba"] = _profile_ba(ba_job)
    _require(region_grow.launches == 0, "the BA path launched region_grow")
    out["frontend"] = _profile_frontend(frontend_job)
    _require(region_grow.launches == 0,
             "the frontend path launched region_grow")
    launches = {}
    for name, job, replay in (("rescue", rescue_job, _rescue_replay),
                              ("online", online_job, _online_flagship)):
        region_grow.launches = 0
        out[name] = _profile_replay(*job, replay)
        launches[name] = region_grow.launches
        _require(launches[name] == out[name]["predictions"] >= 1,
                 f"the {name} profile launched region_grow "
                 f"{launches[name]} times for {out[name]['predictions']} "
                 "predictions")
    _emit(out)
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vio-frames", type=int, default=2000,
                    help="frames of the VIO scan replay (default 2000)")
    ap.add_argument("--rescue-frames", type=int, default=2000,
                    help="frames of the plane-rescue replay (default 2000; "
                         "27000 is the JAX bench's vio_planes_27k)")
    ap.add_argument("--online-frames", type=int, default=2000,
                    help="frames of the online engine's rescue replay "
                         "(default 2000)")
    args = ap.parse_args(argv)
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
    pcg = phase_pcg()
    launches = region_grow.launches
    region_grow.launches = 0
    phase_posegraph(pcg)
    ba_job = phase_ba()
    ba_launches = region_grow.launches
    _require(ba_launches == 0, "the ba phase launched region_grow")
    region_grow.launches = launches
    phase_planes()
    launches = region_grow.launches
    _require(launches > 0, "the main path never launched region_grow")
    region_grow.launches = 0
    _, vio_job = phase_vio(args.vio_frames)
    _require(region_grow.launches == 0, "the VIO path launched region_grow")
    region_grow.launches = 0
    rescue, predictions, rescue_args, rescue_job = phase_rescue(
        args.rescue_frames)
    rescue_launches = region_grow.launches
    _require(rescue_launches > 0 and rescue_launches == predictions,
             f"the rescue launched region_grow {rescue_launches} times for "
             f"{predictions} predictions on the card")
    scan_counts = (rescue["f64"]["n_plane_factors"],
                   rescue["f64"]["landmarks"]) \
        if args.online_frames == args.rescue_frames else None
    region_grow.launches = 0
    _, predictions, online_job = phase_online(args.online_frames,
                                              scan_counts)
    online_launches = region_grow.launches
    _require(online_launches > 0 and online_launches == predictions,
             f"the online engine launched region_grow {online_launches} "
             f"times for {predictions} predictions on the card")
    region_grow.launches = 0
    _, frontend_job = phase_frontend(smi)
    frontend_launches = region_grow.launches
    _require(frontend_launches == 0, "the frontend phase launched "
             f"region_grow {frontend_launches} times")
    region_grow.launches = 0
    cli_launches = phase_cli(smi)
    _require(region_grow.launches == cli_launches > 0,
             f"the cli phase launched region_grow {region_grow.launches} "
             f"times, its vio run {cli_launches}")
    # the phase's work runs in the ranks that ``launch`` spawns: each rank
    # sends back its own count, which ``launch`` adds up
    from graph_slam_tpu_torch.parallel import launch as launch_ranks

    region_grow.launches = 0
    launch_ranks.region_grow_launches = 0
    phase_sharded(smi)
    sharded_launches = (region_grow.launches
                        + launch_ranks.region_grow_launches)
    _require(sharded_launches == 0, "the sharded phase launched "
             f"region_grow {sharded_launches} times (its ranks "
             f"{launch_ranks.region_grow_launches})")
    profiled = phase_profiles(vio_job, rescue_job, online_job, ba_job,
                              frontend_job)
    rescue_launches += profiled["rescue"]
    online_launches += profiled["online"]
    phase_frames()
    rescue_timing = grow_row(*rescue_args)

    _emit({"kernels": [{
        "name": "region_grow", "route": "cuda",
        "source": "graph_slam_tpu_torch/csrc/region_grow.cu",
        "replaces": "graph_slam_tpu/planes/pallas_grow.py:78",
        "launches": launches + rescue_launches + online_launches
        + cli_launches + sharded_launches,
        "launches_by_path": {"posegraph": 0, "ba": ba_launches,
                             "planes": launches, "rescue": rescue_launches,
                             "online": online_launches,
                             "frontend": frontend_launches,
                             "cli": cli_launches,
                             "sharded": sharded_launches},
        "max_abs_err": max(timing["mismatches"],
                           rescue_timing["mismatches"]),
        "shape": timing["shape"], "ms": timing["device_us"] / 1e3,
        "call_ms": timing["us"] / 1e3,
        "plain_ms": timing["plain_us"] / 1e3,
        "bound_ms": timing["bound_us"] / 1e3, "bound_by": timing["bound_by"],
        "library_ms": None, "rescue_shape": rescue_timing}]})
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
