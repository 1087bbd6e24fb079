"""The multi-device dry run (port of ``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n)`` starts ``n`` ranks (``launch``) and runs on them the
JAX package's four configurations through the sharded solvers, plus the
small dense-H step:

- ``sphere2500-pcg``: 2,500 poses, ~10k edges, 8 GN iterations of the
  matrix-free factor-sharded PCG-50, float32;
- ``ba-sqrt-schur``: 16 poses x 480 landmarks, 6 landmark-sharded
  square-root Schur steps, chunk 64, float32;
- ``vio-window-12f-imu-plane-vo``: a 12-frame window of IMU, plane and
  between factors with pose, velocity and bias priors, PCG-60;
- ``fleet-{2n}x60-pose-dp``: 2n graphs of 60 poses, the batch axis over
  the ranks (``sharded_gn_many``);
- ``sphere32-dense-step``: one dense-H GN step on a 32-pose sphere.

Each configuration must meet the reference's convergence bar (chi2 below
1e-2, 1e-2, 0.5 and 0.1 of its start; the dense step below its start), and
every rank must return rank 0's chi2 bit for bit. One JSON line a
configuration, with the reference's keys (``n_devices``, ``config``,
``chi2_0``, ``chi2``, ``gn_iters``, ``wall_s``) and ``backend``, ``device``,
the reductions a GN iteration made (``allreduce_calls``,
``allreduce_bytes``) and the mean milliseconds of one reduction of the
configuration's per-iteration vector, timed alone (``allreduce_ms``).
``wall_s`` is rank 0's, from the first to the last step of the solve, the
device synchronised; it includes no start-up.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from .launch import launch

__all__ = ["dryrun_multichip"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _allreduce_ms(mesh, numel, dtype, reps=50):
    """Mean ms of one ``all_reduce`` of ``numel`` values (after a warm-up)."""
    x = torch.ones(numel, dtype=dtype, device=mesh.device)
    calls, nbytes = mesh.calls, mesh.bytes
    mesh.all_reduce(x)
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        mesh.all_reduce(x)
    _sync(mesh.device)
    ms = (time.perf_counter() - t0) * 1e3 / reps
    mesh.calls, mesh.bytes = calls, nbytes     # not the solve's reductions
    return ms


def _solve_row(mesh, config, e0, fn, iters, vec_numel, dtype):
    """Time ``fn() -> (values, chi2)`` on this rank and count its
    reductions; one result row."""
    calls, nbytes = mesh.calls, mesh.bytes
    _sync(mesh.device)
    t0 = time.perf_counter()
    values, err = fn()
    _sync(mesh.device)
    wall = time.perf_counter() - t0
    return values, {
        "n_devices": mesh.size, "config": config, "chi2_0": float(e0),
        "chi2": float(err), "gn_iters": iters, "wall_s": wall,
        "backend": mesh.backend, "device": mesh.device.type,
        "allreduce_calls": (mesh.calls - calls) / iters,
        "allreduce_bytes": (mesh.bytes - nbytes) / iters,
        "allreduce_ms": _allreduce_ms(mesh, vec_numel, dtype)}


def _require(cond, msg):
    if not cond:
        raise RuntimeError(f"dry run check failed: {msg}")


def _vio_window(n_frames, device):
    """The reference's VIO window: IMU, between and plane factors with
    pose, velocity and bias priors (``__graft_entry__.py:169-216``)."""
    from ..graph import GraphBuilder
    from ..imu import init_preint, integrate_segment, vn100_params

    rng = np.random.default_rng(7)
    params = vn100_params(device=device)
    dt = 1.0 / 200.0
    per = 20
    gravity = params.gravity.cpu().numpy()
    acc = rng.normal(size=(n_frames * per, 3)) * 0.2 - gravity
    gyr = rng.normal(size=(n_frames * per, 3)) * 0.2

    def dev(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    b = GraphBuilder()
    for f in range(n_frames):
        b.add_pose((np.eye(3), np.zeros(3) + 0.01 * f))
        b.add_vel(np.zeros(3))
        b.add_bias(np.zeros(6))
    b.add_prior_pose(0, (np.eye(3), np.zeros(3)), sigmas=np.full(6, 1e-6))
    b.add_prior_vel(0, np.zeros(3), sigma=1e-3)
    b.add_prior_bias(0, np.zeros(6), sigma=1e-3)
    for f in range(1, n_frames):
        seg = slice((f - 1) * per, f * per)
        st = integrate_segment(
            init_preint(torch.zeros(6, dtype=torch.float64, device=device),
                        params, device=device),
            dev(acc[seg]), dev(gyr[seg]), dev(np.full(per, dt)), params)
        b.add_imu_factor(f - 1, f, st, gravity)
        b.add_between(f - 1, f,
                      (np.eye(3), np.zeros(3) + rng.normal(size=3) * 1e-3),
                      sigmas=np.full(6, 1e-2))
    planes_body = [np.array([0.0, 0.0, 1.0, -2.0]),
                   np.array([0.0, 1.0, 0.0, -1.5]),
                   np.array([1.0, 0.0, 0.0, -3.0])]
    for lp in planes_body:
        b.add_plane(lp)
    for f in range(n_frames):
        for li, lp in enumerate(planes_body):
            b.add_plane_factor(f, li, lp + rng.normal(size=4) * 1e-3,
                               sqrt_info=np.diag([1e2, 1e2, 1e2]))
    return b


def _dryrun_rank(mesh):
    """Every configuration on this rank; the rows of the solves."""
    from ..datasets import make_ba_graph, make_sphere_graph
    from ..graph import (sharded_gn_many, stack_pytrees, total_error,
                         used_slot_mask)
    from ..graph.variables import layout_of
    from .sharding import (pad_graph_for_mesh, sharded_ba_sqrt, sharded_gn,
                           sharded_gn_step)

    n, dev, f32 = mesh.size, mesh.device, torch.float32
    rows = []

    graph, values, _ = make_sphere_graph(n_poses=2500, edges_per_pose=4.0,
                                         seed=0, dtype=f32, bucket=256,
                                         device=dev)
    graph = pad_graph_for_mesh(graph, n)
    e0 = total_error(graph, values)
    D = used_slot_mask(values).shape[0]
    _, row = _solve_row(mesh, "sphere2500-pcg", e0, lambda: sharded_gn(
        mesh, graph, values, iterations=8, damping=1e-6, solver="pcg",
        pcg_iters=50), 8, D, f32)
    _require(row["chi2"] < 1e-2 * row["chi2_0"], "sharded PCG GN did not "
             f"converge on sphere2500: {row['chi2_0']} -> {row['chi2']}")
    rows.append(row)

    graph_b, values_b, _ = make_ba_graph(n_poses=16, n_points=480,
                                         obs_per_point=3, seed=0, dtype=f32,
                                         bucket=16, device=dev)
    e0 = total_error(graph_b, values_b)
    Dp = layout_of(values_b).point_off
    _, row = _solve_row(mesh, "ba-sqrt-schur", e0, lambda: sharded_ba_sqrt(
        mesh, graph_b, values_b, iterations=6, damping=1e-3, chunk=64), 6,
        Dp * Dp, torch.float64)
    _require(row["chi2"] < 1e-2 * row["chi2_0"], "sharded sqrt-Schur BA did "
             f"not converge: {row['chi2_0']} -> {row['chi2']}")
    rows.append(row)

    graph_v, values_v = _vio_window(12, dev).build(bucket=max(8, n),
                                                   device=dev)
    graph_v = pad_graph_for_mesh(graph_v, n)
    e0 = total_error(graph_v, values_v)
    D = used_slot_mask(values_v).shape[0]
    _, row = _solve_row(
        mesh, "vio-window-12f-imu-plane-vo", e0, lambda: sharded_gn(
            mesh, graph_v, values_v, iterations=8, damping=1e-4,
            solver="pcg", pcg_iters=60), 8, D, torch.float64)
    _require(row["chi2"] < 0.5 * row["chi2_0"], "sharded VIO-window GN did "
             f"not descend: {row['chi2_0']} -> {row['chi2']}")
    rows.append(row)

    fleet = [make_sphere_graph(n_poses=60, edges_per_pose=3.0, seed=s,
                               dtype=f32, bucket=16, device=dev)[:2]
             for s in range(2 * n)]
    gs = stack_pytrees([g for g, _ in fleet])
    vs = stack_pytrees([v for _, v in fleet])
    e0 = sum(total_error(g, v) for g, v in fleet)

    def fleet_solve():
        res = sharded_gn_many(mesh, gs, vs, iterations=6, solver="pcg",
                              damping=1e-3, pcg_iters=40)
        return res.values, res.error.sum()

    _, row = _solve_row(mesh, f"fleet-{2 * n}x60-pose-dp", e0, fleet_solve,
                        6, 2 * n, f32)
    _require(row["chi2"] < 0.1 * row["chi2_0"], "sharded fleet GN did not "
             f"converge: {row['chi2_0']} -> {row['chi2']}")
    rows.append(row)

    graph_s, values_s, _ = make_sphere_graph(
        n_poses=32, edges_per_pose=3.0, seed=0, dtype=f32,
        bucket=max(8, n), device=dev)
    graph_s = pad_graph_for_mesh(graph_s, n)
    e0 = total_error(graph_s, values_s)
    step = sharded_gn_step(mesh)
    D = used_slot_mask(values_s).shape[0]

    def dense_step():
        vals = step(graph_s, values_s, 0.0)
        return vals, total_error(graph_s, vals)

    _, row = _solve_row(mesh, "sphere32-dense-step", e0, dense_step, 1,
                        D * D, f32)
    _require(row["chi2"] < row["chi2_0"], "sharded GN step did not reduce "
             f"the error: {row['chi2_0']} -> {row['chi2']}")
    rows.append(row)
    return rows


def dryrun_multichip(n_devices: int, *, device=None, backend=None):
    """Run the dry run on ``n_devices`` ranks (``launch``'s ``device`` and
    ``backend``: by default one card a rank over NCCL); prints one JSON line
    a configuration and returns rank 0's rows. Raises if a configuration
    misses its bar or a rank's chi2 differs from rank 0's."""
    per_rank = launch(n_devices, _dryrun_rank, device=device,
                      backend=backend)
    rows = per_rank[0]
    for r, other in enumerate(per_rank[1:], 1):
        for a, b in zip(rows, other):
            _require(a["chi2"] == b["chi2"], f"rank {r}'s {b['config']} "
                     f"chi2 {b['chi2']} is not rank 0's {a['chi2']}")
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows
