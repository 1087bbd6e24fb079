"""The references' arithmetic on small problems, the percentile and the
reduction of a trace."""

import numpy as np
import pytest
import torch

from graph_slam_tpu_torch.core import se3
from graph_slam_tpu_torch.graph import (GraphBuilder, LMParams,
                                        ba_gn_optimize, ba_gn_optimize_sqrt)
from graph_slam_tpu_torch.pipelines import run_g2o_file
from portbench import stats, trace
from portbench.gen import synthetic as gen
from portbench.reference import ba as ref_ba
from portbench.reference import lie
from portbench.reference import pose_graph as ref_pg
from portbench.tests.test_portbench_gen import CAL

F64 = torch.float64
LM = {"lambda_initial": 1e-5, "lambda_factor": 10.0, "lambda_upper": 1e5,
      "lambda_lower": 0.0, "min_model_fidelity": 1e-3, "max_iterations": 100,
      "relative_error_tol": 1e-5, "absolute_error_tol": 1e-5,
      "error_tol": 0.0, "max_trials": 12}


@pytest.mark.parametrize("scale", [0.0, 1e-7, 1e-3, 0.09, 0.11, 0.7, 2.5])
def test_lie_matches_the_port_and_inverts(scale):
    g = torch.Generator().manual_seed(3)
    xi = torch.randn(64, 6, generator=g, dtype=F64) * scale
    R, t = lie.se3_exp(xi)
    P = se3.expmap(xi)
    np.testing.assert_allclose(R, P.R, rtol=0, atol=1e-14)
    np.testing.assert_allclose(t, P.t, rtol=0, atol=1e-14 * max(1.0, scale))
    small = torch.linalg.norm(xi[:, :3], dim=1) < 3.0   # Log inverts below pi
    np.testing.assert_allclose(lie.se3_log(R, t)[small], xi[small], rtol=0,
                               atol=1e-13 * max(1.0, scale))


def test_linearize_is_the_derivative():
    g = torch.Generator().manual_seed(4)
    R = lie.so3_exp(torch.randn(20, 3, generator=g, dtype=F64))
    t = torch.randn(20, 3, generator=g, dtype=F64)

    def fn(xi, R, t):
        return lie.se3_log(*lie.retract(R, t, xi))

    r, J = lie.linearize(fn, 6, R, t)
    h = 1e-6
    for k in range(6):
        e = torch.zeros(20, 6, dtype=F64)
        e[:, k] = h
        fd = (fn(e, R, t) - fn(-e, R, t)) / (2 * h)
        np.testing.assert_allclose(J[:, :, k], fd, atol=1e-8)
    np.testing.assert_allclose(r, fn(torch.zeros(20, 6, dtype=F64), R, t))


def test_pose_graph_reference_is_run_g2o_file(tmp_path):
    a = gen.sphere_graph(60, 40, 0.02, 0.1, 9)
    R, t = gen.sphere_start(a["gt_R"], a["gt_t"], 0.1, (9, 1, 3))
    path = str(tmp_path / "s.g2o")
    gen.write_g2o(path, R, t, a)
    res = run_g2o_file(path, LMParams(), device="cpu")
    g = ref_pg.PoseGraph(path, 1e-6, device="cpu", dtype=F64)
    Rr, tr, chi2, it, trials = ref_pg.solve_lm(g, LM)
    assert it == res.iterations and trials >= it
    assert abs(float(chi2) / res.error - 1) < 1e-12
    np.testing.assert_allclose(tr, res.values.pose_t[:60], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(Rr, res.values.pose_R[:60], rtol=0,
                               atol=1e-12)
    assert float(chi2) < 0.1 * float(g.error(g.R0, g.t0))


def ba_graph(p, start, dtype):
    b = GraphBuilder()
    R0, t0, q0 = start
    n, m = p["gt_t"].shape[0], p["points"].shape[0]
    for k in range(n):
        b.add_pose((R0[k], t0[k]))
    b.add_prior_pose(0, (p["gt_R"][0], p["gt_t"][0]), sigmas=np.full(6, 1e-6))
    for q in range(m):
        b.add_point(q0[q])
        b.add_prior_point(q, p["points"][q], sigma=0.1)
    for o in range(p["pose_idx"].shape[0]):
        b.add_projection_factor(int(p["pose_idx"][o]), int(p["point_idx"][o]),
                                p["uv"][o], CAL)
    return b.build(bucket=64, device="cpu", dtype=dtype)


@pytest.mark.parametrize("call,clip", [("sqrt", 1.0), ("schur", None)])
def test_ba_reference_is_the_port_in_float64(call, clip):
    p = gen.bal_problem(40, 300, 1300, 2, 3, (176, 144), 0.5, 0.05, 0.1,
                        CAL, 6)
    start = gen.ba_start(p, 0.05, (6, 1, 0))
    g, v = ba_graph(p, start, F64)
    if call == "sqrt":
        v1, c1 = ba_gn_optimize_sqrt(g, v, iterations=4, damping=1e-3,
                                     chunk=4096, step_clip=clip)
    else:
        v1, c1 = ba_gn_optimize(g, v, iterations=4, damping=1e-3)
    prob = ref_ba.BundleProblem(p, 1.0, 1e-6, device="cpu", dtype=F64)
    st = tuple(torch.as_tensor(x) for x in start)
    R, t, q, chi2 = ref_ba.solve_gn(prob, st, 4, 1e-3, clip)
    assert abs(float(chi2) / float(c1) - 1) < 1e-12
    np.testing.assert_allclose(q, v1.point[:300], rtol=0, atol=1e-10)
    np.testing.assert_allclose(t, v1.pose_t[:40], rtol=0, atol=1e-10)
    assert float(chi2) < 2e-2 * float(prob.error(*st))


def test_shared_readers():
    solves = [{"gn_iterations": 4}, {"gn_iterations": 4}]
    tr = {"busy_s": 0.75, "window_s": 1.0, "device_s": 0.8, "launches": 80}
    ctx = {"solves": solves, "window_s": 2.0, "trace": tr}
    assert stats.ms_per_solve(ctx) == 1000.0
    assert stats.device_idle_pct(ctx) == 25.0
    assert stats.device_ms_per_iter(ctx) == 100.0
    assert stats.launches_per_iter(ctx) == 10.0
    empty = {"solves": [], "window_s": 0.0, "trace": None}
    for fn in (stats.ms_per_solve, stats.device_idle_pct,
               stats.device_ms_per_iter, stats.launches_per_iter):
        assert fn(empty) is None     # nothing to read: left out, never 0


def ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 0, "args": args}


def test_trace_summary():
    events = [
        ev("portbench.solve", "user_annotation", 0.0, 100.0),
        ev("portbench.ingest.read_g2o", "user_annotation", 0.0, 30.0),
        ev("aten::linalg_cholesky_ex", "cpu_op", 40.0, 10.0),
        ev("cudaLaunchKernel", "cuda_runtime", 41.0, 1.0, correlation=7),
        ev("cudaLaunchKernel", "cuda_runtime", 60.0, 1.0, correlation=8),
        ev("potrf_kernel", "kernel", 45.0, 20.0, tid=7, correlation=7),
        ev("gemv", "kernel", 62.0, 10.0, tid=7, correlation=8),
        ev("memset", "gpu_memset", 90.0, 5.0, tid=7),
        ev("portbench.solve", "user_annotation", 120.0, 30.0),
        ev("other", "kernel", 125.0, 10.0, tid=7, correlation=9),
        ev("before", "kernel", -50.0, 10.0, tid=7),
    ]
    s = trace.summarize(events, host_ops=("aten::linalg_cholesky_ex",))
    assert s["window_s"] == pytest.approx(150e-6)
    assert s["busy_s"] == pytest.approx((27.0 + 5.0 + 10.0) * 1e-6)
    assert s["device_s"] == pytest.approx(45e-6)
    assert s["launches"] == 3 and s["solves"] == 2
    assert s["host_ops"]["aten::linalg_cholesky_ex"] == {
        "count": 1, "device_s": pytest.approx(20e-6)}
    idle = s["idle"]
    assert idle["portbench.ingest.read_g2o | python"] == pytest.approx(45e-6)
    assert idle["no span | python"] == pytest.approx(30e-6)
    assert sum(idle.values()) == pytest.approx(150e-6 - s["busy_s"])
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["potrf_kernel", pytest.approx(20e-6)]
    assert len(b["idle_gaps"]) <= 10
