"""Parity of the port's g2o path with the JAX package, on the CPU in
float64: g2o / trajectory / marginals IO, g2o's chunked Nielsen LM
(``lm_optimize_g2o``), ``run_g2o_file`` on the golden, ``backend="g2o"``,
``trajectory_arrays(w2o=)``, ``se3.from_matrix``/``to_matrix`` and
``failed_edge``.

Tolerances: files and tables exact (both packages run the same numpy);
chi2 within 1e-6 relative of ``tests/goldens/chi2.json`` (the goldens'
gate); LM histories, chi2 and poses against the reference at 1e-9 (a
Cholesky solve of a system with condition ~1e12, the anchor against
unit-scale edges, amplifies rounding differences); the se3 helpers 1e-12.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_slam_tpu import config as jconfig
from graph_slam_tpu.core import se3 as jse3
from graph_slam_tpu.graph import LMParams as JLMParams
from graph_slam_tpu.graph import lm as jlm
from graph_slam_tpu.io import read_vro_log as j_read_vro_log
from graph_slam_tpu.io import trajectory as jtraj
from graph_slam_tpu.io import vro_log as jvro
from graph_slam_tpu.pipelines import posegraph as jpg
from graph_slam_tpu_torch import config
from graph_slam_tpu_torch.convert import (arena_from_numpy, graph_from_numpy,
                                          to_numpy)
from graph_slam_tpu_torch.core import se3
from graph_slam_tpu_torch.graph import (GraphBuilder, LMParams, lm_optimize,
                                        lm_optimize_g2o)
from graph_slam_tpu_torch.io import (failed_edge, read_g2o, read_marginals,
                                     read_trajectory, read_vro_log,
                                     trajectory, write_g2o, write_marginals,
                                     write_ply_points, write_trajectory)
from graph_slam_tpu_torch.pipelines import (build_graph_from_g2o,
                                            build_pose_graph, run_g2o_file,
                                            run_pose_graph, trajectory_arrays)
from test_optimizer import make_circle_graph

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
PINS = json.load(open(os.path.join(GOLDEN, "chi2.json")))
G2O_GOLDEN = os.path.join(GOLDEN, "sphere200_noisy.g2o")
VRO_GOLDEN = os.path.join(GOLDEN, "posegraph_vro.log")


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _port(graph, values):
    return (graph_from_numpy(_np_tree(graph), device="cpu"),
            arena_from_numpy(_np_tree(values), device="cpu"))


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


# -- IO ------------------------------------------------------------------------


def _traj_arrays(n=7, seed=0):
    r = np.random.default_rng(seed)
    q = r.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.arange(n) + 3, r.normal(size=(n, 3)), q, np.arange(n) * 2


def _g2o_edges(n=7, seed=1):
    r = np.random.default_rng(seed)
    edges = []
    for k in range(n):
        A = r.normal(size=(6, 6))
        q = r.normal(size=4)
        edges.append((k, (k + 2) % n, r.normal(size=3), q / np.linalg.norm(q),
                      A @ A.T + np.eye(6)))
    return edges


def _write_both(kind, port_path, ref_path):
    ids, t, q, seq = _traj_arrays()
    if kind == "g2o":
        args = (t, q, _g2o_edges())
        write_g2o(port_path, *args)
        jtraj.write_g2o(ref_path, *args)
    elif kind == "trajectory":
        write_trajectory(port_path, ids, t, q, seq)
        jtraj.write_trajectory(ref_path, ids, t, q, seq)
    elif kind == "marginals":
        covs = np.stack([e[4] for e in _g2o_edges()])
        write_marginals(port_path, ids, covs)
        jtraj.write_marginals(ref_path, ids, covs)
    else:
        colors = (np.arange(21).reshape(7, 3) * 12).astype(np.uint8)
        write_ply_points(port_path, t, colors)
        jtraj.write_ply_points(ref_path, t, colors)


@pytest.mark.parametrize("kind", ["g2o", "trajectory", "marginals", "ply"])
def test_trajectory_io_matches(tmp_path, kind):
    """Both packages write the same bytes, and read the same arrays.

    A PLY's vertices are ``property float``: the reference writes them
    with its native writer's ``%.9g`` of the float32 value where that
    library builds, and by ``repr`` (the port's only way) where it does
    not, so the PLY rows are compared as float32 numbers."""
    port_path, ref_path = str(tmp_path / "port"), str(tmp_path / "ref")
    _write_both(kind, port_path, ref_path)
    if kind == "ply":
        port, ref = open(port_path).read(), open(ref_path).read()
        head = port.index("end_header\n") + len("end_header\n")
        assert port[:head] == ref[:head]
        np.testing.assert_array_equal(
            np.loadtxt(port_path, skiprows=10).astype(np.float32),
            np.loadtxt(ref_path, skiprows=10).astype(np.float32))
        return
    assert open(port_path).read() == open(ref_path).read()
    if kind == "g2o":
        (vp, ep), (vr, er) = read_g2o(port_path), jtraj.read_g2o(port_path)
        assert sorted(vp) == sorted(vr)
        for k in vr:
            for a, b in zip(vp[k], vr[k]):
                np.testing.assert_array_equal(a, b)
        assert len(ep) == len(er)
        for a, b in zip(ep, er):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    elif kind == "trajectory":
        tp, tr = read_trajectory(port_path), jtraj.read_trajectory(port_path)
        for f in ("ids", "t", "quat", "seq"):
            np.testing.assert_array_equal(getattr(tp, f), getattr(tr, f))
    elif kind == "marginals":
        for a, b in zip(read_marginals(port_path),
                        jtraj.read_marginals(port_path)):
            np.testing.assert_array_equal(a, b)


def test_graph_summary_matches(tmp_path):
    log = read_vro_log(VRO_GOLDEN)
    gt, vt, _ = build_pose_graph(log, bucket=64, device="cpu")
    gj, vj, _ = jpg.build_pose_graph(j_read_vro_log(VRO_GOLDEN), bucket=64)
    trajectory.write_graph_summary(str(tmp_path / "port"), gt, vt)
    jtraj.write_graph_summary(str(tmp_path / "ref"), gj, vj)
    assert (tmp_path / "port").read_text() == (tmp_path / "ref").read_text()


def test_failed_edge_matches():
    for a, b in zip(failed_edge(5, 4), jvro.failed_edge(5, 4)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_se3_matrix_round_trip_matches():
    r = np.random.default_rng(2)
    p = se3.expmap(torch.as_tensor(r.normal(size=(5, 6))))
    T = se3.to_matrix(p)
    Tj = jse3.to_matrix(jse3.Pose(jnp.asarray(p.R.numpy()),
                                  jnp.asarray(p.t.numpy())))
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), rtol=0, atol=1e-12)
    back = se3.from_matrix(T)
    back_j = jse3.from_matrix(Tj)
    np.testing.assert_array_equal(back.R.numpy(), np.asarray(back_j.R))
    np.testing.assert_array_equal(back.t.numpy(), np.asarray(back_j.t))


# -- g2o's LM schedule ---------------------------------------------------------


@pytest.fixture(scope="module")
def circle():
    """``tests/test_g2o_schedule.py``'s perturbed circle, the reference's
    g2o LM on it (default schedule and a 2-iteration chunk) and its GTSAM
    LM."""
    b, _ = make_circle_graph(n=30, noise=0.05, init_noise=0.6, seed=3)
    gj, vj = b.build(bucket=64)
    refs = {"default": jlm.lm_optimize_g2o(gj, vj),
            "one_chunk": jlm.lm_optimize_g2o(gj, vj, total_iters=2,
                                             chunks=1)}
    return gj, vj, refs, jlm.lm_optimize(gj, vj)


@pytest.mark.parametrize("case", ["default", "one_chunk"])
def test_lm_optimize_g2o_matches(circle, case):
    gj, vj, refs, _ = circle
    gt, vt = _port(gj, vj)
    kw = {} if case == "default" else {"total_iters": 2, "chunks": 1}
    res = lm_optimize_g2o(gt, vt, **kw)
    ref = refs[case]
    np.testing.assert_allclose(res.history.numpy(), np.asarray(ref.history),
                               rtol=1e-9, atol=0)
    assert _rel(res.error, ref.error) <= 1e-9
    assert res.iterations == int(ref.iterations)
    np.testing.assert_allclose(res.values.pose_t.numpy(),
                               np.asarray(ref.values.pose_t), atol=1e-9)
    np.testing.assert_allclose(res.values.pose_R.numpy(),
                               np.asarray(ref.values.pose_R), atol=1e-9)


def test_lm_optimize_g2o_reaches_the_gtsam_optimum(circle):
    """``test_g2o_schedule.py``'s gate on the port: the same optimum as
    GTSAM's LM, non-increasing per-chunk history."""
    gj, vj, _, ref_gtsam = circle
    gt, vt = _port(gj, vj)
    res = lm_optimize_g2o(gt, vt)
    assert abs(float(res.error) - float(lm_optimize(gt, vt).error)) \
        <= 1e-6 * float(ref_gtsam.error)
    hist = res.history.numpy()
    assert hist.shape == (10,) and np.isfinite(hist).all()
    assert (np.diff(hist) <= 1e-9 * hist[:-1] + 1e-12).all()


def test_lm_optimize_g2o_anchor_not_on_first_pose():
    """lambda0 excludes whichever pose carries the gauge prior
    (``test_g2o_schedule.py::TestG2oAnchorPlacement``)."""
    import np_lie

    r = np.random.default_rng(7)
    n, anchor = 24, 5
    gt_poses = [(np_lie.so3_exp([0.0, 0.0, 2 * np.pi * k / n]),
                 np.array([np.cos(2 * np.pi * k / n),
                           np.sin(2 * np.pi * k / n), 0.0]))
                for k in range(n)]
    b = GraphBuilder()
    for k, pose in enumerate(gt_poses):
        b.add_pose(pose if k == anchor
                   else np_lie.retract(pose, r.normal(size=6) * 0.3))
    b.add_prior_pose(anchor, gt_poses[anchor], sigmas=np.full(6, 1e-7))
    info = np.diag([100.0] * 3 + [25.0] * 3)
    for k in range(n):
        b.add_between(k, (k + 1) % n,
                      np_lie.between(gt_poses[k], gt_poses[(k + 1) % n]),
                      information=info)
    graph, values = b.build(bucket=32, device="cpu")
    e_g2o = float(lm_optimize_g2o(graph, values).error)
    e_gt = float(lm_optimize(graph, values).error)
    assert e_g2o <= (1.0 + 1e-6) * e_gt + 1e-9, (e_g2o, e_gt)


# -- g2o files and the g2o backend --------------------------------------------


@pytest.fixture(scope="module")
def golden_g2o():
    params = dict(relative_error_tol=1e-12, absolute_error_tol=1e-12)
    return (jpg.run_g2o_file(G2O_GOLDEN, JLMParams(**params), bucket=64),
            run_g2o_file(G2O_GOLDEN, LMParams(**params), bucket=64,
                         device="cpu"))


def test_run_g2o_file_golden(golden_g2o):
    ref, res = golden_g2o
    assert _rel(res.error0, PINS["g2o_error0"]) <= 1e-6
    assert _rel(res.error, PINS["g2o_error"]) <= 1e-6
    assert _rel(res.error, ref.error) <= 1e-9
    assert res.iterations == ref.iterations
    np.testing.assert_array_equal(res.seq_ids, ref.seq_ids)
    _, t, q, _ = trajectory_arrays(res.values, res.seq_ids)
    _, tj, qj, _ = jpg.trajectory_arrays(ref.values, ref.seq_ids)
    np.testing.assert_allclose(t, tj, atol=1e-9)
    np.testing.assert_allclose(q, qj, atol=1e-9)


def test_build_graph_from_g2o_tables_match():
    vertices, edges = read_g2o(G2O_GOLDEN)
    gt, vt, ids = build_graph_from_g2o(vertices, edges, bucket=64,
                                       device="cpu")
    gj, vj, ids_j = jpg.build_graph_from_g2o(*jtraj.read_g2o(G2O_GOLDEN),
                                             bucket=64)
    np.testing.assert_array_equal(ids, ids_j)
    gj_np = _np_tree(gj)
    for name in ("prior_pose", "between"):
        for field in getattr(gt, name)._fields:
            np.testing.assert_allclose(
                to_numpy(getattr(getattr(gt, name), field)),
                getattr(getattr(gj_np, name), field), rtol=0, atol=1e-15,
                err_msg=f"{name}.{field}")
    np.testing.assert_allclose(vt.pose_R.numpy(), np.asarray(vj.pose_R),
                               rtol=0, atol=1e-15)
    np.testing.assert_array_equal(vt.pose_t.numpy(), np.asarray(vj.pose_t))


@pytest.fixture(scope="module")
def golden_log_g2o():
    """The golden VRO log through the reference's g2o backend, with its
    default budget and with 4 iterations."""
    log = j_read_vro_log(VRO_GOLDEN)
    return {4: jpg.run_pose_graph(log, jconfig.SlamParams(), bucket=64,
                                  backend="g2o",
                                  lm_params=JLMParams(max_iterations=4)),
            20: jpg.run_pose_graph(log, jconfig.SlamParams(), bucket=64,
                                   backend="g2o")}


@pytest.mark.parametrize("budget", [4, 20])
def test_backend_g2o_on_golden_log(golden_log_g2o, budget):
    ref = golden_log_g2o[budget]
    kw = {} if budget == 20 else {"lm_params": LMParams(max_iterations=4)}
    res = run_pose_graph(read_vro_log(VRO_GOLDEN), config.SlamParams(),
                         bucket=64, backend="g2o", device="cpu", **kw)
    assert res.iterations == budget
    assert _rel(res.error0, ref.error0) <= 1e-12
    assert _rel(res.error, ref.error) <= 1e-9
    assert res.error < res.error0
    if budget == 20:   # test_g2o_schedule.py's pin
        assert abs(res.error - 0.1673486302270372) < 1e-4 * 0.167
    _, t, _, _ = trajectory_arrays(res.values, res.seq_ids)
    _, tj, _, _ = jpg.trajectory_arrays(ref.values, ref.seq_ids)
    np.testing.assert_allclose(t, tj, atol=1e-9)


@pytest.mark.parametrize("only_vo", [True, False])
@pytest.mark.parametrize("backend", ["gtsam", "g2o"])
def test_build_pose_graph_backend_and_only_vo_tables_match(backend, only_vo):
    """The fake-odometry weighting of the failed record and ``only_vo``."""
    gt, vt, seq = build_pose_graph(read_vro_log(VRO_GOLDEN),
                                   only_vo=only_vo, bucket=64,
                                   backend=backend, device="cpu")
    gj, vj, seq_j = jpg.build_pose_graph(j_read_vro_log(VRO_GOLDEN),
                                         only_vo=only_vo, bucket=64,
                                         backend=backend)
    np.testing.assert_array_equal(seq, seq_j)
    bt, bj = gt.between, _np_tree(gj.between)
    np.testing.assert_array_equal(bt.active.numpy(), bj.active)
    np.testing.assert_array_equal(bt.i.numpy(), bj.i)
    np.testing.assert_array_equal(bt.j.numpy(), bj.j)
    np.testing.assert_allclose(bt.sqrt_info.numpy(), bj.sqrt_info, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(vt.pose_t.numpy(), np.asarray(vj.pose_t),
                               rtol=0, atol=1e-12)


def test_trajectory_arrays_w2o_matches():
    res = run_pose_graph(read_vro_log(VRO_GOLDEN), bucket=64, device="cpu")
    r = np.random.default_rng(4)
    w = se3.expmap(torch.as_tensor(r.normal(size=6)))
    wj = jse3.Pose(jnp.asarray(w.R.numpy()), jnp.asarray(w.t.numpy()))
    vj = jax.tree.map(jnp.asarray, to_numpy(res.values))
    out = trajectory_arrays(res.values, res.seq_ids, w2o=w)
    ref = jpg.trajectory_arrays(vj, res.seq_ids, w2o=wj)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12)
    # identity w2o leaves the trajectory where it was
    ident = se3.Pose(torch.eye(3, dtype=torch.float64),
                     torch.zeros(3, dtype=torch.float64))
    for a, b in zip(trajectory_arrays(res.values, res.seq_ids, w2o=ident),
                    trajectory_arrays(res.values, res.seq_ids)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-15)
