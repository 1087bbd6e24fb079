"""Parity of the port's pose-graph backend with the JAX package, on the CPU
in float64: tables, chi2, linearization, GN/LM steps, the VRO pipeline and
the golden fixtures.

Tolerances, each with its reason:
- tables: exact — both packages build them with the same numpy code;
- ``total_error``: 1e-12 relative — the same closed forms, summed in a
  different order;
- ``linearize_blocks``: rtol 1e-10 + atol 1e-10 — closed-form Jacobians;
  the prior rows carry sqrt-information 1e6, so their entries are compared
  relative to their size;
- one GN step, LM and the pipeline: 1e-9 (chi2 relative, poses absolute) —
  a Cholesky or CG solve of a system with condition ~1e12 (the 1e-6-sigma
  anchor against unit-scale edges) amplifies rounding differences;
- golden fixtures: chi2 within 1e-6 relative and trajectory atol 1e-9, the
  gates of ``tests/test_goldens.py``.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_slam_tpu import config as jconfig
from graph_slam_tpu.datasets import make_sphere_graph as j_make_sphere
from graph_slam_tpu.graph import builder as jbuilder
from graph_slam_tpu.graph import factors as jfactors
from graph_slam_tpu.graph import lm as jlm
from graph_slam_tpu.graph import solve as jsolve
from graph_slam_tpu.graph import variables as jvariables
from graph_slam_tpu.io import read_vro_log as j_read_vro_log
from graph_slam_tpu.io import write_vro_log as j_write_vro_log
from graph_slam_tpu.pipelines import posegraph as jpg
from graph_slam_tpu_torch import config
from graph_slam_tpu_torch.convert import (arena_from_numpy, graph_from_numpy,
                                          to_numpy)
from graph_slam_tpu_torch.core import se3
from graph_slam_tpu_torch.datasets import make_sphere_graph
from graph_slam_tpu_torch.graph import (GraphBuilder, ProjectionTable,
                                        empty_table, gn_optimize,
                                        linearize_blocks, lm_optimize, solve,
                                        total_error, variables)
from graph_slam_tpu_torch.io import VROLog, read_vro_log, write_vro_log
from graph_slam_tpu_torch.io.vro_log import FAILED_INFO_SENTINEL
from graph_slam_tpu_torch.pipelines import run_pose_graph, trajectory_arrays

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def _sphere_pair(n_poses):
    gj, vj, _ = j_make_sphere(n_poses, dtype=jnp.float64, bucket=64)
    gt, vt, _ = make_sphere_graph(n_poses, dtype=torch.float64, bucket=64,
                                  device="cpu")
    return gj, vj, gt, vt


@pytest.fixture(scope="module")
def sphere():
    """The same 60-pose sphere graph from both packages."""
    return _sphere_pair(60)


@pytest.fixture(scope="module")
def small_sphere():
    """A 16-pose sphere graph: its padded shapes equal those of the small
    VRO log below, so the reference compiles its optimizer once for both."""
    return _sphere_pair(16)


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def test_sphere_graph_tables_match_through_convert(sphere):
    gj, vj, gt, vt = sphere
    gj_np, vj_np = _np_tree(gj), _np_tree(vj)
    conv_g = graph_from_numpy(gj_np, device="cpu")
    conv_v = arena_from_numpy(vj_np, device="cpu")
    for name in gt._fields:
        for field in getattr(gt, name)._fields:
            ref = np.asarray(getattr(getattr(gj_np, name), field))
            for port in (getattr(getattr(gt, name), field),
                         getattr(getattr(conv_g, name), field)):
                np.testing.assert_array_equal(to_numpy(port), ref,
                                              err_msg=f"{name}.{field}")
    for field in vt._fields:
        for port in (vt, conv_v):
            np.testing.assert_array_equal(to_numpy(getattr(port, field)),
                                          np.asarray(getattr(vj_np, field)))


def _fill_builder(b):
    """Every pose and noise input form the builder takes, and set_pose."""
    r = np.random.default_rng(22)
    Rs = [to_numpy(se3.expmap(torch.as_tensor(r.normal(size=6))).R)
          for _ in range(3)]
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = Rs[2], [0.1, -0.2, 0.3]
    b.add_pose((np.eye(3), np.zeros(3)))
    b.add_pose((Rs[0], r.normal(size=3)))
    b.add_pose(T)
    b.set_pose(1, (Rs[1], r.normal(size=3)))
    A = r.normal(size=(6, 6))
    b.add_prior_pose(0, (np.eye(3), np.zeros(3)), sigmas=np.full(6, 1e-3))
    b.add_prior_pose(2, T, covariance=A @ A.T + np.eye(6), robust=1.345)
    b.add_between(0, 1, (Rs[0], np.ones(3)), sigma=0.1)
    b.add_between(1, 2, T, information=A.T @ A + np.eye(6))
    b.add_between(0, 2, (Rs[1], np.zeros(3)), sqrt_info=np.triu(A) + 3 * np.eye(6),
                  robust=0.5)
    return b


def test_builder_matches():
    gj, vj = _fill_builder(jbuilder.GraphBuilder()).build(bucket=8)
    gt, vt = _fill_builder(GraphBuilder()).build(bucket=8, device="cpu")
    gj_np, vj_np = _np_tree(gj), _np_tree(vj)
    for name in gt._fields:
        for field in getattr(gt, name)._fields:
            np.testing.assert_array_equal(
                to_numpy(getattr(getattr(gt, name), field)),
                np.asarray(getattr(getattr(gj_np, name), field)),
                err_msg=f"{name}.{field}")
    for field in vt._fields:
        np.testing.assert_array_equal(to_numpy(getattr(vt, field)),
                                      np.asarray(getattr(vj_np, field)))


def _arena_fields(seed=23):
    """A filled arena with every variable kind, counts below capacity."""
    r = np.random.default_rng(seed)
    plane = r.normal(size=(3, 4))
    plane[:, :3] /= np.linalg.norm(plane[:, :3], axis=1, keepdims=True)
    return dict(
        pose_R=to_numpy(se3.expmap(torch.as_tensor(r.normal(size=(4, 6)))).R),
        pose_t=r.normal(size=(4, 3)), vel=r.normal(size=(2, 3)),
        bias=r.normal(size=(1, 6)), plane=plane, point=r.normal(size=(2, 3)),
        num_poses=np.array(3), num_vels=np.array(1), num_biases=np.array(1),
        num_planes=np.array(2), num_points=np.array(0))


def test_variable_arena_matches():
    # exact for the layout, empty arena and mask; atol 1e-12 for the
    # retraction, the same closed forms as tests/test_torch_core.py
    caps = (4, 2, 1, 3, 2)
    aj = jvariables.empty_arena(*caps)
    at = variables.empty_arena(*caps, device="cpu")
    for field in at._fields:
        np.testing.assert_array_equal(to_numpy(getattr(at, field)),
                                      np.asarray(getattr(aj, field)))
    fields = _arena_fields()
    aj = jvariables.VariableArena(**{k: jnp.asarray(v)
                                     for k, v in fields.items()})
    at = arena_from_numpy(types.SimpleNamespace(**fields), device="cpu")
    assert tuple(variables.layout_of(at)) == tuple(jvariables.layout_of(aj))
    np.testing.assert_array_equal(to_numpy(variables.used_slot_mask(at)),
                                  np.asarray(jvariables.used_slot_mask(aj)))
    delta = np.random.default_rng(24).normal(
        size=jvariables.layout_of(aj).dim) * 0.1
    rj = jvariables.retract_all(aj, jnp.asarray(delta))
    rt = variables.retract_all(at, torch.as_tensor(delta))
    for field in rt._fields:
        np.testing.assert_allclose(to_numpy(getattr(rt, field)),
                                   np.asarray(getattr(rj, field)), rtol=0,
                                   atol=1e-12, err_msg=field)


@pytest.mark.parametrize("name", ["solve_dense", "solve_pcg", "inv33"])
def test_solvers_match(name):
    # atol 1e-12: a 12x12 system with condition < 100 and O(1) solutions;
    # 8 fixed CG trips (fewer than the dimension) pin the trip count
    r = np.random.default_rng(25)
    A = r.normal(size=(12, 12))
    H, g, lam = A @ A.T / 12 + np.eye(12), r.normal(size=12), 1e-3
    if name == "inv33":
        B = r.normal(size=(5, 3, 3)) + 3 * np.eye(3)
        out_j, out_t = jsolve.inv33(jnp.asarray(B)), solve.inv33(
            torch.as_tensor(B))
    elif name == "solve_dense":
        out_j = jsolve.solve_dense(jnp.asarray(H), jnp.asarray(g), lam)
        out_t = solve.solve_dense(torch.as_tensor(H), torch.as_tensor(g), lam)
    else:
        Hj, Ht = jnp.asarray(H), torch.as_tensor(H)
        diag = np.diag(H) + lam
        out_j = jsolve.solve_pcg(lambda v: Hj @ v + lam * v, jnp.asarray(g),
                                 jnp.asarray(diag), max_iters=8)
        out_t = solve.solve_pcg(lambda v: Ht @ v + lam * v,
                                torch.as_tensor(g), torch.as_tensor(diag),
                                max_iters=8)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-12)


def test_total_error_matches(sphere):
    gj, vj, gt, vt = sphere
    ej = float(jfactors.total_error(gj, vj))
    et = float(total_error(gt, vt))
    assert abs(et - ej) <= 1e-12 * ej


def test_linearize_blocks_match(sphere):
    gj, vj, gt, vt = sphere
    bj = jax.jit(jfactors.linearize_blocks)(gj, vj)
    bt = linearize_blocks(gt, vt)
    assert len(bj) == len(bt) == 2
    for (rj, Jj, cj), (rt, Jt, ct) in zip(bj, bt):
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("solver,damping,pcg_iters",
                         [("dense", 0.0, 250), ("pcg", 1e-3, 10)])
def test_one_gn_step_matches(small_sphere, solver, damping, pcg_iters):
    gj, vj, gt, vt = small_sphere
    rj = jlm.gn_optimize(gj, vj, iterations=1, solver=solver,
                         damping=damping, pcg_iters=pcg_iters)
    rt = gn_optimize(gt, vt, iterations=1, solver=solver, damping=damping,
                     pcg_iters=pcg_iters)
    assert abs(float(rt.error) - float(rj.error)) <= 1e-9 * float(rj.error)
    np.testing.assert_allclose(rt.values.pose_t.numpy(),
                               np.asarray(rj.values.pose_t), atol=1e-9)
    np.testing.assert_allclose(rt.values.pose_R.numpy(),
                               np.asarray(rj.values.pose_R), atol=1e-9)


def test_lm_optimize_matches(small_sphere):
    gj, vj, gt, vt = small_sphere
    rj = jlm.lm_optimize(gj, vj)
    rt = lm_optimize(gt, vt)
    assert rt.iterations == int(rj.iterations)
    assert abs(float(rt.error) - float(rj.error)) <= 1e-9 * float(rj.error)
    assert float(rt.error) < 0.01 * float(total_error(gt, vt))


def _small_log(n=24, seed=0):
    """A VRO log along a wavy path: odometry, loop closures (i, i+4), one
    failed odometry record, one failed loop closure, one gross outlier."""
    r = np.random.default_rng(seed)
    xi_gt = np.concatenate([r.normal(size=(n, 3)) * 0.05,
                            np.tile([0.3, 0.0, 0.02], (n, 1))
                            + r.normal(size=(n, 3)) * 0.02], axis=1)
    poses = [se3.Pose(torch.eye(3, dtype=torch.float64),
                      torch.zeros(3, dtype=torch.float64))]
    for k in range(1, n):
        poses.append(se3.compose(poses[-1], se3.expmap(torch.as_tensor(xi_gt[k]))))
    info = np.diag([100.0, 100.0, 100.0, 25.0, 25.0, 25.0])
    recs = []
    for k in range(1, n):
        recs.append((k, k - 1))
        if k >= 4:
            recs.append((k, k - 4))
    ids_to, ids_from, xis, infos = [], [], [], []
    for q, (j, i) in enumerate(recs):
        rel = se3.logmap(se3.between(poses[i], poses[j])).numpy()
        rel = rel + r.normal(size=6) * np.array([0.005] * 3 + [0.01] * 3)
        inf = info
        if (j, i) in ((9, 8), (15, 11)):           # failed odometry / loop
            rel, inf = np.zeros(6), np.eye(6) * FAILED_INFO_SENTINEL
        if (j, i) == (20, 16):                     # gross outlier
            rel = rel + np.array([0.0, 0.0, 0.5, 1.0, -1.0, 0.0])
        ids_to.append(j)
        ids_from.append(i)
        xis.append(rel)
        infos.append(inf)
    return VROLog(np.asarray(ids_to), np.asarray(ids_from), np.stack(xis),
                  np.stack(infos))


@pytest.mark.parametrize("robust", [None, "huber"])
def test_run_pose_graph_matches(tmp_path, robust):
    path = str(tmp_path / "small_vro.log")
    write_vro_log(path, _small_log())
    rj = jpg.run_pose_graph(j_read_vro_log(path),
                            jconfig.SlamParams(robust=robust), bucket=64)
    rt = run_pose_graph(read_vro_log(path), config.SlamParams(robust=robust),
                        bucket=64, device="cpu")
    assert abs(rt.error0 - rj.error0) <= 1e-12 * rj.error0
    assert abs(rt.error - rj.error) <= 1e-9 * rj.error
    assert rt.error < rt.error0
    _, tj, qj, sj = jpg.trajectory_arrays(rj.values, rj.seq_ids)
    _, tt, qt, st = trajectory_arrays(rt.values, rt.seq_ids)
    np.testing.assert_allclose(tt, tj, atol=1e-9)
    np.testing.assert_allclose(qt, qj, atol=1e-9)
    np.testing.assert_array_equal(st, sj)


def test_vro_log_io_matches(tmp_path):
    """Each package reads the other's file to the same arrays, and both
    write the same bytes."""
    port_path, ref_path = str(tmp_path / "port.log"), str(tmp_path / "ref.log")
    write_vro_log(port_path, _small_log())
    lj, lt = j_read_vro_log(port_path), read_vro_log(port_path)
    j_write_vro_log(ref_path, lj)
    for field in ("id_to", "id_from", "xi", "info"):
        np.testing.assert_array_equal(getattr(lt, field), getattr(lj, field))
        np.testing.assert_array_equal(getattr(read_vro_log(ref_path), field),
                                      getattr(lj, field))
        np.testing.assert_array_equal(getattr(lt.sorted_by_target(), field),
                                      getattr(lj.sorted_by_target(), field))
    np.testing.assert_array_equal(lt.valid, lj.valid)
    assert (~lt.valid).sum() == 2
    assert open(port_path).read() == open(ref_path).read()


def test_golden_vro_log():
    pins = json.load(open(os.path.join(GOLDEN, "chi2.json")))
    res = run_pose_graph(read_vro_log(os.path.join(GOLDEN,
                                                   "posegraph_vro.log")),
                         bucket=64, device="cpu")
    assert abs(res.error0 - pins["vro_error0"]) <= 1e-6 * pins["vro_error0"]
    assert abs(res.error - pins["vro_error"]) <= 1e-6 * pins["vro_error"]
    # trajectory lines: id x y z qx qy qz qw seq
    golden = np.loadtxt(os.path.join(GOLDEN, "posegraph_traj.log"))
    _, t, q, seq = trajectory_arrays(res.values, res.seq_ids)
    np.testing.assert_allclose(t, golden[:, 1:4], atol=1e-9)
    np.testing.assert_allclose(q[:, [1, 2, 3, 0]], golden[:, 4:8], atol=1e-9)
    np.testing.assert_array_equal(seq, golden[:, 8])


@pytest.mark.parametrize("kwargs", [
    {"init": "chordal"}, {"loop_gate": "pcm"}, {"backend": "g2o"},
    {"params": config.SlamParams(robust="gnc-tls")}])
def test_unported_options_raise(kwargs):
    """These options raised NotImplementedError until their modules were
    ported; now each runs and lowers chi2 (their parity with the reference
    is in tests/test_torch_robust.py and tests/test_torch_g2o.py)."""
    res = run_pose_graph(_small_log(8), device="cpu", **kwargs)
    assert np.isfinite(res.error) and res.error < res.error0


def test_unported_factor_table_raises(sphere):
    """The projection table raised NotImplementedError until bundle
    adjustment was ported; now an inactive projection row (pointing at a
    point slot) adds nothing to the error, and an active one adds its
    loss (tests/test_torch_ba.py holds the rows to the reference)."""
    _, _, gt, vt = sphere
    proj = empty_table(ProjectionTable, 1, device="cpu")
    vt = vt._replace(point=torch.tensor([[0.1, 0.2, 2.0]],
                                        dtype=torch.float64))
    e = total_error(gt, vt)
    assert float(total_error(gt._replace(projection=proj), vt)) == float(e)
    proj = proj._replace(active=torch.ones(1, dtype=torch.bool),
                         sqrt_info=torch.eye(2, dtype=torch.float64)[None])
    e1 = total_error(gt._replace(projection=proj), vt)
    assert torch.isfinite(e1) and float(e1) > float(e)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks a CPU-only host")
    with pytest.raises((AssertionError, RuntimeError)):
        run_pose_graph(_small_log(8), device="cuda")
