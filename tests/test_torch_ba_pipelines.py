"""Parity of the port's BA pipelines with the JAX package, on the CPU in
float64: two-frame BA and ``TrackBook`` (``tests/test_ba.py``), the
marginal covariances (``graph/marginals.py``, ``tests/test_marginals_out.py``)
and ``run_ba_imu`` on ``tests/test_pipelines2.py``'s two scenes, whose
float32 run goes through the square-root Schur.

Tolerances, each with its reason:
- two-frame BA: pose and information 1e-8 relative (an LM optimum and the
  inverse of a marginal of a system with a 1e-7-sigma anchor);
- marginals 1e-9 relative to the block's largest entry (one Cholesky of
  the same dense Hessian);
- ``run_ba_imu``: counts equal, chi2 1e-8 relative and values 1e-8 (in
  meters) on the scenes with 0.5 px of pixel noise (noise-free, both
  packages start at the optimum and chi2 is rounding, ~1e-24): the
  initial estimates come from the same preintegration in two packages
  (1e-10), then eight normal-equations Schur steps or LM.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import np_lie
from graph_slam_tpu.config import SR4000 as J_SR4000
from graph_slam_tpu.datasets import make_sphere_graph as j_make_sphere
from graph_slam_tpu.graph import builder as jbuilder
from graph_slam_tpu.graph import marginals as jmarg
from graph_slam_tpu.pipelines import BaImuConfig as JBaImuConfig
from graph_slam_tpu.pipelines import run_ba_imu as j_run_ba_imu
from graph_slam_tpu.vision import TrackBook as JTrackBook
from graph_slam_tpu.vision import two_frame_ba as j_two_frame_ba
from graph_slam_tpu_torch import convert
from graph_slam_tpu_torch.config import SR4000
from graph_slam_tpu_torch.graph import (GraphBuilder, joint_marginal,
                                        layout_of, plane_marginal,
                                        pose_marginal, pose_marginals_all)
from graph_slam_tpu_torch.imu import ImuStream
from graph_slam_tpu_torch.io import read_marginals, write_marginals
from graph_slam_tpu_torch.pipelines import BaImuConfig, run_ba_imu
from graph_slam_tpu_torch.vision import TrackBook, two_frame_ba
from graph_slam_tpu_torch.vision.cal3ds2 import Cal3DS2, project_point

torch.set_num_threads(1)


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _K():
    return Cal3DS2.make(SR4000.fx, SR4000.fy, SR4000.cx, SR4000.cy,
                        SR4000.k1, SR4000.k2, device="cpu")


def _project(local):
    return project_point(_K(), torch.as_tensor(local)).numpy()


# -- two-frame BA and TrackBook -----------------------------------------------


def make_two_frame_scene(n_pts=40, seed=0):
    """``tests/test_ba.py``'s scene, projected by the port's camera."""
    r = np.random.default_rng(seed)
    pts = np.stack([r.uniform(-1, 1, n_pts), r.uniform(-0.8, 0.8, n_pts),
                    r.uniform(1.5, 3.5, n_pts)], axis=1)
    T_ij = np_lie.se3_exp(np.array([0.03, -0.05, 0.04, 0.12, -0.06, 0.08]))
    Rj, tj = np_lie.inverse(T_ij)
    return pts, _project(pts), _project((Rj @ pts.T).T + tj), T_ij


def test_two_frame_ba_recovers_relative_pose():
    pts, uv_i, uv_j, T_gt = make_two_frame_scene()
    T0 = np_lie.retract(T_gt, np.full(6, 0.02))
    (R, t), info, err = two_frame_ba(pts, uv_i, uv_j, SR4000, T0,
                                     device="cpu")
    np.testing.assert_allclose(R, T_gt[0], atol=1e-5)
    np.testing.assert_allclose(t, T_gt[1], atol=1e-4)
    assert np.linalg.eigvalsh(info).min() > 0
    assert err < 1e-8


def test_two_frame_information_grows_with_matches():
    pts, uv_i, uv_j, T_gt = make_two_frame_scene(n_pts=60)
    _, info_many, _ = two_frame_ba(pts, uv_i, uv_j, SR4000, T_gt,
                                   device="cpu")
    _, info_few, _ = two_frame_ba(pts[:15], uv_i[:15], uv_j[:15], SR4000,
                                  T_gt, device="cpu")
    assert np.trace(info_many) > np.trace(info_few)


def test_two_frame_ba_matches_the_reference():
    """Pixel noise and a mounted camera, so the optimum is not exact."""
    pts, uv_i, uv_j, T_gt = make_two_frame_scene(n_pts=30, seed=3)
    r = np.random.default_rng(4)
    uv_i = uv_i + r.normal(size=uv_i.shape) * 0.5
    uv_j = uv_j + r.normal(size=uv_j.shape) * 0.5
    body = (np_lie.so3_exp(np.array([0.01, -0.02, 0.03])),
            np.array([0.02, 0.0, -0.01]))
    T0 = np_lie.retract(T_gt, np.full(6, 0.01))
    (R, t), info, err = two_frame_ba(pts, uv_i, uv_j, SR4000, T0,
                                     body_pose=body, device="cpu")
    (Rj, tj), info_j, err_j = j_two_frame_ba(pts, uv_i, uv_j, J_SR4000, T0,
                                             body_pose=body)
    assert _rel_err(R, Rj) <= 1e-8 and _rel_err(t, tj) <= 1e-8
    assert _rel_err(info, info_j) <= 1e-8
    assert abs(err - err_j) <= 1e-8 * err_j


MERGES = [(0, 1, [(0, 0), (1, 1), (2, 2)]), (1, 2, [(0, 5), (1, 6), (3, 7)]),
          (0, 2, [(0, 5), (4, 8)]), (2, 3, [(8, 0), (5, 1), (9, 9)]),
          (1, 3, [(3, 1), (6, 2)])]


def test_trackbook_merge_semantics():
    tb = TrackBook()
    ev = tb.merge(0, 1, [(0, 0), (1, 1)])
    assert [e[0] for e in ev] == ["new", "new"]
    ev = tb.merge(1, 2, [(0, 5), (1, 6)])
    assert [e[0] for e in ev] == ["extend_j", "extend_j"]
    assert tb.feature_qid[2][5] == 0
    assert tb.merge(0, 2, [(0, 5)])[0] == ("seen", 0)


def test_trackbook_events_match_the_reference():
    mine, ref = TrackBook(), JTrackBook()
    for i, j, m in MERGES:
        assert mine.merge(i, j, m) == ref.merge(i, j, m)
    assert mine.feature_qid == ref.feature_qid
    assert mine.next_qid == ref.next_qid


# -- marginals ----------------------------------------------------------------


def _plane_graph(b):
    """Four poses on a chain with a prior, two plane landmarks seen from
    three poses each, two points with priors and projections."""
    r = np.random.default_rng(7)
    poses = [np_lie.se3_exp(np.concatenate([r.normal(size=3) * 0.05,
                                            [0.2 * k, 0.0, 0.0]]))
             for k in range(4)]
    for P in poses:
        b.add_pose(P)
    b.add_prior_pose(0, poses[0], sigmas=np.full(6, 1e-3))
    for k in range(3):
        b.add_between(k, k + 1, np_lie.between(poses[k], poses[k + 1]),
                      sigmas=np.full(6, 0.05))
    planes = [np.array([0.0, 0.0, 1.0, -3.0]), np.array([0.1, 1.0, 0.0, 0.8])]
    for m, pl in enumerate(planes):
        b.add_plane(pl)
        for k in (m, m + 1, m + 2):
            R, t = poses[k]
            n_b = R.T @ pl[:3]
            meas = np.concatenate([n_b, [pl[3] + pl[:3] @ t]])
            b.add_plane_factor(k, m, meas + r.normal(size=4) * 0.01,
                               sigma=0.05)
    for q in range(2):
        p = np.array([0.3 * q, 0.1, 2.5])
        b.add_point(p)
        b.add_prior_point(q, p, sigma=0.1)
        for k in range(4):
            R, t = poses[k]
            b.add_projection_factor(k, q, _project(R.T @ (p - t))
                                    + r.normal(size=2), SR4000)
    return b


@pytest.fixture(scope="module")
def plane_marginals():
    gj, vj = _plane_graph(jbuilder.GraphBuilder()).build(bucket=4)
    gt, vt = _plane_graph(GraphBuilder()).build(bucket=4, device="cpu")
    cols = np.array([3, 4, 30, 31, 40])
    return gt, vt, {
        "pose": jmarg.pose_marginal(gj, vj, 2),
        "plane": jmarg.plane_marginal(gj, vj, 1),
        "joint": jmarg.joint_marginal(gj, vj, cols),
        "all": jmarg.pose_marginals_all(gj, vj, 4)}, cols


def test_marginals_match_the_reference(plane_marginals):
    gt, vt, ref, cols = plane_marginals
    for name, mine in (("pose", pose_marginal(gt, vt, 2)),
                       ("plane", plane_marginal(gt, vt, 1)),
                       ("joint", joint_marginal(gt, vt, cols)),
                       ("all", pose_marginals_all(gt, vt, 4))):
        assert mine.shape == ref[name].shape
        assert _rel_err(mine.numpy(), ref[name]) <= 1e-9, name
    lay = layout_of(vt)
    assert lay.plane_off == 24 and lay.point_off == 24 + 3 * 4


def test_batched_matches_per_pose_queries():
    """``tests/test_marginals_out.py`` on the port, and its covariances
    against the reference's."""
    gj, vj, _ = j_make_sphere(n_poses=12, edges_per_pose=3.0, seed=0,
                              bucket=8, dtype=jnp.float64)
    gt = convert.graph_from_numpy(_np_tree(gj), device="cpu")
    vt = convert.arena_from_numpy(_np_tree(vj), device="cpu")
    n = 12
    covs = pose_marginals_all(gt, vt, n).numpy()
    assert covs.shape == (n, 6, 6)
    assert _rel_err(covs, jmarg.pose_marginals_all(gj, vj, n)) <= 1e-9
    for idx in (0, 3, 11):
        single = pose_marginal(gt, vt, idx).numpy()
        np.testing.assert_allclose(covs[idx], single, rtol=1e-5, atol=1e-8)
    eps = float(np.finfo(covs.dtype).eps)
    for k in range(n):
        tol = 200.0 * eps * max(float(np.abs(covs[k]).max()), 1.0)
        np.testing.assert_allclose(covs[k], covs[k].T, atol=tol)
        assert np.linalg.eigvalsh(covs[k]).min() > -1e-8
    assert np.trace(covs[0]) < np.trace(covs[6])


def test_marginals_log_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    A = rng.normal(size=(4, 6, 6))
    covs = A @ np.transpose(A, (0, 2, 1))
    ids = np.array([0, 1, 2, 5])
    path = str(tmp_path / "marginals.log")
    write_marginals(path, ids, covs)
    ids2, covs2 = read_marginals(path)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_allclose(covs, covs2, rtol=0, atol=1e-12)


def test_marginal_of_a_singular_hessian_is_nan():
    b = GraphBuilder()
    b.add_pose((np.eye(3), np.zeros(3)))
    b.add_pose((np.eye(3), np.ones(3)))
    b.add_prior_pose(0, (np.eye(3), np.zeros(3)), sigma=0.1)
    gt, vt = b.build(bucket=2, device="cpu")    # pose 1 unconstrained
    assert torch.isnan(pose_marginal(gt, vt, 1)).all()


# -- run_ba_imu ---------------------------------------------------------------


def _scene(n_frames, seed, lm_seed, n_lm, noise_px=0.0):
    """``tests/test_pipelines2.py``'s BA scenes: ``test_vio.simulate``'s
    trajectory and IMU, landmarks projected by the port's camera, with
    ``noise_px`` of pixel noise."""
    sys.path.insert(0, "tests")
    from test_vio import simulate

    log, img_times, stream, params, X, V, _ = simulate(
        n_frames=n_frames, seed=seed, fail_frame=-1)
    r = np.random.default_rng(lm_seed)
    W = np.stack([r.uniform(-2, 2, n_lm), r.uniform(-2, 2, n_lm),
                  r.uniform(2.5, 5, n_lm)], axis=1)
    frames = []
    for f in range(n_frames):
        R, t = np.asarray(X[f].R), np.asarray(X[f].t)
        local = (W - t) @ R
        uv = _project(local) + r.normal(size=(n_lm, 2)) * noise_px
        frames.append({"uv": uv, "pts3": local})
    mine = ImuStream(t=np.asarray(stream.t), acc=np.asarray(stream.acc),
                     gyr=np.asarray(stream.gyr), dt=stream.dt)
    p = convert.imu_params_from_numpy(_np_tree(params), device="cpu")
    return frames, img_times, (stream, params), (mine, p), X


IMU_CFG = dict(use_imu=True, solver="schur", schur_iters=8, bucket=16)
LM_CFG = dict(use_imu=False, solver="lm", bucket=16)


def _matches(n):
    return lambda i, j: [(k, k) for k in range(n)]


@pytest.fixture(scope="module")
def noisy_refs():
    """Both scenes with 0.5 px of noise, and the JAX package's runs."""
    out = {}
    for name, args, n, cfg in (("imu", (6, 5, 6, 25), 25, IMU_CFG),
                               ("lm", (5, 7, 8, 20), 20, LM_CFG)):
        frames, times, jimu, timu, _ = _scene(*args, noise_px=0.5)
        ref = j_run_ba_imu(frames, _matches(n), times,
                           *(jimu if cfg["use_imu"] else (None, None)),
                           J_SR4000, cfg=JBaImuConfig(**cfg))
        out[name] = (frames, times, timu, n, cfg, ref)
    return out


@pytest.mark.parametrize("name", ["imu", "lm"])
def test_ba_imu_matches_the_reference(noisy_refs, name):
    frames, times, timu, n, cfg, ref = noisy_refs[name]
    res = run_ba_imu(frames, _matches(n), times,
                     *(timu if cfg["use_imu"] else (None, None)), SR4000,
                     cfg=BaImuConfig(**cfg), device="cpu")
    assert (res.n_landmarks, res.n_projection_factors,
            res.n_imu_factors) == (ref.n_landmarks, ref.n_projection_factors,
                                   ref.n_imu_factors)
    assert abs(res.error0 - ref.error0) <= 1e-8 * ref.error0
    assert abs(res.error - ref.error) <= 1e-8 * ref.error
    assert res.error < res.error0
    for f in ("pose_t", "pose_R", "vel", "bias", "point"):
        np.testing.assert_allclose(getattr(res.values, f).numpy(),
                                   np.asarray(getattr(ref.values, f)),
                                   rtol=0, atol=1e-8, err_msg=f)


def test_ba_imu_recovers_trajectory():
    """``TestBaImu.test_ba_imu_recovers_trajectory`` on the port."""
    frames, times, _, timu, X = _scene(6, 5, 6, 25)
    res = run_ba_imu(frames, _matches(25), times, *timu, SR4000,
                     cfg=BaImuConfig(**IMU_CFG), device="cpu")
    assert res.n_landmarks == 25 and res.n_imu_factors == 5
    assert res.error < 1e-3
    for f in range(6):
        np.testing.assert_allclose(res.values.pose_t[f].numpy(),
                                   np.asarray(X[f].t), atol=2e-2)


def test_ba_imu_in_float32_runs_the_sqrt_schur(monkeypatch):
    """The same scene in a float32 arena goes through the square-root
    Schur, not the normal equations, and meets the same bars."""
    from graph_slam_tpu_torch.pipelines import ba_imu

    frames, times, _, timu, X = _scene(6, 5, 6, 25)
    called = []
    for name in ("ba_gn_optimize", "ba_gn_optimize_sqrt", "lm_optimize"):
        fn = getattr(ba_imu, name)
        monkeypatch.setattr(ba_imu, name, lambda *a, _f=fn, _n=name, **k: (
            called.append(_n), _f(*a, **k))[1])
    res = run_ba_imu(frames, _matches(25), times, *timu, SR4000,
                     cfg=BaImuConfig(**IMU_CFG), device="cpu",
                     dtype=torch.float32)
    assert called == ["ba_gn_optimize_sqrt"]
    assert res.values.pose_t.dtype == torch.float32
    assert np.isfinite(res.error) and res.error < 1e-3
    for f in range(6):
        np.testing.assert_allclose(res.values.pose_t[f].numpy(),
                                   np.asarray(X[f].t), atol=2e-2)


def test_ba_without_imu():
    """``TestBaImu.test_ba_without_imu`` on the port."""
    frames, times, _, _, _ = _scene(5, 7, 8, 20)
    res = run_ba_imu(frames, _matches(20), times, None, None, SR4000,
                     cfg=BaImuConfig(**LM_CFG), device="cpu")
    assert res.error < 1e-2
    assert res.n_imu_factors == 0 and res.n_landmarks == 20


def test_sharded_ba_imu_matches_the_reference():
    """``BaImuConfig(sharded=2)``: the landmark-sharded square-root Schur
    on two gloo ranks, against the JAX package's on ``make_mesh(2)`` (the
    same scene as ``noisy_refs``' "imu", with the same bars)."""
    frames, times, jimu, timu, _ = _scene(6, 5, 6, 25, noise_px=0.5)
    ref = j_run_ba_imu(frames, _matches(25), times, *jimu, J_SR4000,
                       cfg=JBaImuConfig(**IMU_CFG, sharded=2))
    res = run_ba_imu(frames, _matches(25), times, *timu, SR4000,
                     cfg=BaImuConfig(**IMU_CFG, sharded=2), device="cpu")
    assert (res.n_landmarks, res.n_projection_factors,
            res.n_imu_factors) == (ref.n_landmarks, ref.n_projection_factors,
                                   ref.n_imu_factors)
    assert res.values.pose_t.dtype == torch.float64
    assert abs(res.error0 - ref.error0) <= 1e-8 * ref.error0
    assert abs(res.error - ref.error) <= 1e-8 * ref.error
    assert res.error < res.error0
    for f in ("pose_t", "pose_R", "vel", "bias", "point"):
        np.testing.assert_allclose(getattr(res.values, f).numpy(),
                                   np.asarray(getattr(ref.values, f)),
                                   rtol=0, atol=1e-8, err_msg=f)


def test_sharded_ba_imu_with_a_long_track_warns_and_solves_alone(
        monkeypatch):
    """A track longer than ``_SQRT_MAX_TRACK`` keeps the mesh idle, with
    the reference's warning, and the dtype's own solver runs."""
    from graph_slam_tpu_torch.pipelines import ba_imu

    frames, times, _, timu, _ = _scene(6, 5, 6, 25)
    monkeypatch.setattr(ba_imu, "_SQRT_MAX_TRACK", 2)
    called = []
    for name in ("ba_gn_optimize", "ba_gn_optimize_sqrt", "lm_optimize"):
        fn = getattr(ba_imu, name)
        monkeypatch.setattr(ba_imu, name, lambda *a, _f=fn, _n=name, **k: (
            called.append(_n), _f(*a, **k))[1])
    with pytest.warns(UserWarning, match="--sharded mesh will sit idle"):
        res = run_ba_imu(frames, _matches(25), times, *timu, SR4000,
                         cfg=BaImuConfig(**IMU_CFG, sharded=2), device="cpu")
    assert called == ["ba_gn_optimize"]
    assert res.error < 1e-3
