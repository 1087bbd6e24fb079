"""Parity of the port's ``OnlineSlam`` with the JAX package, on the CPU,
and the cases of ``tests/test_pipelines2.py`` (``TestOnlineSlam``,
``TestArenaGrowth``, ``TestG2oBackend``), ``test_place.py``'s online
cases and ``test_sift.py::test_online_slam_with_sift`` on the port.

Each scenario is a sequence of ``render_wall_frame`` SR4000 frames (exact
depth) fed to both packages with the same settings, shared through
module-scoped fixtures. The RANSAC draws differ between the packages (the
port keys its own), so parity is held where exact frames make the answer
independent of the draw: the same consensus sets.

Tolerances: statuses, keyframe counts and edge rows (ids, which rows are
active) equal; each row's tangent within 1e-5 and its information within
1e-5 relative (float32 RANSAC refits); the optimized trajectory within
1e-5 m and its quaternions within 1e-5; chi2 within 1e-3 relative (the
measurements are float32, and chi2 at ~1e-2 is their rounding).
"""

import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from test_pipelines2 import render_wall_frame

from graph_slam_tpu.config import SlamParams as JSlamParams
from graph_slam_tpu.pipelines import OnlineSlam as JOnlineSlam
from graph_slam_tpu_torch.config import SR4000, SlamParams
from graph_slam_tpu_torch.io import read_vro_log
from graph_slam_tpu_torch.pipelines import FrameStatus, OnlineSlam

CPU = "cpu"
# TestOnlineSlam's five frames and one more
TRANSLATING = [0.0, 0.12, 0.24, 0.245, 0.36, 0.48]
REVISIT = [0.0, 0.2, 0.4, 0.6, 0.8, 0.6, 0.4, 0.2, 0.0]   # test_place


def _frames(xs):
    return [render_wall_frame(SR4000, np.array([x, 0.0, 0.0])) for x in xs]


def _run_both(xs, params, **kw):
    """(jax session, port session, jax statuses, port statuses), each fed
    the same frames with the same settings."""
    js = JOnlineSlam(cam=SR4000, params=JSlamParams(**params), **kw)
    ts = OnlineSlam(cam=SR4000, params=SlamParams(**params), device=CPU,
                    **kw)
    sj, st = [], []
    for k, (img, depth) in enumerate(_frames(xs)):
        sj.append(js.process_frame(img, depth, seq_id=k))
        st.append(ts.process_frame(img, depth, seq_id=k))
    return js, ts, sj, st


@pytest.fixture(scope="module")
def translating():
    js, ts, sj, st = _run_both(TRANSLATING, dict(optimize_step=100),
                               n_hyp=512, min_inliers=10)
    return js, ts, sj, st, js.optimize(), ts.optimize()


@pytest.fixture(scope="module")
def revisit():
    js, ts, sj, st = _run_both(
        REVISIT, dict(lookback_nodes=2, optimize_step=100,
                      small_translation=0.05),
        max_features=128, min_inliers=10, initial_pose_cap=16,
        global_loop_k=2, global_loop_min_gap=4)
    return js, ts, sj, st, js.optimize(), ts.optimize()


def _edge_rows(slam):
    bt = slam.og.graph.between
    act = np.asarray(bt.active)
    return np.asarray(bt.i)[act], np.asarray(bt.j)[act]


def _check_parity(run):
    js, ts, sj, st, ej, et = run
    assert st == sj
    assert ts.num_keyframes == js.num_keyframes
    assert ts.seq_ids == js.seq_ids
    for a, b in zip(_edge_rows(ts), _edge_rows(js)):
        np.testing.assert_array_equal(a, b)
    lj, lt = js.vro_log(), ts.vro_log()
    np.testing.assert_array_equal(lt.id_to, lj.id_to)
    np.testing.assert_array_equal(lt.id_from, lj.id_from)
    np.testing.assert_allclose(lt.xi, lj.xi, atol=1e-5)
    np.testing.assert_allclose(lt.info, lj.info, rtol=1e-5,
                               atol=1e-5 * np.abs(lj.info).max())
    _, tj, qj, seq_j = js.trajectory()
    _, tt, qt, seq_t = ts.trajectory()
    np.testing.assert_array_equal(seq_t, seq_j)
    np.testing.assert_allclose(tt, tj, atol=1e-5)
    np.testing.assert_allclose(qt, qj, atol=1e-5)
    assert et == pytest.approx(ej, rel=1e-3)
    assert ts.chi2_log.rows[-1][3] == et


@pytest.mark.parametrize("scenario", ["translating", "revisit"])
def test_online_slam_matches_jax(scenario, request):
    _check_parity(request.getfixturevalue(scenario))


def test_translating_camera(translating):
    """``test_pipelines2.py::TestOnlineSlam::test_translating_camera`` on
    the port, with a sixth frame."""
    _, slam, _, statuses, _, err = translating
    assert statuses == [FrameStatus.FIRST, FrameStatus.KEYFRAME,
                        FrameStatus.KEYFRAME, FrameStatus.SMALL_MOTION,
                        FrameStatus.KEYFRAME, FrameStatus.KEYFRAME]
    assert err < 1.0
    ids, t, q, seq = slam.trajectory()
    for k, ex in enumerate([0.0, 0.12, 0.24, 0.36, 0.48]):
        assert abs(t[k, 0] - ex) < 0.03, (k, t[k], ex)
        assert abs(t[k, 1]) < 0.02 and abs(t[k, 2]) < 0.02
    log = slam.vro_log()
    assert len(log) >= 3 and log.valid.all()


def test_vro_log_and_trajectory_outputs(translating):
    js, ts, *_ = translating
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vro.log")
        ts.save_vro_log(path)
        back = read_vro_log(path)
    np.testing.assert_array_equal(back.id_to, ts.vro_log().id_to)
    np.testing.assert_allclose(back.xi, ts.vro_log().xi, atol=1e-6)
    w2o = (np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]),
           np.array([1.0, 2.0, 3.0]))
    from graph_slam_tpu.core import se3 as jse3
    import jax.numpy as jnp

    _, tj, qj, _ = js.trajectory(jse3.Pose(jnp.asarray(w2o[0]),
                                           jnp.asarray(w2o[1])))
    _, tt, qt, _ = ts.trajectory(w2o)
    np.testing.assert_allclose(tt, tj, atol=1e-5)
    np.testing.assert_allclose(qt, qj, atol=1e-5)


def test_global_loop_closure(revisit):
    """``test_place.py::test_online_slam_global_loop_closure`` on the
    port: a revisit after an excursion longer than the lookback window
    gets a long-range edge only through the global tier."""
    _, slam, *_ = revisit
    assert slam.num_keyframes == len(REVISIT)
    i, j = _edge_rows(slam)
    assert (j - i).max() >= 4, "no long-range loop closure was added"
    t0 = slam.og.pose(0).t.numpy()
    t8 = slam.og.pose(8).t.numpy()
    assert np.linalg.norm(t8 - t0) < 0.05


def test_global_tier_off_by_default():
    slam = OnlineSlam(cam=SR4000, params=SlamParams(), device=CPU)
    assert slam._places is None


def test_bucket_crossing_growth_preserves_state():
    """``test_pipelines2.py::TestArenaGrowth`` on the port: keyframes
    beyond the initial arena capacity re-home the arenas, and the
    optimized trajectory is the one a large enough arena gives."""
    xs = [0.0, 0.10, 0.20, 0.30, 0.40, 0.50, 0.60]
    runs = []
    for cap in (4, 16):
        slam = OnlineSlam(cam=SR4000, params=SlamParams(optimize_step=100),
                          n_hyp=256, min_inliers=10, initial_pose_cap=cap,
                          device=CPU)
        for img, depth in _frames(xs):
            slam.process_frame(img, depth)
        assert slam.num_keyframes == len(xs)
        assert slam.og.values.pose_R.shape[0] >= len(xs)
        assert slam.optimize() < 1.0
        runs.append(slam.trajectory()[1])
    for k, x in enumerate(xs):
        assert abs(runs[0][k, 0] - x) < 0.04, (k, runs[0][k, 0], x)
    np.testing.assert_allclose(runs[0], runs[1], atol=1e-9)


@pytest.fixture(scope="module")
def g2o_backend():
    """``TestG2oBackend``'s two frames (a wall, then noise with no depth)
    through both packages."""
    img, depth = render_wall_frame(SR4000, np.array([0.0, 0.0, 0.0]))
    noise = np.random.default_rng(0).uniform(0, 255, size=img.shape).astype(
        np.float32)
    out = []
    for make in (lambda **kw: JOnlineSlam(params=JSlamParams(
            optimize_step=100), **kw),
                 lambda **kw: OnlineSlam(params=SlamParams(
                     optimize_step=100), device=CPU, **kw)):
        slam = make(cam=SR4000, backend="g2o", n_hyp=256, min_inliers=10)
        slam.process_frame(img, depth)
        st = slam.process_frame(noise, np.zeros_like(depth))
        out.append((slam, st, slam.optimize()))
    return out


def test_fake_odo_weighting_and_flat_lm(g2o_backend):
    """``TestG2oBackend::test_fake_odo_weighting_and_flat_lm`` on the
    port, and the reference's numbers."""
    (js, sj, ej), (ts, st, et) = g2o_backend
    assert st == sj == FrameStatus.FAILED
    S = ts.og.graph.between.sqrt_info[0].numpy()
    np.testing.assert_allclose(np.diag(S), np.sqrt(1e-3), rtol=1e-6)
    np.testing.assert_allclose(S, np.asarray(js.og.graph.between.sqrt_info[0]),
                               rtol=1e-12)
    assert np.isfinite(et) and ts.chi2_log.rows[-1][3] == et
    assert et == pytest.approx(ej, rel=1e-9, abs=1e-12)
    assert ts.vro_log().info[0, 0, 0] == js.vro_log().info[0, 0, 0]


def test_online_slam_with_sift():
    """``test_sift.py::test_online_slam_with_sift`` on the port."""
    slam = OnlineSlam(cam=SR4000, params=SlamParams(), features="sift",
                      max_features=128, min_inliers=8, initial_pose_cap=16,
                      device=CPU)
    for k, (img, depth) in enumerate(_frames([0.0, 0.12, 0.24])):
        slam.process_frame(img, depth, seq_id=k)
    assert slam.num_keyframes >= 2
    tj = slam.og.pose(slam.num_keyframes - 1).t.numpy()
    assert abs(tj[0]) > 0.05


def test_phase_timers(translating):
    _, ts, *_ = translating
    summary = ts.timers.summary()
    assert summary["extract"]["calls"] == len(TRANSLATING)
    assert summary["odometry"]["calls"] == len(TRANSLATING) - 1
    assert summary["optimize"]["calls"] == 1
    assert "lookback" in summary


def test_arena_dtype_and_device(translating):
    _, ts, *_ = translating
    assert ts.og.values.pose_t.dtype == torch.float64
    assert ts.frames[0].desc.device.type == "cpu"
    assert jax.numpy.asarray(0.0).dtype == np.float64     # x64, as the
    # reference's sessions above ran
