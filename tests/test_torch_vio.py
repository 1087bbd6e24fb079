"""Parity of the port's VIO scan engine with the JAX package, on the CPU in
float64: the online arenas' row writers, the suffix window and the
fixed-lag windowed GN, the synthetic VIO scenario, ``run_vio(engine="scan",
plane_mode="off")`` end to end (plain, with the chi2 rotation gate, with
gravity initialization, with a camera->IMU extrinsic) and the pose graph
under ``u2c``.

Every full replay uses the reference's table shapes of
``tests/test_vio_scan.py`` (``max_imu_window=32``, and ``bucket=64`` in
the reference) on its ``synth_sequence`` (one failure, one loop closure),
so the JAX replay compiles once per window and gate setting in this
module.

Tolerances, each with its reason:
- row writes, windows, tables, the scenario's log and stream: 1e-12 — the
  same arithmetic, or copies;
- ``windowed_gn``: 1e-9 — a QR solve of the stacked whitened rows (LAPACK
  on both sides, in another order) carries the rounding of a condition
  number ~1e6;
- the replay: poses, velocities and biases atol 1e-8, chi2 1e-8 relative
  (floored at 1), the scan-engine gate of ``tests/test_vio_scan.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_slam_tpu.core import extrinsics as jext
from graph_slam_tpu.datasets import synthetic as jsynth
from graph_slam_tpu.graph import online as jonline
from graph_slam_tpu.pipelines import posegraph as jpg
from graph_slam_tpu.pipelines.vio import VioConfig as JVioConfig
from graph_slam_tpu.pipelines.vio import run_vio as j_run_vio
from graph_slam_tpu_torch import convert
from graph_slam_tpu_torch.core import extrinsics, se3
from graph_slam_tpu_torch.datasets import make_vio_plane_scenario
from graph_slam_tpu_torch.graph import online, total_error
from graph_slam_tpu_torch.imu import ImuStream
from graph_slam_tpu_torch.io import VROLog
from graph_slam_tpu_torch.pipelines import (VioConfig, build_pose_graph,
                                            run_vio)
from test_vio_scan import synth_sequence

torch.set_num_threads(1)

KW = dict(engine="scan", plane_mode="off", optimize_step=10,
          max_imu_window=32)
JKW = dict(KW, bucket=64)    # the reference's arena growth step


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def seq():
    log, times, stream, params, _ = synth_sequence()
    return log, times, stream, params


def _port_inputs(log, stream, params):
    return (VROLog(log.id_to, log.id_from, log.xi, log.info),
            ImuStream(t=stream.t, acc=stream.acc, gyr=stream.gyr,
                      dt=stream.dt),
            convert.imu_params_from_numpy(jax.tree.map(np.asarray, params),
                                          device="cpu"))


def _ref_stream(stream):
    return dataclasses.replace(stream, start=0)


def _replays(seq, u2c_pitch=None, **cfg):
    """The same replay through both packages."""
    log, times, stream, params = seq
    ju2c = tu2c = None
    if u2c_pitch is not None:
        ju2c = jext.camera_to_imu(u2c_pitch)
        tu2c = extrinsics.camera_to_imu(u2c_pitch, device="cpu")
    ref = j_run_vio(log, dict(times), _ref_stream(stream), params, u2c=ju2c,
                    cfg=JVioConfig(**JKW, **cfg))
    tlog, tstream, tparams = _port_inputs(log, stream, params)
    port = run_vio(tlog, dict(times), tstream, tparams, u2c=tu2c,
                   cfg=VioConfig(**KW, **cfg), device="cpu")
    return port, ref


def _assert_replay(port, ref):
    assert port.n_imu_factors == ref.n_imu_factors
    assert port.n_vo_edges == ref.n_vo_edges
    np.testing.assert_array_equal(port.seq_ids, ref.seq_ids)
    n = len(ref.seq_ids)
    for f in ("pose_R", "pose_t", "vel", "bias"):
        np.testing.assert_allclose(_np(getattr(port.values, f))[:n],
                                   np.asarray(getattr(ref.values, f))[:n],
                                   rtol=0, atol=1e-8, err_msg=f)
    for a, b in ((port.error0, ref.error0), (port.error, ref.error)):
        assert abs(a - b) <= 1e-8 * max(1.0, abs(b)), (a, b)
    assert len(port.chi2_log.rows) == len(ref.chi2_log.rows)
    for a, b in zip(port.chi2_log.rows, ref.chi2_log.rows):
        assert a[:2] == b[:2]
        assert abs(a[3] - b[3]) <= 1e-8 * max(1.0, abs(b[3])), (a, b)
    assert all(np.isfinite(_np(x)).all() for x in port.values[:4])


def _noisy(seq, sigma=1e-3, seed=7):
    """``seq`` with every edge's twist perturbed, so the chi2 rotation
    gate's statistics spread over orders of magnitude (the exact log's sit
    at the rounding floor)."""
    log, times, stream, params = seq
    r = np.random.default_rng(seed)
    xi = np.asarray(log.xi) + r.normal(size=np.shape(log.xi)) * sigma
    return dataclasses.replace(log, xi=xi), times, stream, params


@pytest.mark.parametrize("window,final_batch,gate", [
    (None, False, None), (None, True, None), (12, False, None),
    (12, True, None),
    # the chi2 gate on a noisy log: 0.3 fails some new-frame edges and
    # passes others, 4e4 passes them all
    (12, False, 0.3), (12, False, 4e4)])
def test_run_vio_scan_matches_reference(seq, window, final_batch, gate):
    cfg = dict(window=window, final_batch=final_batch)
    if gate is not None:
        seq = _noisy(seq)
        cfg.update(chi2_vro_gate=True, chi2_threshold=gate)
    port, ref = _replays(seq, **cfg)
    _assert_replay(port, ref)
    assert len(port.chi2_log.rows) == 4 + 1   # 40 frames, every 10, final
    assert port.plane_book is None and port.n_plane_factors == 0
    if gate is not None:
        # 39 new frames, 38 of their edges valid, 1 loop closure
        valid_new = int(port.graph.between.active.sum()) - 1
        assert (0 < valid_new < 38) if gate < 1.0 else valid_new == 38


def test_run_vio_gravity_init(seq):
    _assert_replay(*_replays(seq, window=12, final_batch=False,
                             gravity_init=True))


def test_run_vio_camera_to_imu(seq):
    _assert_replay(*_replays(seq, u2c_pitch=0.2, window=12,
                             final_batch=False))


def test_rescue_without_a_source_is_plane_free(seq):
    log, times, stream, params = seq
    runs = []
    for mode in ("off", "rescue"):
        tlog, tstream, tparams = _port_inputs(log, stream, params)
        runs.append(run_vio(tlog, dict(times), tstream, tparams,
                            cfg=VioConfig(**dict(KW, plane_mode=mode),
                                          window=12, final_batch=False),
                            device="cpu"))
    np.testing.assert_array_equal(_np(runs[0].values.pose_t),
                                  _np(runs[1].values.pose_t))


@pytest.mark.parametrize("cfg,kwargs,err,match", [
    (dict(engine="online"), {"frames": lambda seq: None}, ValueError,
     "intrinsics"),
    (dict(engine="scan", plane_mode="rescue", chi2_vro_gate=True),
     {"plane_obs_provider": lambda seq: []}, ValueError, "chi2_vro_gate"),
    (dict(engine="scan", plane_mode="always"), {}, ValueError, "always"),
    (dict(engine="scan", feedback=False), {}, ValueError, "feedback"),
    (dict(engine="bogus"), {}, ValueError, "unknown engine"),
])
def test_run_vio_unported_and_invalid(seq, cfg, kwargs, err, match):
    log, times, stream, params = seq
    tlog, tstream, tparams = _port_inputs(log, stream, params)
    with pytest.raises(err, match=match):
        run_vio(tlog, dict(times), tstream, tparams, cfg=VioConfig(**cfg),
                device="cpu", **kwargs)


@pytest.fixture(scope="module")
def ref_state(seq):
    """A replayed graph and arena from the reference (window 12, no final
    batch), carried into the port."""
    _, ref = _replays(seq, window=12, final_batch=False)
    g = jax.tree.map(np.asarray, ref.graph)
    v = jax.tree.map(np.asarray, ref.values)
    return (ref.graph, ref.values, convert.graph_from_numpy(g, device="cpu"),
            convert.arena_from_numpy(v, device="cpu"))


def test_window_graph_and_windowed_gn_mid_trajectory(ref_state):
    gj, vj, gt, vt = ref_state
    # a window over frames 15..26: the suffix starts of the reference's
    # per-table caps (4, 96, 4, 4, 0, 12, 0, 0) at 27 frames
    caps = (4, 96, 4, 4, 0, 12, 0, 0)
    starts = [0, 0, 0, 0, 0, 14, 0, 0]
    free_from = [15, 15, 15, 0, 0]
    wj = jonline.window_graph(gj, jnp.asarray(starts, jnp.int32), caps)
    wt = online.window_graph(gt, starts, caps)
    for tj, tt in zip(wj, wt):
        for a, b in zip(tt, tj):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_array_equal(
        _np(online._free_mask(vt, free_from)),
        np.asarray(jonline._free_mask(vj, jnp.asarray(free_from,
                                                      jnp.int32))))
    # perturb the free window so the step has work to do
    r = np.random.default_rng(3)
    dp = r.normal(size=(12, 3)) * 0.01
    vj = vj._replace(pose_t=vj.pose_t.at[15:27].add(jnp.asarray(dp)))
    vt = vt._replace(pose_t=vt.pose_t.clone())
    vt.pose_t[15:27] += torch.as_tensor(dp)
    ref_v, ref_e = jonline.windowed_gn(wj, vj, jnp.asarray(free_from,
                                                           jnp.int32),
                                       (12, 12, 12), 1e-6, 2)
    v, e = online.windowed_gn(wt, vt, free_from, (12, 12, 12), 1e-6, 2)
    for f in ("pose_R", "pose_t", "vel", "bias"):
        np.testing.assert_allclose(_np(getattr(v, f)),
                                   np.asarray(getattr(ref_v, f)), rtol=0,
                                   atol=1e-9, err_msg=f)
    assert abs(float(e) - float(ref_e)) <= 1e-9 * max(1.0, float(ref_e))
    # frozen poses did not move
    np.testing.assert_array_equal(_np(v.pose_t)[:15], _np(vt.pose_t)[:15])


def test_row_writers_match_reference(ref_state):
    gj, _, gt, _ = ref_state
    r = np.random.default_rng(4)
    A = r.normal(size=(15, 15))
    cov = A @ A.T + np.eye(15)
    args = [r.normal(size=s) for s in ((3, 3), (3,), (3,), (3, 3), (3, 3),
                                       (3, 3), (3, 3), (3, 3), (6,))]
    ref = jonline.imu_row(gj.imu, 3, 1, 2, *map(jnp.asarray, args),
                          jnp.asarray(0.1), jnp.asarray([0.0, 0.0, -9.81]),
                          jnp.asarray(cov), active=False)
    imu = gt.imu._replace(**{f: x.clone() for f, x in gt.imu._asdict()
                             .items()})
    port = online.imu_row(imu, 3, 1, 2, *map(torch.as_tensor, args),
                          torch.tensor(0.1, dtype=torch.float64),
                          torch.tensor([0.0, 0.0, -9.81], dtype=torch.float64),
                          torch.as_tensor(cov), active=False)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-12,
                                   atol=1e-14)
    bt = gt.between._replace(**{f: x.clone() for f, x in gt.between
                                ._asdict().items()})
    S = np.triu(r.normal(size=(6, 6)))
    ref = jonline.between_row(gj.between, 5, 2, 7, jnp.eye(3),
                              jnp.ones(3), jnp.asarray(S), 1, 0.5)
    port = online.between_row(bt, 5, 2, 7, torch.eye(3, dtype=torch.float64),
                              torch.ones(3, dtype=torch.float64),
                              torch.as_tensor(S), 1, 0.5)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_online_graph_writes_in_place():
    from graph_slam_tpu_torch.graph import empty_arena, empty_graph

    og = online.OnlineGraph(empty_graph(1, 2, 1, 1, imu_cap=1, device="cpu"),
                            empty_arena(4, 4, 4, device="cpu"))
    pose_t = og.values.pose_t
    og.set_pose(1, se3.Pose(torch.eye(3, dtype=torch.float64),
                            torch.ones(3, dtype=torch.float64)))
    og.set_vel(1, np.ones(3))
    og.set_bias(2, np.ones(6), new=False)
    og.add_between(0, 1, og.pose(1), np.eye(6), robust=1.5)
    assert og.values.pose_t is pose_t and float(pose_t[1].sum()) == 3.0
    assert int(og.values.num_poses) == 2 == og.num_poses
    assert int(og.values.num_biases) == 2 and og.num_biases == 0
    assert bool(og.graph.between.active[0])
    assert float(og.graph.between.robust_k[0]) == 1.5
    og.add_between(1, 2, og.pose(1), np.eye(6))
    with pytest.raises(RuntimeError, match="full"):
        og.add_between(1, 2, og.pose(1), np.eye(6))
    assert og.error() == float(total_error(og.graph, og.values))


def test_vio_plane_scenario_matches_reference():
    ref = jsynth.make_vio_plane_scenario(n_frames=40, render=False,
                                         return_gt=True)
    port = make_vio_plane_scenario(n_frames=40, render=False, return_gt=True,
                                   device="cpu")
    (jl, jtimes, js, jp, jf, jK, (jR, jt)) = ref
    (tl, ttimes, ts_, tp, tf, tK, (tR, tt)) = port
    assert jf is None and tf is None and ttimes == jtimes
    assert dataclasses.astuple(tK) == dataclasses.astuple(jK)
    for f in ("id_to", "id_from"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f))
    for a, b in ((tl.xi, jl.xi), (tl.info, jl.info), (ts_.t, js.t),
                 (ts_.acc, js.acc), (ts_.gyr, js.gyr), (tR, jR), (tt, jt)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12)
    assert ts_.dt == js.dt
    for f in jp._fields:
        np.testing.assert_array_equal(_np(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)))


def test_pose_graph_under_camera_to_imu(seq):
    log = seq[0]
    gj, vj, sj = jpg.build_pose_graph(log, u2c=jext.camera_to_imu(0.3),
                                      bucket=64)
    tlog = VROLog(log.id_to, log.id_from, log.xi, log.info)
    gt, vt, st = build_pose_graph(tlog, bucket=64,
                                  u2c=extrinsics.camera_to_imu(
                                      0.3, device="cpu"), device="cpu")
    np.testing.assert_array_equal(st, sj)
    for name in ("prior_pose", "between"):
        for a, b in zip(getattr(gt, name), getattr(gj, name)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-12,
                                       atol=1e-12)
    np.testing.assert_allclose(_np(vt.pose_t), np.asarray(vj.pose_t),
                               atol=1e-12)


def test_trace_and_chi2_log(tmp_path):
    """``VioConfig.trace_dir`` writes a ``torch.profiler`` Chrome trace of
    the replay; the chi2 log writes one JSON record per update."""
    import json

    log, times, stream, params, _, _ = make_vio_plane_scenario(
        12, render=False, device="cpu")
    res = run_vio(log, times, stream, params, device="cpu",
                  cfg=VioConfig(**dict(KW, max_imu_window=24), window=4,
                                final_batch=False,
                                trace_dir=str(tmp_path / "trace")))
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    assert any(str(e.get("name", "")).startswith("aten::")
               for e in trace["traceEvents"])
    res.chi2_log.write(str(tmp_path / "chi2.jsonl"))
    rows = [json.loads(line) for line in open(tmp_path / "chi2.jsonl")]
    assert [r["nodes"] for r in rows] == [10, 12]
    assert rows[-1]["chi2_before"] == res.error0
    assert res.timers["replay_scan"]["calls"] == 1
