"""Parity of the port's online VIO engine, ``run_vio(engine="online")`` (the
default), with the JAX package's on the CPU in float64, without planes;
and of its parts: ``IncrementalOptimizer``, ``OnlineGraph.grow``/
``set_plane``/``add_plane_factor`` and checkpoints. The plane modes, the
synchronous ``predict_plane_node`` and the online engine against the scan
engine are in ``tests/test_torch_online_planes.py``, which takes this
file's replay helpers.

Replays, each through both packages on the same numpy inputs: the 40-frame
``synth_sequence`` of ``tests/test_vio_scan.py`` (one failed edge, one
loop closure) with every edge's twist perturbed by 1e-3, so that every
update has work to do: the fast path (no plane stack) with the dense
full-arena update, windows 4 and 12, the chi2 gate at 0.3 (fails some
edges) and 4e4, gravity initialization, Huber and a camera -> IMU
extrinsic; the PCG full-arena update on the exact log (the case says
why); and the slow path (a provider with ``plane_mode="off"``) with the
gate at 0.3, where a gated edge writes no between row. Every replay has the same table shapes
(``bucket=64``, an IMU window of 32), so the JAX package compiles each
program once.

Tolerances, each with its reason:
- replays: poses, velocities and biases atol 1e-8, ``error0``, ``error``
  and every chi2 log row 1e-8 relative (floored at 1), the scan-engine
  gate of ``tests/test_vio_scan.py``; the factor tables row by row:
  indices and ``active`` equal, measurements and sqrt-information 1e-8
  (absolute or relative); counts equal;
- ``IncrementalOptimizer.update``: 1e-9 per update (a dense Cholesky, a
  PCG or a QR, LAPACK on both sides in another order);
- ``grow``, the one-row writers and a JAX checkpoint loaded in the port:
  bit-equal; a port checkpoint resumed: bit-equal to the uninterrupted run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import np_lie
from graph_slam_tpu.core import extrinsics as jext
from graph_slam_tpu.core import se3 as jse3
from graph_slam_tpu.graph import factors as jfactors
from graph_slam_tpu.graph import online as jonline
from graph_slam_tpu.graph.variables import empty_arena as j_empty_arena
from graph_slam_tpu.pipelines.vio import VioConfig as JVioConfig
from graph_slam_tpu.pipelines.vio import run_vio as j_run_vio
from graph_slam_tpu_torch import convert
from graph_slam_tpu_torch.config import SR4000
from graph_slam_tpu_torch.core import extrinsics, se3
from graph_slam_tpu_torch.graph import factors, online
from graph_slam_tpu_torch.graph.variables import empty_arena
from graph_slam_tpu_torch.imu import ImuStream
from graph_slam_tpu_torch.io import VROLog
from graph_slam_tpu_torch.pipelines import VioConfig, run_vio
from test_online_engine import INFO_SQRT, corridor_sequence
from test_vio_scan import synth_sequence

torch.set_num_threads(1)

TOL = 1e-8


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _port(log, times, stream, params, cfg, u2c_pitch=None, **sources):
    """A replay of the reference's inputs through the port on the CPU, with
    a camera -> IMU extrinsic pitched by ``u2c_pitch`` (None: identity)."""
    if "intrinsics" in sources:
        sources = dict(sources, intrinsics=SR4000)
    u2c = None if u2c_pitch is None else extrinsics.camera_to_imu(
        u2c_pitch, device="cpu")
    return run_vio(
        VROLog(log.id_to, log.id_from, log.xi, log.info), dict(times),
        ImuStream(t=stream.t, acc=stream.acc, gyr=stream.gyr, dt=stream.dt),
        convert.imu_params_from_numpy(jax.tree.map(np.asarray, params),
                                      device="cpu"),
        u2c=u2c, cfg=VioConfig(**cfg), device="cpu", **sources)


def _both(log, times, stream, params, cfg, u2c_pitch=None, **sources):
    """The same online replay through both packages; ``sources`` are the
    reference's ``frames``/``intrinsics``/``plane_obs_provider``."""
    ref = j_run_vio(log, dict(times), dataclasses.replace(stream, start=0),
                    params, cfg=JVioConfig(**cfg),
                    u2c=None if u2c_pitch is None
                    else jext.camera_to_imu(u2c_pitch), **sources)
    return _port(log, times, stream, params, cfg, u2c_pitch,
                 **sources), ref


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


def _assert_tables(port, ref, names=("between", "imu", "plane"), tol=TOL):
    """The factor tables row by row, as wide as both are: indices and
    ``active`` equal, floating fields within ``tol``, absolute or relative
    (the sqrt-information of an IMU row reaches 1e5)."""
    for name in names:
        tt, tj = getattr(port.graph, name), getattr(ref.graph, name)
        n = min(tt[0].shape[0], tj[0].shape[0])
        for f in tt._fields:
            a, b = _np(getattr(tt, f))[:n], _np(getattr(tj, f))[:n]
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f}")
            else:
                np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                           err_msg=f"{name}.{f}")


def _assert_replay(port, ref, tol=TOL, chi2_tol=TOL):
    assert (port.n_imu_factors, port.n_vo_edges, port.n_plane_factors) == \
        (ref.n_imu_factors, ref.n_vo_edges, ref.n_plane_factors)
    np.testing.assert_array_equal(port.seq_ids, ref.seq_ids)
    n = len(ref.seq_ids)
    for f in ("pose_R", "pose_t", "vel", "bias"):
        np.testing.assert_allclose(_np(getattr(port.values, f))[:n],
                                   _np(getattr(ref.values, f))[:n], rtol=0,
                                   atol=tol, err_msg=f)
    for a, b in ((port.error0, ref.error0), (port.error, ref.error)):
        assert _rel(a, b) <= chi2_tol, (a, b)
    assert len(port.chi2_log.rows) == len(ref.chi2_log.rows)
    for a, b in zip(port.chi2_log.rows, ref.chi2_log.rows):
        assert a[:2] == b[:2]
        assert _rel(a[3], b[3]) <= chi2_tol, (a, b)
    if ref.plane_book is not None:
        k = len(ref.plane_book.world)
        assert len(port.plane_book.world) == k
        assert port.plane_book.node_landmarks == ref.plane_book.node_landmarks
        assert port.plane_book.seen_count == ref.plane_book.seen_count
        np.testing.assert_allclose(_np(port.values.plane)[:k],
                                   _np(ref.values.plane)[:k], atol=tol)


# -- the 40-frame sequence ------------------------------------------------------

SEQ_KW = dict(engine="online", optimize_step=10, max_imu_window=32, bucket=64)


@pytest.fixture(scope="module")
def exact_seq():
    log, times, stream, params, _ = synth_sequence()
    return log, times, stream, params


@pytest.fixture(scope="module")
def seq(exact_seq):
    """``synth_sequence`` with every edge's twist moved by 1e-3 (seed 7)."""
    log, times, stream, params = exact_seq
    r = np.random.default_rng(7)
    xi = np.asarray(log.xi) + r.normal(size=np.shape(log.xi)) * 1e-3
    return dataclasses.replace(log, xi=xi), times, stream, params


@pytest.mark.parametrize("cfg", [
    dict(window=None, final_batch=False),
    # the exact log: on the noisy one the PCG's 100 trips stop far from
    # convergence on the IMU-whitened system, where two right
    # implementations' iterates part by amplified rounding (measured
    # 2.3e-3 m at 100 trips, 1.9e-5 m at 1,000); the PCG itself is held at
    # 1e-9 by test_incremental_optimizer_matches_reference
    dict(window=None, incremental_solver="pcg", final_batch=False,
         exact=True),
    dict(window=12, chi2_vro_gate=True, chi2_threshold=0.3,
         final_batch=False),
    dict(window=12, chi2_vro_gate=True, chi2_threshold=4e4,
         final_batch=False),
    dict(window=4, robust="huber", final_batch=False),
    dict(window=12, gravity_init=True, final_batch=False),
    dict(window=12, final_batch=False, u2c_pitch=0.2),
], ids=["full-dense", "full-pcg", "gate-0.3", "gate-4e4", "window4-huber",
        "gravity-init", "camera-to-imu"])
def test_fast_path_matches_reference(seq, exact_seq, cfg):
    cfg = dict(cfg)
    log = exact_seq if cfg.pop("exact", False) else seq
    pitch = cfg.pop("u2c_pitch", None)
    port, ref = _both(*log, dict(SEQ_KW, plane_mode="off", **cfg),
                      u2c_pitch=pitch)
    _assert_replay(port, ref)
    _assert_tables(port, ref, ("prior_pose", "prior_vel", "prior_bias",
                               "between", "imu"))
    assert "fused_frame" in port.timers and "new_frame" not in port.timers
    # 39 new frames, one failed edge: the fast path spends a between slot
    # on every record, a failed or gated edge inactive
    active = _np(port.graph.between.active)
    assert port.n_vo_edges == int(active.sum())
    if cfg.get("chi2_threshold") == 0.3:
        assert 1 <= port.n_vo_edges < 38
    elif "chi2_threshold" in cfg:
        assert port.n_vo_edges == 39


def test_slow_path_gate_writes_no_row(seq):
    """A provider with ``plane_mode="off"`` takes the slow path (the
    reference's quirk): the gate's verdict is read, and a gated or failed
    edge writes no between row, so the table is the fast path's with the
    inactive rows left out."""
    cfg = dict(SEQ_KW, plane_mode="off", window=12, chi2_vro_gate=True,
               chi2_threshold=0.3, final_batch=False)
    port, ref = _both(*seq, cfg, plane_obs_provider=lambda seq_id: [])
    _assert_replay(port, ref)
    _assert_tables(port, ref, ("between", "imu"))
    assert "new_frame" in port.timers and "fused_frame" not in port.timers
    fast = _port(*seq, cfg)
    bt, ft = port.graph.between, fast.graph.between
    keep = _np(ft.active)[:len(seq[0])]
    m = int(keep.sum())
    assert int(_np(bt.active).sum()) == m == port.n_vo_edges
    for f in ("i", "j"):
        np.testing.assert_array_equal(_np(getattr(bt, f))[:m],
                                      _np(getattr(ft, f))[:len(keep)][keep])


# -- IncrementalOptimizer -------------------------------------------------------


def _corridor(n):
    """A loopy corridor (``test_online_engine.corridor_sequence``): the
    initial poses (pose 0 exact, the others moved by 0.05) and, per frame,
    the edges that arrive with it."""
    gt, edges, r = corridor_sequence(n, seed=1)
    init = [gt[0]] + [np_lie.retract(g, r.normal(size=6) * 0.05)
                      for g in gt[1:]]
    return init, [[e for e in edges if e[1] == k] for k in range(n)]


_PRIOR = np.diag(np.full(6, 1e6))


def _port_og(init, cap):
    og = online.OnlineGraph(factors.empty_graph(prior_pose_cap=2,
                                                between_cap=2 * cap,
                                                device="cpu"),
                            empty_arena(pose_cap=cap, device="cpu"))
    og.add_prior_pose(0, se3.Pose(*map(torch.as_tensor, init[0])), _PRIOR)
    return og


def _jax_og(init, cap):
    jog = jonline.OnlineGraph(jfactors.empty_graph(prior_pose_cap=2,
                                                   between_cap=2 * cap),
                              j_empty_arena(pose_cap=cap))
    jog.add_prior_pose(0, jse3.Pose(*map(jnp.asarray, init[0])), _PRIOR)
    return jog


def _append(og, k, pose, edges):
    """Frame ``k`` and its edges, into either package's ``OnlineGraph``."""
    if isinstance(og, online.OnlineGraph):
        P, arr = se3.Pose, torch.as_tensor
    else:
        P, arr = jse3.Pose, jnp.asarray
    og.set_pose(k, P(*map(arr, pose)))
    for i, j, T in edges:
        og.add_between(i, j, P(*map(arr, T)), INFO_SQRT)


def _corridor_graphs(n=60, cap=64):
    """The corridor in both packages' ``OnlineGraph``, every frame in."""
    init, arrivals = _corridor(n)
    jog, og = _jax_og(init, cap), _port_og(init, cap)
    for k, edges in enumerate(arrivals):
        _append(jog, k, init[k], edges)
        _append(og, k, init[k], edges)
    return jog, og


@pytest.mark.parametrize("kw", [dict(solver="dense"),
                                dict(solver="pcg", pcg_iters=40),
                                dict(window=8)],
                         ids=["full-dense", "full-pcg", "window8"])
def test_incremental_optimizer_matches_reference(kw):
    """An update every tenth frame of a 60-pose corridor, as the frames
    arrive, in both packages."""
    init, arrivals = _corridor(60)
    jog, og = _jax_og(init, 64), _port_og(init, 64)
    jinc = jonline.IncrementalOptimizer(iters_per_update=2, damping=1e-6,
                                        **kw)
    inc = online.IncrementalOptimizer(iters_per_update=2, damping=1e-6, **kw)
    for k, edges in enumerate(arrivals):
        _append(jog, k, init[k], edges)
        _append(og, k, init[k], edges)
        if k % 10 == 9:
            jres, res = jinc.update(jog), inc.update(og)
            for f in ("pose_R", "pose_t"):
                np.testing.assert_allclose(
                    _np(getattr(og.values, f)),
                    _np(getattr(jog.values, f)), rtol=0, atol=1e-9,
                    err_msg=f"{f} after frame {k}")
            assert _rel(float(res.error), float(jres.error)) <= 1e-9
    assert og._n == jog._n


def test_incremental_full_batch_matches_reference():
    jog, og = _corridor_graphs()
    jres = jonline.IncrementalOptimizer().full_batch(jog)
    res = online.IncrementalOptimizer().full_batch(og)
    np.testing.assert_allclose(_np(og.values.pose_t), _np(jog.values.pose_t),
                               atol=1e-9)
    assert _rel(float(res.error), float(jres.error)) <= 1e-9
    with pytest.raises(ValueError, match="positive"):
        online.IncrementalOptimizer(window=0)


# -- the arenas: grow, one-row writers, checkpoints -----------------------------


def _small_graphs():
    r = np.random.default_rng(5)
    jog = jonline.OnlineGraph(
        jfactors.empty_graph(prior_pose_cap=1, between_cap=2, plane_cap=2),
        j_empty_arena(pose_cap=3, vel_cap=3, plane_cap=2))
    og = online.OnlineGraph(
        factors.empty_graph(prior_pose_cap=1, between_cap=2, plane_cap=2,
                            device="cpu"),
        empty_arena(3, 3, plane_cap=2, device="cpu"))
    for k in range(3):
        T = np_lie.retract((np.eye(3), np.zeros(3)), r.normal(size=6))
        jog.set_pose(k, jse3.Pose(*map(jnp.asarray, T)))
        og.set_pose(k, se3.Pose(*map(torch.as_tensor, T)))
        jog.set_vel(k, np.full(3, k + 0.5))
        og.set_vel(k, np.full(3, k + 0.5))
    return jog, og, r


def _assert_same_state(og, jog):
    for name in online._TABLES:
        for f, a, b in zip(getattr(og.graph, name)._fields,
                           getattr(og.graph, name),
                           getattr(jog.graph, name)):
            np.testing.assert_array_equal(_np(a), _np(b),
                                          err_msg=f"{name}.{f}")
    for f, a, b in zip(og.values._fields, og.values, jog.values):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=f)
    assert og._n == jog._n
    assert (og.num_poses, og.num_vels, og.num_biases, og.num_planes) == \
        (jog.num_poses, jog.num_vels, jog.num_biases, jog.num_planes)


def test_grow_every_capacity_and_one_row_writers_match_reference():
    jog, og, r = _small_graphs()
    plane, meas = r.normal(size=4) * 2.0, r.normal(size=4) * 0.5
    S = np.eye(3) * 7.0
    for o in (jog, og):
        o.set_plane(0, plane)                 # not unit: it normalizes
        o.add_plane_factor(2, 0, meas, S)
        o.grow(pose_cap=8, vel_cap=6, bias_cap=5, plane_var_cap=4,
               point_cap=3, factor_caps={"between": 9, "imu": 4,
                                         "plane": 5, "projection": 2})
        o.set_plane(3, plane[::-1])
        o.add_plane_factor(1, 3, meas[::-1], 2 * S)
    assert og.values.pose_R.shape[0] == 8 and og.values.point.shape[0] == 3
    assert og.graph.between.i.shape[0] == 9
    _assert_same_state(og, jog)
    with pytest.raises(RuntimeError, match="plane variable arena full"):
        og.set_plane(4, plane)


def test_reference_checkpoint_loads_bit_equal(tmp_path):
    """A checkpoint the JAX package writes (int32 indices) loads in the
    port with every array bit-equal, the slot counters and the chi2."""
    jog, _ = _corridor_graphs()
    jonline.IncrementalOptimizer(iters_per_update=2, window=8).update(jog)
    path = str(tmp_path / "jax.npz")
    jog.save_state(path)
    loaded = online.OnlineGraph.load_state(path, device="cpu")
    _assert_same_state(loaded, jog)
    assert loaded.graph.between.i.dtype == torch.int64
    assert _rel(loaded.error(), jog.error()) <= 1e-12
    f32 = online.OnlineGraph.load_state(path, device="cpu",
                                        dtype=torch.float32)
    assert f32.values.pose_t.dtype == torch.float32
    assert f32.graph.between.i.dtype == torch.int64


def test_checkpoint_resume_bit_exact(tmp_path):
    """Save mid-run, load, continue: bit-equal to the uninterrupted run
    (``tests/test_online_graph.py``'s test, in the port)."""
    init, arrivals = _corridor(30)

    def run(split):
        og = _port_og(init, 32)
        inc = online.IncrementalOptimizer(iters_per_update=1, damping=1e-9,
                                          window=8)
        for k, edges in enumerate(arrivals):
            if k == split:
                path = str(tmp_path / "port.npz")
                og.save_state(path)
                og = online.OnlineGraph.load_state(path, device="cpu")
            _append(og, k, init[k], edges)
            if k % 5 == 4:
                inc.update(og)
        return og

    a, b = run(None), run(17)
    for x, y in zip(a.values, b.values):
        np.testing.assert_array_equal(_np(x), _np(y))
    for x, y in zip(a.graph, b.graph):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(_np(u), _np(v))
    assert a._n == b._n and a.error() == b.error()
