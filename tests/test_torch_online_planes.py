"""Parity of the port's online VIO engine with the JAX package on the
CPU in float64, with planes: ``run_vio(engine="online")`` with
``plane_mode`` "rescue" and "always", from rendered frames and from a
plane-observation provider; the synchronous ``predict_plane_node``; and,
port only, the online engine against the scan engine.

The scenes are ``tests/test_torch_rescue.py``'s, eight frames each:
rendered frames of the two-plane room (``test_plane_node.simulate_frames``,
float64 depth, and the float32 depth once) and a provider
(``test_vio.simulate``), every replay at ``bucket=16`` and an IMU window of
64, so the JAX package compiles each program once; and the online cases
of ``tests/test_round3_fixes.py``: the landmark arena grown past its
capacity, and a rescue whose VO edge matched an older keyframe. The
helpers and the plane-free cases are in ``tests/test_torch_online.py``.

Tolerances, each with its reason:
- replays: as ``tests/test_torch_online.py``'s (1e-8 on values, chi2 and
  the factor tables, indices, ``active`` and the landmark book equal);
  the plane rows' sqrt-information 1e-8 relative; on float32 frames, the
  gap pinned in ``tests/test_torch_rescue.py``;
- ``predict_plane_node``: masks and landmark ids equal, parameters 1e-9;
- online against scan in the port: 1e-10 on values and chi2 (the two
  engines run the same record kernel and the same windowed step; the
  reference's own gate, ``tests/test_scan_rescue.py``, is 5e-3 m).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import np_lie
from graph_slam_tpu.core import se3 as jse3
from graph_slam_tpu.planes import oriented_plane
from graph_slam_tpu.planes import plane_node as jnode
from graph_slam_tpu_torch import convert
from graph_slam_tpu_torch.config import SR4000
from graph_slam_tpu_torch.core import se3
from graph_slam_tpu_torch.planes import plane_node
from test_plane_node import K as JK
from test_plane_node import render, simulate_frames
from test_torch_online import (TOL, _assert_replay, _assert_tables, _both,
                               _np, _port, _rel)
from test_vio import simulate

torch.set_num_threads(1)


# -- the eight-frame plane scenes -----------------------------------------------

PLANE_KW = dict(engine="online", optimize_step=4, max_imu_window=64,
                bucket=16, seed=0)


@pytest.fixture(scope="module")
def scene():
    return simulate_frames(n_frames=8, fail_frame=4)


def _frames64(frames):
    return {k: (i, d.astype(np.float64)) for k, (i, d) in frames.items()}


@pytest.fixture(scope="module", params=[
    ("frames", "rescue", 4), ("frames", "always", None),
    ("provider", "rescue", None), ("provider", "always", 4)],
    ids=["frames-rescue-window4", "frames-always-full",
         "provider-rescue-full", "provider-always-window4"])
def plane_case(request, scene):
    source, mode, window = request.param
    cfg = dict(PLANE_KW, plane_mode=mode, window=window, final_batch=True)
    if source == "frames":
        log, times, stream, params, _, frames = scene
        sources = dict(frames=_frames64(frames).get, intrinsics=JK)
    else:
        log, times, stream, params, _, _, plane_obs = simulate(n_frames=7)
        sources = dict(plane_obs_provider=plane_obs)
    return (source, mode,
            *_both(log, times, stream, params, cfg, **sources))


def test_plane_modes_match_reference(plane_case):
    _, mode, port, ref = plane_case
    assert port.n_plane_factors >= 2
    _assert_replay(port, ref)
    _assert_tables(port, ref)
    m = port.n_plane_factors
    np.testing.assert_allclose(_np(port.graph.plane.sqrt_info)[:m],
                               _np(ref.graph.plane.sqrt_info)[:m],
                               rtol=TOL, atol=0)
    # a rescue runs on the failed new frame; "always" on every new frame
    want = 1 if mode == "rescue" else len(port.seq_ids) - 1
    assert port.timers["rescue_step"]["calls"] == want


def test_plane_nodes_and_predictions(plane_case):
    """From frames, ``plane_mode="always"`` carries the previous frame's
    planes into every new frame through the region grow (one prediction a
    frame; the scene's wall and floor are in every frame), a rescue into
    the failed one; the plane nodes carry the reference's landmark ids and
    masks. A provider runs no prediction."""
    source, mode, port, ref = plane_case
    stack = port.plane_stack
    if source == "provider":
        assert stack.n_predict == 0 and stack.plane_nodes == {}
        return
    assert stack.n_predict == (1 if mode == "rescue"
                               else len(port.seq_ids) - 1)
    rn, pn = ref.plane_stack.plane_nodes, stack.plane_nodes
    assert sorted(rn) == sorted(pn)
    for gid in rn:
        if rn[gid] is None:
            assert pn[gid] is None
            continue
        np.testing.assert_array_equal(pn[gid].landmark_ids,
                                      rn[gid].landmark_ids)
        np.testing.assert_array_equal(pn[gid].masks, rn[gid].masks)


def _far_planes_case():
    """``tests/test_round3_fixes.py``'s plane-arena growth: six far world
    planes seen from every frame by a provider, ``plane_mode="always"``,
    a landmark arena of 2 that must grow."""
    log, times, stream, params, X, _, _ = simulate(n_frames=8,
                                                   fail_frame=99)
    planes_w = [np.array([1.0, 0.0, 0.0, -50.0 - 3 * k]) for k in range(3)]
    planes_w += [np.array([0.0, 1.0, 0.0, -50.0 - 3 * k]) for k in range(3)]

    def plane_obs(seq):
        return [(np.asarray(oriented_plane.transform(
            jnp.asarray(pw), X[seq].R, X[seq].t)), np.eye(3) * 1e-5)
            for pw in planes_w]

    cfg = dict(PLANE_KW, plane_mode="always", optimize_step=100,
               plane_var_cap=2)
    return (log, times, stream, params, cfg), dict(
        plane_obs_provider=plane_obs)


def _older_keyframe_case(scene):
    """``tests/test_round3_fixes.py``'s recovery edge: the failed record
    matched against keyframe 1 while the previous frame is 3, so the rescue
    propagates frame 3's planes, not the matched node's."""
    log, times, stream, params, _, frames = scene
    log = dataclasses.replace(log, id_from=np.array(log.id_from))
    log.id_from[int(np.nonzero(log.id_to == 4)[0][0])] = 1
    cfg = dict(PLANE_KW, plane_mode="rescue", optimize_step=100)
    return (log, times, stream, params, cfg), dict(
        frames=_frames64(frames).get, intrinsics=JK)


@pytest.mark.parametrize("case", ["plane-arena-growth", "older-keyframe"])
def test_round3_cases_match_reference(scene, case):
    """The online engine's cases of ``tests/test_round3_fixes.py``, held to
    the reference: the landmark arena grown past its capacity (the same
    capacities in both packages), and a rescue whose VO edge matched an
    older keyframe."""
    args, sources = (_far_planes_case() if case == "plane-arena-growth"
                     else _older_keyframe_case(scene))
    port, ref = _both(*args, **sources)
    _assert_replay(port, ref)
    _assert_tables(port, ref)
    assert port.n_plane_factors >= 2
    if case == "plane-arena-growth":
        assert port.values.plane.shape == ref.values.plane.shape
        assert int(port.values.num_planes) >= 6 and \
            port.values.plane.shape[0] > 2
        assert port.n_plane_factors >= 6 * 7


def test_float32_frames_within_the_reference_float32_refit(scene):
    """On float32 frames the reference refits in float32, the port in the
    arena's float64: the gap ``tests/test_torch_rescue.py`` pins (values
    5e-6, chi2 5e-3 relative, plane sqrt-information 5e-2 relative),
    counts, masks and landmark ids equal."""
    log, times, stream, params, _, frames = scene
    cfg = dict(PLANE_KW, plane_mode="rescue", window=4, final_batch=True)
    port, ref = _both(log, times, stream, params, cfg, frames=frames.get,
                      intrinsics=JK)
    assert port.n_plane_factors == ref.n_plane_factors >= 2
    _assert_replay(port, ref, tol=5e-6, chi2_tol=5e-3)
    m = port.n_plane_factors
    np.testing.assert_array_equal(_np(port.graph.plane.plane_idx)[:m],
                                  _np(ref.graph.plane.plane_idx)[:m])
    np.testing.assert_allclose(_np(port.graph.plane.sqrt_info)[:m],
                               _np(ref.graph.plane.sqrt_info)[:m],
                               rtol=5e-2, atol=0)


def test_online_matches_scan_in_the_port(scene):
    """The two engines of the port on the frames rescue: the same record
    kernel, rescue and fixed-lag step; the window's between rows differ
    only by the scan's inactive row for the failed edge."""
    log, times, stream, params, _, frames = scene
    on, sc = (_port(log, times, stream, params,
                    dict(PLANE_KW, engine=engine, plane_mode="rescue",
                         window=4, final_batch=False),
                    frames=_frames64(frames).get, intrinsics=JK)
              for engine in ("online", "scan"))
    assert on.n_plane_factors == sc.n_plane_factors >= 2
    assert len(on.plane_book.world) == len(sc.plane_book.world)
    n = len(on.seq_ids)
    for f in ("pose_R", "pose_t", "vel", "bias"):
        np.testing.assert_allclose(_np(getattr(on.values, f))[:n],
                                   _np(getattr(sc.values, f))[:n],
                                   atol=1e-10, err_msg=f)
    assert [r[:2] for r in on.chi2_log.rows] == \
        [r[:2] for r in sc.chi2_log.rows]
    for a, b in zip(on.chi2_log.rows, sc.chi2_log.rows):
        assert _rel(a[3], b[3]) <= 1e-10


# -- predict_plane_node ---------------------------------------------------------


def _room_frame(t, w, seed):
    R = np_lie.so3_exp(np.asarray(w, float))
    inten, depth = render(jse3.Pose(jnp.asarray(R), jnp.asarray(t, float)),
                          noise=0.002, seed=seed)
    return inten, depth.astype(np.float64)


@pytest.mark.parametrize("with_prev", [True, False])
def test_predict_plane_node_matches_reference(with_prev):
    """The synchronous prediction from a body-frame relative pose: the
    wall and the floor carried with their landmark ids; with no previous
    planes, the fresh extraction of the whole frame."""
    inten_a, depth_a = _room_frame((0.05, 0.0, 0.1), (0, 0, 0), 1)
    inten_b, depth_b = _room_frame((0.08, 0.01, 0.16), (0.01, -0.02, 0), 2)
    jprev = None
    if with_prev:
        jprev = jnode.extract_plane_node(jax.random.PRNGKey(0), JK, inten_a,
                                         depth_a)
        jprev.landmark_ids = np.asarray([5, 2], np.int64)
    Ra = np.eye(3)
    Rb = np_lie.so3_exp(np.asarray([0.01, -0.02, 0.0]))
    T_R = Ra.T @ Rb
    T_t = Ra.T @ (np.array([0.08, 0.01, 0.16]) - np.array([0.05, 0, 0.1]))
    S66 = np.diag([1e-6] * 3 + [1e-5] * 3)
    jdet = jnode.predict_plane_node(
        jax.random.PRNGKey(3), JK, jprev,
        jse3.Pose(jnp.asarray(T_R), jnp.asarray(T_t)), S66, inten_b,
        depth_b)
    det = plane_node.predict_plane_node(
        (0, 1, 1), SR4000,
        None if jprev is None else convert.plane_node_from_numpy(jprev),
        se3.Pose(torch.as_tensor(T_R), torch.as_tensor(T_t)), S66, inten_b,
        depth_b, device="cpu")
    assert len(det) == len(jdet) == 2
    np.testing.assert_array_equal(det.landmark_ids, jdet.landmark_ids)
    assert list(det.landmark_ids) == ([5, 2] if with_prev else [-1, -1])
    np.testing.assert_array_equal(det.masks, jdet.masks)
    np.testing.assert_array_equal(det.counts, jdet.counts)
    np.testing.assert_allclose(det.params, jdet.params, atol=1e-9)
    np.testing.assert_allclose(det.cov, jdet.cov, rtol=1e-9, atol=0)
