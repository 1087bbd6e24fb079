"""Parity of the port's flagship, ``run_vio(engine="scan",
plane_mode="rescue")``, with the JAX package on the CPU in float64.

Two cases at the shapes of ``tests/test_scan_rescue.py`` (eight frames,
window 4, ``max_imu_window=64``, and ``bucket=16`` in the reference, which
the port's scan engine does not read), so the JAX replay compiles little
beyond that file's programs:

- frames: ``test_plane_node.simulate_frames(n_frames=8, fail_frame=4)``,
  rendered frames of the two-plane room; the failed record is rescued by
  propagating frame 3's planes into frame 4 and extracting fresh ones;
- provider: ``test_vio.simulate(n_frames=7)``, plane observations from a
  callable; seven frames and the loop closure give the frames case's
  table capacities, so the reference reuses that case's compiled
  programs.

Both end with the final batch LM over the graph and its plane columns.

The rendered depth is float32, as the flagship's SR4000 frames are. The
reference computes its plane refits in the frame's dtype, the port in the
arena's (``graph_slam_tpu_torch/planes/plane_node.py``): float64 here. The
two cases above feed both packages the float64 copy of the frames, where
the two coincide. On the float32 frames themselves the port runs exactly
as on their float64 copy (bit-equal), so its whole gap to the reference
there is the reference's own float32 refit; ``f32_frames_case`` pins that
gap at the bounds below. The RANSAC draws differ between the packages;
the two-plane room's refits end on the same inlier sets whatever the draw
(``tests/test_torch_planes.py`` pins that).

Tolerances: poses, velocities and biases atol 1e-8 and chi2 1e-8 relative
(floored at 1), the scan-engine gate of ``tests/test_vio_scan.py``; plane
factor counts, landmark counts and the factor rows' landmark ids equal;
the factor rows' measurements and sqrt-information 1e-8 relative, which a
1e-8 step of ``repair_plane_cov`` landing differently would break. On the
float32 frames against the reference's float32 refits (measured: values
1.5e-6, chi2 8.7e-4 relative, sqrt-information 1.3e-2 relative): values
5e-6, chi2 5e-3 relative, sqrt-information 5e-2 relative, counts, masks
and landmark ids equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from graph_slam_tpu.pipelines.vio import VioConfig as JVioConfig
from graph_slam_tpu.pipelines.vio import run_vio as j_run_vio
from graph_slam_tpu_torch import convert
from graph_slam_tpu_torch.config import SR4000
from graph_slam_tpu_torch.imu import ImuStream
from graph_slam_tpu_torch.io import VROLog
from graph_slam_tpu_torch.pipelines import VioConfig, run_vio
from test_plane_node import K as JK
from test_plane_node import simulate_frames
from test_vio import simulate

torch.set_num_threads(1)

KW = dict(engine="scan", plane_mode="rescue", optimize_step=4,
          max_imu_window=64, window=4, seed=0)
TOL = 1e-8


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _both(log, times, stream, params, **sources):
    """The same rescue replay through both packages; ``sources`` are the
    reference's ``frames``/``intrinsics``/``plane_obs_provider``."""
    ref = j_run_vio(log, times, dataclasses.replace(stream, start=0), params,
                    cfg=JVioConfig(bucket=16, **KW), **sources)
    if "intrinsics" in sources:
        sources = dict(sources, intrinsics=SR4000)
    port = run_vio(
        VROLog(log.id_to, log.id_from, log.xi, log.info), dict(times),
        ImuStream(t=stream.t, acc=stream.acc, gyr=stream.gyr, dt=stream.dt),
        convert.imu_params_from_numpy(jax.tree.map(np.asarray, params),
                                      device="cpu"),
        cfg=VioConfig(**KW), device="cpu", **sources)
    return ref, port


@pytest.fixture(scope="module")
def scene():
    return simulate_frames(n_frames=8, fail_frame=4)


@pytest.fixture(scope="module")
def frames_case(scene):
    log, times, stream, params, _, frames = scene
    f64 = {k: (inten, depth.astype(np.float64))
           for k, (inten, depth) in frames.items()}
    return _both(log, times, stream, params, frames=f64.get, intrinsics=JK)


@pytest.fixture(scope="module")
def f32_frames_case(scene):
    log, times, stream, params, _, frames = scene
    assert all(d.dtype == np.float32 for _, d in frames.values())
    return _both(log, times, stream, params, frames=frames.get,
                 intrinsics=JK)


@pytest.fixture(scope="module")
def provider_case():
    log, times, stream, params, _, _, plane_obs = simulate(n_frames=7)
    return _both(log, times, stream, params, plane_obs_provider=plane_obs)


@pytest.fixture(params=["frames", "provider"])
def case(request):
    return request.getfixturevalue(f"{request.param}_case")


def test_rescue_fired_with_the_reference_bookkeeping(case):
    ref, port = case
    assert port.n_plane_factors >= 2
    assert port.n_plane_factors == ref.n_plane_factors
    assert len(port.plane_book.world) == len(ref.plane_book.world)
    assert (port.n_imu_factors, port.n_vo_edges) == \
        (ref.n_imu_factors, ref.n_vo_edges)
    assert port.plane_stack.pending == {}


def test_rescue_values_match_reference(case):
    ref, port = case
    n = len(ref.seq_ids)
    np.testing.assert_array_equal(port.seq_ids, ref.seq_ids)
    for f in ("pose_R", "pose_t", "vel", "bias"):
        np.testing.assert_allclose(_np(getattr(port.values, f))[:n],
                                   _np(getattr(ref.values, f))[:n],
                                   atol=TOL, err_msg=f)
    k = len(port.plane_book.world)
    np.testing.assert_allclose(_np(port.values.plane)[:k],
                               _np(ref.values.plane)[:k], atol=TOL)


def test_rescue_chi2_matches_reference(case):
    ref, port = case
    for a, b in ((port.error0, ref.error0), (port.error, ref.error)):
        assert abs(a - b) <= TOL * max(1.0, abs(b))
    assert len(port.chi2_log.rows) == len(ref.chi2_log.rows)
    for a, b in zip(port.chi2_log.rows, ref.chi2_log.rows):
        assert a[:2] == b[:2]
        assert abs(a[3] - b[3]) <= TOL * max(1.0, abs(b[3]))


def test_rescue_plane_rows_match_reference(case):
    """The factor rows: same landmarks and poses, measurements and
    sqrt-information at 1e-8 relative; no ``repair_plane_cov`` step
    landed differently on these inputs (0 of the rows' 3 diagonals)."""
    ref, port = case
    n = port.n_plane_factors
    jt, tt = ref.graph.plane, port.graph.plane
    for f in ("pose_idx", "plane_idx", "active"):
        np.testing.assert_array_equal(_np(getattr(tt, f))[:n],
                                      _np(getattr(jt, f))[:n], err_msg=f)
    np.testing.assert_allclose(_np(tt.meas)[:n], _np(jt.meas)[:n], atol=TOL)
    S, Sj = _np(tt.sqrt_info)[:n], _np(jt.sqrt_info)[:n]
    np.testing.assert_allclose(S, Sj, rtol=TOL, atol=0)


def test_rescue_landmark_book_matches_reference(case):
    ref, port = case
    assert port.plane_book.node_landmarks == ref.plane_book.node_landmarks
    assert port.plane_book.seen_count == ref.plane_book.seen_count
    np.testing.assert_allclose(np.stack(port.plane_book.world),
                               np.stack(ref.plane_book.world), atol=TOL)


def test_frames_rescue_timers_and_plane_nodes(frames_case):
    """The rescue ran its sub-phases once, and the node planes carried
    their landmark ids as the reference's did."""
    ref, port = frames_case
    for phase in ("rescue_step", "rescue_enqueue", "rescue_read",
                  "rescue_predict", "rescue_flush"):
        assert port.timers[phase]["calls"] == 1, phase
    rn, pn = ref.plane_stack.plane_nodes, port.plane_stack.plane_nodes
    assert sorted(rn) == sorted(pn)
    for gid in rn:
        if rn[gid] is None:
            assert pn[gid] is None
            continue
        np.testing.assert_array_equal(pn[gid].landmark_ids,
                                      rn[gid].landmark_ids)
        np.testing.assert_array_equal(pn[gid].masks, rn[gid].masks)
        np.testing.assert_allclose(pn[gid].params, rn[gid].params, atol=1e-9)


def test_rescue_with_the_chi2_gate_raises():
    log, times, stream, params, _, _, plane_obs = simulate(n_frames=7)
    with pytest.raises(ValueError, match="chi2_vro_gate"):
        run_vio(VROLog(log.id_to, log.id_from, log.xi, log.info), dict(times),
                ImuStream(t=stream.t, acc=stream.acc, gyr=stream.gyr,
                          dt=stream.dt),
                convert.imu_params_from_numpy(
                    jax.tree.map(np.asarray, params), device="cpu"),
                plane_obs_provider=plane_obs, device="cpu",
                cfg=VioConfig(**dict(KW, chi2_vro_gate=True)))


_VALUES = ("pose_R", "pose_t", "vel", "bias")
_PLANE_ROWS = ("pose_idx", "plane_idx", "meas", "sqrt_info", "active")


def test_float32_frames_run_as_their_float64_copy(frames_case,
                                                  f32_frames_case):
    """The port refits the float32 pixels in the arena's float64: the
    replay on the float32 frames is bit-equal to the replay on their
    float64 copy, which ``frames_case`` holds to the reference at 1e-8."""
    (_, port64), (_, port32) = frames_case, f32_frames_case
    for f in _VALUES + ("plane",):
        np.testing.assert_array_equal(_np(getattr(port32.values, f)),
                                      _np(getattr(port64.values, f)),
                                      err_msg=f)
    assert (port32.error0, port32.error) == (port64.error0, port64.error)
    assert port32.chi2_log.rows == port64.chi2_log.rows
    for f in _PLANE_ROWS:
        np.testing.assert_array_equal(_np(getattr(port32.graph.plane, f)),
                                      _np(getattr(port64.graph.plane, f)),
                                      err_msg=f)


def test_float32_frames_within_the_reference_float32_refit(f32_frames_case):
    """On the float32 frames the reference refits in float32, the port in
    float64: the same bookkeeping (counts, masks, carried ids), values and
    chi2 within the reference's float32 refit error (bounds in the module
    docstring, each above its measured gap)."""
    ref, port = f32_frames_case
    assert port.n_plane_factors == ref.n_plane_factors >= 2
    assert len(port.plane_book.world) == len(ref.plane_book.world)
    assert port.plane_book.node_landmarks == ref.plane_book.node_landmarks
    rn, pn = ref.plane_stack.plane_nodes, port.plane_stack.plane_nodes
    assert sorted(rn) == sorted(pn)
    for gid in rn:
        np.testing.assert_array_equal(pn[gid].landmark_ids,
                                      rn[gid].landmark_ids)
        np.testing.assert_array_equal(pn[gid].masks, rn[gid].masks)
    n, k = len(ref.seq_ids), len(ref.plane_book.world)
    for f in _VALUES:
        np.testing.assert_allclose(_np(getattr(port.values, f))[:n],
                                   _np(getattr(ref.values, f))[:n],
                                   atol=5e-6, err_msg=f)
    np.testing.assert_allclose(_np(port.values.plane)[:k],
                               _np(ref.values.plane)[:k], atol=5e-6)
    for a, b in zip(port.chi2_log.rows, ref.chi2_log.rows):
        assert a[:2] == b[:2]
        assert abs(a[3] - b[3]) <= 5e-3 * max(1.0, abs(b[3]))
    m = port.n_plane_factors
    np.testing.assert_array_equal(_np(port.graph.plane.plane_idx)[:m],
                                  _np(ref.graph.plane.plane_idx)[:m])
    np.testing.assert_allclose(_np(port.graph.plane.sqrt_info)[:m],
                               _np(ref.graph.plane.sqrt_info)[:m],
                               rtol=5e-2, atol=0)
