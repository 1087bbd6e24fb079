"""Parity of the port's frontend-driven tools with the JAX package, on the
CPU: guided re-matching (``match_under_prior``) and two-frame refinement
(``refine_edge_ba``), the VRO-log tools (``tools/vro_tools.py``: the
``convert_vo2ba`` closure, the sparse-area matcher), ``plane_check``,
gyro dead reckoning (``imu/euler.py``), ``features_from_store``, ``.gsf``
frames and the trajectory metrics; and the cases of
``tests/test_vro_adjust.py`` on the port (but ``TestHeadlessViewers``,
whose viewers are not ported yet).

Frames are ``test_pipelines2.render_wall_frame``'s SR4000 wall with the
distortion zeroed (``test_vro_adjust.py``'s camera), each extracted once
by each package in a module-scoped fixture.

Tolerances: matches and inlier masks equal on exact frames; R and t
within 1e-5 (float32 RANSAC refits); two-frame BA within 1e-7 (float64
LM from the same inliers), its information within 1e-6 of its largest
entry (the inverse of a marginal under a 1e-7-sigma anchor, ~1e7 on the
diagonal, where differences of 0.1-1.3 are rounding: 1.5e-7 of it);
edge tangents within 1e-5; plane_check and
euler 1e-10 in float64 (the same closed forms); frames and metrics equal.
"""

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pipelines2 import render_wall_frame

from graph_slam_tpu.config import SR4000 as J_SR4000
from graph_slam_tpu.core import se3 as jse3
from graph_slam_tpu.imu import euler as jeuler
from graph_slam_tpu.io import frames as jframes
from graph_slam_tpu.io.vro_log import VROLog as JVROLog
from graph_slam_tpu.pipelines import ba_imu as jba_imu
from graph_slam_tpu.pipelines import plane_check as jpc
from graph_slam_tpu import tools as jtools
from graph_slam_tpu.utils import metrics as jmetrics
from graph_slam_tpu.vision import features as jfeat
from graph_slam_tpu.vision import frontend as jfront
from graph_slam_tpu_torch import convert, tools
from graph_slam_tpu_torch.config import SR4000
from graph_slam_tpu_torch.core import se3
from graph_slam_tpu_torch.imu import euler
from graph_slam_tpu_torch.io import FrameStore, VROLog, frames as tframes
from graph_slam_tpu_torch.pipelines import features_from_store, plane_check
from graph_slam_tpu_torch.utils import metrics
from graph_slam_tpu_torch.vision import (make_ba_fn, match_under_prior,
                                         refine_edge_ba)

CPU = "cpu"
K = dataclasses.replace(SR4000, k1=0.0, k2=0.0)
JK = dataclasses.replace(J_SR4000, k1=0.0, k2=0.0)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _port(frame):
    return convert.feature_frame_from_numpy(
        jax.tree.map(np.asarray, frame), device=CPU)


@pytest.fixture(scope="module")
def pairs():
    """JAX features of the wall at x = 0, 0.12, 0.15 m."""
    out = {}
    for x in (0.0, 0.12, 0.15):
        img, d = render_wall_frame(K, np.array([x, 0.0, 0.0]))
        out[x] = jfeat.extract_features(JK, jnp.asarray(img), jnp.asarray(d))
    return out


# ---------------------------------------------------- match_under_prior
def _under_prior_both(pairs, x, t0, **kw):
    f0, f1 = pairs[0.0], pairs[x]
    T0 = (np.eye(3), np.array([t0, 0.0, 0.0]))
    j = jfront.match_under_prior(jax.random.PRNGKey(0), f0, f1,
                                 (jnp.asarray(T0[0]), jnp.asarray(T0[1])),
                                 **kw)
    t = match_under_prior((0,), _port(f0), _port(f1), T0, **kw)
    return [np.asarray(a) for a in j], [_np(a) for a in t]


def test_match_under_prior_matches_jax(pairs):
    (Rj, tj, Ij, mj, nnj, okj), (Rt, tt, It, mt, nnt, okt) = \
        _under_prior_both(pairs, 0.15, 0.13)
    assert bool(okj) and bool(okt)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(nnt[mt], nnj[mj])
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    np.testing.assert_allclose(tt, tj, atol=1e-5)
    np.testing.assert_allclose(It, Ij, rtol=1e-5, atol=1e-5 * np.abs(Ij)
                               .max())


def test_match_under_prior_recovers_translation(pairs):
    """``TestMatchUnderPrior::test_recovers_translation`` on the port."""
    _, (R, t, _, _, _, ok) = _under_prior_both(pairs, 0.15, 0.13)
    assert bool(ok)
    assert abs(t[0] - 0.15) < 0.02, t
    assert abs(t[1]) < 0.02 and abs(t[2]) < 0.02
    assert float(np.trace(R)) > 2.99


def test_gate_rejects_wrong_prior(pairs):
    """``TestMatchUnderPrior::test_gate_rejects_wrong_prior``: a wildly
    wrong prior empties the gate, in both packages."""
    (*_, okj), (*_, okt) = _under_prior_both(pairs, 0.15, 3.0, radius=0.05)
    assert not bool(okj) and not bool(okt)


def test_refine_edge_ba_matches_jax(pairs):
    """``TestRefineEdgeBa::test_ba_refines_pose_with_information`` on the
    port, held to the reference's BA."""
    f0, f1 = pairs[0.0], pairs[0.12]
    T0 = (np.eye(3), np.array([0.10, 0.0, 0.0]))
    outj = jfront.refine_edge_ba(jax.random.PRNGKey(1), f0, f1,
                                 (jnp.asarray(T0[0]), jnp.asarray(T0[1])),
                                 JK)
    out = refine_edge_ba((1,), _port(f0), _port(f1), T0, K)
    assert out is not None and outj is not None
    (R, t), info, chi2 = out
    (Rj, tj), infoj, chi2j = outj
    assert abs(t[0] - 0.12) < 0.02, t
    assert np.linalg.eigvalsh(info).min() > 0
    np.testing.assert_allclose(R, np.asarray(Rj), atol=1e-7)
    np.testing.assert_allclose(t, np.asarray(tj), atol=1e-7)
    np.testing.assert_allclose(info, np.asarray(infoj), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(infoj)).max())
    assert chi2 == pytest.approx(float(chi2j), rel=1e-6, abs=1e-12)


# ------------------------------------------------------------ vro tools
def _log_rows(xs, offset, info, log_type):
    rows = []
    for k in range(1, len(xs)):
        xi = np.array([0.0, 0.0, 0.0, xs[k] - xs[k - 1] + offset, 0.0, 0.0])
        rows.append((k, k - 1, xi, info))
    return log_type(np.asarray([r[0] for r in rows]),
                    np.asarray([r[1] for r in rows]),
                    np.stack([r[2] for r in rows]),
                    np.stack([r[3] for r in rows]))


def test_convert_vo2ba_ba_mode_matches_jax():
    """``TestConvertVo2BaSelfContained::test_ba_mode_end_to_end`` on the
    port: BA pulls the (2 cm off) logged edges back to truth, as the
    reference's does."""
    xs = [0.0, 0.12, 0.24]
    frames = {k: render_wall_frame(K, np.array([x, 0.0, 0.0]))
              for k, x in enumerate(xs)}
    info = np.diag([1e4] * 3 + [4e3] * 3)
    out = tools.convert_vo2ba(_log_rows(xs, 0.02, info, VROLog), "ba",
                              ba_fn=make_ba_fn(frames.get, K, device=CPU))
    ref = jtools.convert_vo2ba(_log_rows(xs, 0.02, info, JVROLog), "ba",
                               ba_fn=jfront.make_ba_fn(frames.get, JK))
    assert out.valid.all()
    for k in range(2):
        assert abs(out.xi[k, 3] - 0.12) < 0.02, out.xi[k]
    np.testing.assert_allclose(out.xi, ref.xi, atol=1e-6)
    np.testing.assert_allclose(out.info, ref.info, rtol=0,
                               atol=1e-6 * np.abs(ref.info).max())


def test_add_vo_at_sparse_area_matches_jax():
    """``TestSparseAreaSelfContained`` on the port: edges around a
    feature-sparse frame, validated by the batched RANSAC matcher."""
    xs = [0.0, 0.06, 0.12, 0.18, 0.24]
    frames = {k: render_wall_frame(K, np.array([x, 0.0, 0.0]))
              for k, x in enumerate(xs)}
    info = np.diag([8e3] * 3 + [4e3] * 3)
    counts = {0: 200, 1: 200, 2: 10, 3: 200, 4: 200}
    out = tools.add_vo_at_sparse_area(
        _log_rows(xs, 0.0, info, VROLog), counts,
        tools.make_frame_matcher(frames.get, K, device=CPU), window=2,
        sparse_thresh=60)
    ref = jtools.add_vo_at_sparse_area(
        _log_rows(xs, 0.0, info, JVROLog), counts,
        jtools.make_frame_matcher(frames.get, JK), window=2,
        sparse_thresh=60)
    assert len(out) > 4 and len(out) == len(ref)
    np.testing.assert_array_equal(out.id_from, ref.id_from)
    np.testing.assert_array_equal(out.id_to, ref.id_to)
    np.testing.assert_allclose(out.xi, ref.xi, atol=1e-5)
    for k in range(4, len(out)):
        T = se3.expmap(torch.as_tensor(out.xi[k]))
        expect = xs[int(out.id_to[k])] - xs[int(out.id_from[k])]
        assert abs(float(T.t[0]) - expect) < 0.02


def test_log_tools_match_jax():
    r = np.random.default_rng(0)
    n = 6
    xi = r.normal(size=(n, 6)) * 0.1
    info = np.tile(np.eye(6) * 100.0, (n, 1, 1))
    info[2] = np.eye(6) * 1e4           # the failed-edge sentinel
    args = (np.arange(1, n + 1), np.arange(n), xi, info)
    a, b = VROLog(*(x.copy() for x in args)), JVROLog(*(x.copy() for x in
                                                      args))
    xi2 = xi + r.normal(size=(n, 6)) * 0.01
    a2, b2 = VROLog(args[0], args[1], xi2, info), JVROLog(args[0], args[1],
                                                         xi2, info)
    for got, want in zip(tools.compute_trans_difference(a, a2, device=CPU),
                         jtools.compute_trans_difference(b, b2)):
        np.testing.assert_allclose(got, want, atol=1e-12)
    counts = np.array([5, 50, 50, 3, 50, 50])
    for mode in ("cut", "hybrid"):
        got = tools.convert_vo2ba(a, mode, match_counts=counts)
        want = jtools.convert_vo2ba(b, mode, match_counts=counts)
        np.testing.assert_array_equal(got.info, want.info)
        np.testing.assert_array_equal(got.xi, want.xi)
    got = tools.merge_vro(a, a2, counts)
    want = jtools.merge_vro(b, b2, counts)
    np.testing.assert_array_equal(got.xi, want.xi)
    scores = np.array([0.1, 5.0, 0.2, 9.0, 0.0, 3.0])
    np.testing.assert_array_equal(
        tools.delete_vo_by_plane_check(a, scores, 1.0).info,
        jtools.delete_vo_by_plane_check(b, scores, 1.0).info)
    fc = {0: 100, 1: 10, 2: 100, 3: 30, 4: 100}
    assert tools.propose_sparse_area_edges(fc, 3, 60) == \
        jtools.propose_sparse_area_edges(fc, 3, 60)


# ----------------------------------------------------- plane_check, euler
def _plane(r):
    n = r.normal(size=3)
    return np.r_[n / np.linalg.norm(n), r.uniform(-2, 2)]


def _spd(r, k, scale):
    A = r.normal(size=(k, k))
    return A @ A.T * scale + np.eye(k) * scale * 0.1


def test_plane_check_matches_jax():
    r = np.random.default_rng(0)
    pi = _plane(r)
    xi = r.normal(size=6) * 0.1
    ci, cj, S = _spd(r, 3, 1e-3), _spd(r, 3, 1e-3), _spd(r, 6, 1e-4)
    T = jse3.expmap(jnp.asarray(xi))
    from graph_slam_tpu.planes import oriented_plane as jop
    pj = np.asarray(jop.transform(jnp.asarray(pi), T.R, T.t)) \
        + r.normal(size=4) * 0.01
    got = plane_check.plane_pair_mahalanobis(pi, ci, pj, cj, xi, S,
                                             device=CPU)
    want = jpc.plane_pair_mahalanobis(pi, ci, pj, cj, xi, S)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    planes_i, planes_j = [pi, _plane(r)], [_plane(r), pj]
    got = plane_check.plane_set_consistency(planes_i, [ci, ci], planes_j,
                                            [cj, cj], xi, S, device=CPU)
    want = jpc.plane_set_consistency(planes_i, [ci, ci], planes_j,
                                     [cj, cj], xi, S)
    assert got[0] == want[0] == 1
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-10)

    info = np.linalg.inv(S)
    rows = (np.array([1, 2]), np.array([0, 1]), np.stack([xi, xi]),
            np.stack([info, np.eye(6) * 1e4]))

    def provider(seq):
        return ([pi], [ci]) if seq % 2 == 0 else ([pj], [cj])

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plane_check.log")
        got = plane_check.check_vo_edges(VROLog(*rows), provider, path,
                                         device=CPU)
        want = jpc.check_vo_edges(JVROLog(*rows), provider)
        assert open(path).read().count("\n") == len(got) == 1
    assert got[0][:3] == want[0][:3]
    np.testing.assert_allclose(got[0][3:], want[0][3:], rtol=1e-10)


def test_integrate_euler_matches_jax():
    r = np.random.default_rng(1)
    gyr = r.normal(size=(400, 3)) * 0.3
    bias = np.array([0.01, -0.02, 0.005])
    assert np.array_equal(euler.gyro_bias_from_static(gyr, 50),
                          jeuler.gyro_bias_from_static(gyr, 50))
    dt = r.uniform(0.004, 0.006, 400)
    got = euler.integrate_euler(gyr, dt, bias=bias,
                                rpy0=np.array([0.1, -0.2, 0.3]), device=CPU)
    want = jeuler.integrate_euler(jnp.asarray(gyr), jnp.asarray(dt),
                                  bias=bias, rpy0=np.array([0.1, -0.2, 0.3]))
    assert got.dtype == torch.float64 and got.shape == (400, 3)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-10)
    rpy = r.normal(size=(5, 3)) * 0.4
    w = r.normal(size=(5, 3))
    np.testing.assert_allclose(
        _np(euler.body_rates_to_euler_rates(torch.as_tensor(rpy),
                                            torch.as_tensor(w))),
        np.asarray(jeuler.body_rates_to_euler_rates(jnp.asarray(rpy),
                                                    jnp.asarray(w))),
        atol=1e-10)


# ------------------------------------------- features_from_store, frames
def test_features_from_store_matches_jax():
    xs = [0.0, 0.08, 0.16]
    frames = {k: render_wall_frame(SR4000, np.array([x, 0.0, 0.0]))
              for k, x in enumerate(xs)}
    got, matches = features_from_store(frames.get, [0, 1, 2], SR4000,
                                       device=CPU)
    want, jmatches = jba_imu.features_from_store(frames.get, [0, 1, 2],
                                                 J_SR4000)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["uv"], w["uv"])
        np.testing.assert_allclose(g["pts3"], w["pts3"], atol=1e-5)
    for i, j in ((0, 1), (1, 2)):
        m = matches(i, j)
        assert len(m) > 50 and m == jmatches(i, j)
    with pytest.raises(FileNotFoundError):
        features_from_store(frames.get, [0, 7], SR4000, device=CPU)


def test_frames_match_jax(tmp_path):
    r = np.random.default_rng(2)
    inten = r.uniform(0, 4000, (6, 8)).astype(np.float32)
    depth = r.uniform(0.3, 5.0, (6, 8)).astype(np.float32)
    blob = tframes.encode_frame(inten, depth)
    assert blob == jframes.encode_frame(inten, depth)
    for a, b in zip(tframes.decode_frame(blob), jframes.decode_frame(blob)):
        np.testing.assert_array_equal(a, b)
    store = FrameStore(str(tmp_path))
    for k in range(3):
        store.save(k, inten + k, depth)
    assert store(5) is None
    np.testing.assert_array_equal(store(1)[0],
                                  jframes.load_frame(store.path(1))[0])
    got = store.load_batch([0, 2], 8, 6)
    want = jframes.FrameStore(str(tmp_path)).load_batch([0, 2], 8, 6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tframes.decode_frame(b"XXXX" + blob[4:])


def test_metrics_match_jax():
    r = np.random.default_rng(3)
    gt = np.cumsum(r.normal(size=(50, 3)) * 0.1, axis=0)
    Rz = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    est = 1.3 * gt @ Rz.T + 0.5 + r.normal(size=gt.shape) * 0.01
    for fn, args in ((metrics.ate_rmse, (est, gt)),
                     (metrics.rpe, (est, gt, 3))):
        assert fn(*args) == getattr(jmetrics, fn.__name__)(*args)
    assert metrics.ate_rmse(est, gt, with_scale=True) == \
        jmetrics.ate_rmse(est, gt, with_scale=True)
    for a, b in zip(metrics.align_umeyama(est, gt, True),
                    jmetrics.align_umeyama(est, gt, True)):
        np.testing.assert_array_equal(a, b)
    assert metrics.ate_stats(est, gt)[0] == jmetrics.ate_stats(est, gt)[0]
    assert metrics.rpe_stats(est, gt, 2) == jmetrics.rpe_stats(est, gt, 2)
    Rs = np.stack([np.eye(3), Rz, Rz.T])
    assert metrics.ate_rot_mean_deg(Rs, gt[:3], Rs @ Rz, gt[:3]) == \
        jmetrics.ate_rot_mean_deg(Rs, gt[:3], Rs @ Rz, gt[:3])
