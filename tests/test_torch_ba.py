"""Parity of the port's bundle adjustment with the JAX package, on the CPU in
float64 unless a case says otherwise: the Cal3DS2 camera, the projection
and point-prior factor rows, the builder's BA methods and capacities,
``make_ba_graph`` and the landmark tables, the normal-equations and
square-root Schur solvers (the Gram-form assembly against the reference's
one-hot form), the golden BA fixture, the NumPy oracle, gather PCG on a BA
graph and ``convert``.

Shapes are the JAX tests' own (``tests/test_ba.py``, ``test_sparsity.py``,
``test_np_parity.py``, ``test_goldens.py``); one reference run per graph
is shared through module-scoped fixtures.

Tolerances, each with its reason:
- the camera 1e-12 relative (the same closed form); its Jacobian 1e-10
  against ``torch.func.jacfwd`` and 1e-9 against the reference's autodiff
  (relative to the largest entry: the depth clamp puts ~1e8 there);
- factor rows 1e-10 relative to the block's largest entry; tables and
  index tables bit-equal;
- the square-root step, its kept rows R3/E/c1 and the Gram-form S and g
  1e-9 (relative to S's largest entry, ~1e12 from the 1e-6-sigma anchor);
- one normal-equations step: values 2e-6. Its reduced system has
  condition ~1e12 (the 1e-6-sigma anchor), at which the reference's own
  jit and eager runs of the same step differ by 1.4e-6 on
  ``TestSqrtSchur``'s 80-point graph (8.5e-9 on the 400-point one, where
  each differs from a direct dense solve by 1.7e-8);
- converged optima: chi2 1e-9 relative, values 1e-7.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import np_lie
import np_optimizer as npo
from ba_tracks import MIXED, TRACKS, mix_tracks, second_prior
from graph_slam_tpu.config import SR4000 as J_SR4000
from graph_slam_tpu.datasets import make_ba_graph as j_make_ba_graph
from graph_slam_tpu.graph import ba_solve as jba
from graph_slam_tpu.graph import builder as jbuilder
from graph_slam_tpu.graph import factors as jfactors
from graph_slam_tpu.graph import gn_optimize as j_gn_optimize
from graph_slam_tpu.graph import sparsity as jsparsity
from graph_slam_tpu.graph.variables import layout_of as j_layout_of
from graph_slam_tpu.vision import cal3ds2 as jcal
from graph_slam_tpu_torch import convert
from graph_slam_tpu_torch.config import SR4000
from graph_slam_tpu_torch.core import se3
from graph_slam_tpu_torch.datasets import make_ba_graph
from graph_slam_tpu_torch.graph import (GraphBuilder, LMParams,
                                        ba_gn_optimize, ba_gn_optimize_sqrt,
                                        build_incidence, build_point_obs,
                                        gn_optimize, layout_of,
                                        linearize_blocks, lm_optimize,
                                        schur_gn_step, sqrt_schur_gn_step,
                                        total_error)
from graph_slam_tpu_torch.graph import ba_solve
from graph_slam_tpu_torch.graph.variables import TangentLayout
from graph_slam_tpu_torch.vision import cal3ds2

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "goldens")
NE_STEP = 2e-6     # one normal-equations step, values (see above)
CAL9 = (250.5773, 251.0, 0.3, 90.0, 70.0, -0.8466, 0.5370, 1e-3, -2e-3)


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _port(graph, values):
    return (convert.graph_from_numpy(_np_tree(graph), device="cpu"),
            convert.arena_from_numpy(_np_tree(values), device="cpu"))


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)


def _close(a, b, tol, rel_to_max=False):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    scale = max(np.abs(b).max(), 1.0) if rel_to_max else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


def _tables_equal(gt, vt, gj, vj):
    for name in gj._fields:
        for f in getattr(gj, name)._fields:
            a = getattr(getattr(gt, name), f).numpy()
            b = np.asarray(getattr(getattr(gj, name), f))
            assert a.shape == b.shape, (name, f, a.shape, b.shape)
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f}")
    for f in vj._fields:
        np.testing.assert_array_equal(getattr(vt, f).numpy(),
                                      np.asarray(getattr(vj, f)), err_msg=f)


# -- the camera ---------------------------------------------------------------


def _camera_points():
    """Ordinary points, points on the optical axis, a depth below the clamp,
    points beyond the radius clamp and behind the camera."""
    r = np.random.default_rng(0)
    ordinary = r.normal(size=(30, 3)) * [1.0, 1.0, 0.5] + [0.0, 0.0, 3.0]
    special = np.array([[0.0, 0.0, 2.0], [1e-3, 2e-3, 1e-8],
                        [5.0, 3.0, -1.0], [300.0, 1.0, 2.0],
                        [0.0, 0.0, -1.0], [150.0, -120.0, 1.0]])
    return np.concatenate([ordinary, special])


def _cams():
    Kj = jcal.Cal3DS2(*[jnp.asarray(c) for c in CAL9])
    Kt = cal3ds2.Cal3DS2.make(*CAL9[:2], *CAL9[3:5], *CAL9[5:], s=CAL9[2],
                              device="cpu")
    return Kj, Kt


def test_project_point_and_uncalibrate_match_the_reference():
    Kj, Kt = _cams()
    pts = _camera_points()
    uj = np.asarray(jcal.project_point(Kj, jnp.asarray(pts)))
    ut = cal3ds2.project_point(Kt, torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(ut, uj, rtol=1e-12, atol=1e-12)
    n = pts[:, :2] / 3.0
    np.testing.assert_allclose(
        cal3ds2.uncalibrate(Kt, torch.as_tensor(n)).numpy(),
        np.asarray(jcal.uncalibrate(Kj, jnp.asarray(n))), rtol=1e-12,
        atol=1e-12)
    # both clamps are live on these points
    assert (pts[:, 2] <= 1e-6).sum() >= 2
    z = np.maximum(pts[:, 2], 1e-6)
    assert (np.linalg.norm(pts[:, :2] / z[:, None], axis=1) > 100).sum() >= 3


def test_projection_jacobian_matches_jacfwd_and_is_finite_on_the_axis():
    Kj, Kt = _cams()
    pts = _camera_points()
    p = torch.as_tensor(pts)
    uv, D = cal3ds2.project_point_jacobian(Kt, p)
    np.testing.assert_array_equal(uv.numpy(),
                                  cal3ds2.project_point(Kt, p).numpy())
    Jf = torch.func.vmap(torch.func.jacfwd(
        lambda x: cal3ds2.project_point(Kt, x)))(p)
    scale = Jf.abs().amax(dim=(1, 2), keepdim=True).clamp(min=1.0)
    assert float(((D - Jf).abs() / scale).max()) <= 1e-10
    Jj = np.asarray(jax.vmap(jax.jacfwd(
        lambda x: jcal.project_point(Kj, x)))(jnp.asarray(pts)))
    on_axis = np.all(pts[:, :2] == 0.0, axis=1)
    assert np.isnan(Jj[on_axis]).any()            # the reference's fault
    assert torch.isfinite(D).all()
    off = ~on_axis
    scale = np.maximum(np.abs(Jj[off]).max(axis=(1, 2), keepdims=True), 1.0)
    assert (np.abs(D.numpy()[off] - Jj[off]) / scale).max() <= 1e-9
    # on the axis the normalized point is 0: D = K's focal block / z
    np.testing.assert_allclose(D.numpy()[on_axis & (pts[:, 2] > 0)][0],
                               [[CAL9[0] / 2.0, CAL9[2] / 2.0, 0.0],
                                [0.0, CAL9[1] / 2.0, 0.0]], rtol=1e-12)


def test_camera_backprojection_matches_the_reference():
    from graph_slam_tpu.vision import camera as jcam
    from graph_slam_tpu_torch.vision import camera

    r = np.random.default_rng(1)
    depth = r.uniform(0.0, 12.0, (36, 44))
    inten = r.uniform(0, 255, (36, 44))
    for skip in (1, 3):
        pj, cj, vj = jcam.cloud_from_images(J_SR4000, jnp.asarray(inten),
                                            jnp.asarray(depth), skip=skip)
        pt, ct, vt = camera.cloud_from_images(SR4000, inten, depth,
                                              skip=skip, device="cpu")
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    u, v, z = r.uniform(0, 170, 9), r.uniform(0, 140, 9), r.uniform(1, 5, 9)
    np.testing.assert_allclose(
        camera.backproject(SR4000, *map(torch.as_tensor, (u, v, z))).numpy(),
        np.asarray(jcam.backproject(J_SR4000, u, v, z)), rtol=1e-12)


# -- factor rows and the builder ----------------------------------------------


def _fill_ba(b, cal_obj=None):
    """Three poses, twelve points with priors (two of them Huber), their
    projections through a mounted camera (every fourth Huber), one plane
    landmark with two factors, one landmark with two priors."""
    r = np.random.default_rng(5)
    bR = np_lie.so3_exp(np.array([0.02, 0.05, -0.03]))
    bt = np.array([0.05, -0.01, 0.02])
    for k in range(3):
        b.add_pose(np_lie.retract((np_lie.so3_exp(np.array([0, 0.1 * k, 0])),
                                   np.array([0.3 * k, 0, 0])),
                                  r.normal(size=6) * 0.01))
    b.add_prior_pose(0, (np.eye(3), np.zeros(3)), sigmas=np.full(6, 1e-3))
    pts = np.stack([r.uniform(-1, 1, 12), r.uniform(-1, 1, 12),
                    r.uniform(2.5, 5.0, 12)], axis=1)
    for q in range(12):
        b.add_point(pts[q] + r.normal(size=3) * 0.05)
        b.add_prior_point(q, pts[q], sigma=0.1,
                          robust=0.5 if q in (2, 7) else None)
    b.add_prior_point(4, pts[4] + 0.03, sqrt_info=np.eye(3) * 5.0)
    for k in range(3):
        for q in range(12):
            uv = np.array([125.0, 70.0]) + r.normal(size=2) * 40.0
            cal = cal_obj if (cal_obj is not None and q % 2) else CAL9
            b.add_projection_factor(k, q, uv, cal, body_pose=(bR, bt),
                                    sigma=1.5,
                                    robust=3.0 if (k * 12 + q) % 4 == 0
                                    else None)
    b.add_plane(np.array([0.0, 0.2, 2.0, -5.0]))
    for k in (0, 2):
        b.add_plane_factor(k, 0, np.array([0.01 * k, 0.1, 1.0, -2.0]),
                           sigma=0.05)
    return b


def _deactivate(graph, name, rows, make):
    t = getattr(graph, name)
    act = np.array(t.active)
    act[rows] = False
    return graph._replace(**{name: t._replace(active=make(act))})


@pytest.fixture(scope="module")
def small_ba():
    """(JAX graph, values, port graph, values) of ``_fill_ba`` with a few
    projection rows switched off in both."""
    gj, vj = _fill_ba(jbuilder.GraphBuilder()).build(bucket=16)
    gt, vt = _fill_ba(GraphBuilder()).build(bucket=16, device="cpu")
    gj = _deactivate(gj, "projection", [3, 10], jnp.asarray)
    gt = _deactivate(gt, "projection", [3, 10], torch.as_tensor)
    return gj, vj, gt, vt


def test_projection_and_point_prior_rows_match_the_reference(small_ba):
    gj, vj, gt, vt = small_ba
    assert _rel(total_error(gt, vt), jfactors.total_error(gj, vj)) <= 1e-10
    bj = jax.jit(jfactors.linearize_blocks)(gj, vj)
    bt = linearize_blocks(gt, vt)
    assert len(bt) == len(bj) == 4     # prior pose, plane, projection, prior
    for (r, J, c), (rj, Jj, cj) in zip(bt, bj):
        np.testing.assert_array_equal(c.numpy(), np.asarray(cj))
        _close(r, rj, 1e-10, rel_to_max=True)
        _close(J, Jj, 1e-10, rel_to_max=True)
    proj = gt.projection
    assert bool((proj.robust_kind == 1).any()) and not bool(proj.active[3])
    assert float(bt[2][1][3].abs().max()) == 0.0   # inactive row: no J


def test_projection_jacobian_matches_jacfwd_of_the_residual(small_ba):
    """The factor's closed form against ``torch.func.jacfwd`` of the
    residual at a tangent step (pose by the expmap retraction, point
    additive), whitened, on the rows without a robust weight."""
    _, _, gt, vt = small_ba
    pj = gt.projection
    n = 36

    def residual(delta, f):
        X = se3.retract(se3.Pose(vt.pose_R[pj.pose_idx[f]],
                                 vt.pose_t[pj.pose_idx[f]]), delta[:6])
        q = vt.point[pj.point_idx[f]] + delta[6:]
        Tws = se3.compose(X, se3.Pose(pj.body_R[f], pj.body_t[f]))
        uv = cal3ds2.project_point(cal3ds2.Cal3DS2.from_rows(pj.cal[f]),
                                   se3.transform_to(Tws, q))
        return pj.sqrt_info[f] @ (uv - pj.uv[f])

    (_, J, _), = [b for b in linearize_blocks(gt, vt)
                  if b[1].shape[1:] == (2, 9)]
    for f in range(n):
        if int(pj.robust_kind[f]) or not bool(pj.active[f]):
            continue
        Jf = torch.func.jacfwd(residual)(torch.zeros(9, dtype=torch.float64),
                                         f)
        _close(J[f], Jf, 1e-10, rel_to_max=True)


def test_builder_ba_methods_and_capacities_match_the_reference():
    caps = dict(pose_cap=5, vel_cap=3, bias_cap=2, plane_cap=4, point_cap=20,
                factor_caps={"projection": 40, "prior_point": 0, "imu": 2})
    Kj = jcal.Cal3DS2.make(*CAL9[:2], *CAL9[3:5], *CAL9[5:], s=CAL9[2])
    Kt = cal3ds2.Cal3DS2.make(*CAL9[:2], *CAL9[3:5], *CAL9[5:], s=CAL9[2],
                              device="cpu")
    for kw in ({}, caps, dict(bucket=8)):
        jb = _fill_ba(jbuilder.GraphBuilder(), Kj)
        tb = _fill_ba(GraphBuilder(), Kt)
        for b in (jb, tb):
            b.add_vel(np.ones(3))
            b.add_projection_factor(1, 2, [10.0, 20.0], J_SR4000)
            b.add_projection_factor(2, 3, [11.0, 21.0], CAL9[:7])
        gj, vj = jb.build(**kw)
        gt, vt = tb.build(device="cpu", **kw)
        _tables_equal(gt, vt, gj, vj)
    assert vt.pose_R.shape[0] == 8 and gt.projection.active.shape[0] == 40
    gj, vj = _fill_ba(jbuilder.GraphBuilder()).build(**caps)
    gt, vt = _fill_ba(GraphBuilder()).build(device="cpu", **caps)
    _tables_equal(gt, vt, gj, vj)
    assert gt.imu.active.shape[0] == 2 and vt.vel.shape[0] == 3
    assert gt.prior_point.active.shape[0] == 64    # cap 0 -> one bucket


# -- the generator and the landmark tables ------------------------------------


@pytest.fixture(scope="module")
def stress():
    """``make_ba_graph(12, 400, seed 3)`` of ``TestBaStress``, both
    packages, with the JAX package's 8-step normal-equations solve."""
    gj, vj, gt_j = j_make_ba_graph(n_poses=12, n_points=400, obs_per_point=4,
                                   seed=3, pixel_noise=0.0,
                                   dtype=jnp.float64, bucket=64)
    gt, vt, gt_t = make_ba_graph(n_poses=12, n_points=400, obs_per_point=4,
                                 seed=3, pixel_noise=0.0,
                                 dtype=torch.float64, device="cpu",
                                 bucket=64)
    ref = jba.ba_gn_optimize(gj, vj, iterations=8, damping=1e-4)
    return gj, vj, gt, vt, gt_t, gt_j, ref


def test_make_ba_graph_and_landmark_tables_match_the_reference(stress):
    gj, vj, gt, vt, gt_t, gt_j, _ = stress
    _tables_equal(gt, vt, gj, vj)
    np.testing.assert_array_equal(gt_t[1], gt_j[1])
    tabs_j = jba.build_point_obs(gj, j_layout_of(vj).point_cap)
    tabs_t = build_point_obs(gt, layout_of(vt).point_cap)
    for a, b in zip(tabs_t, tabs_j):
        np.testing.assert_array_equal(a, b)
    assert tabs_t[0].shape == (448, 4) and tabs_t[2].shape == (448, 1)


_j_sqrt_step = jax.jit(jba.sqrt_schur_gn_step, static_argnames=("chunk",))


@pytest.fixture(scope="module")
def two_priors():
    """``TestSqrtSchur``'s 4-pose, 30-point graph with landmark 3 carrying
    two priors, both packages, and the JAX package's steps on it."""
    gj, vj, _ = j_make_ba_graph(n_poses=4, n_points=30, obs_per_point=3,
                                seed=2, pixel_noise=0.5, dtype=jnp.float64,
                                bucket=8)
    gj = second_prior(gj, vj, 3, jnp.asarray)    # TestSqrtSchur's edit
    gt, vt = _port(gj, vj)
    tabs = jba.build_point_obs(gj, j_layout_of(vj).point_cap)
    d = jnp.asarray(1e-3, jnp.float64)
    ne = jax.jit(jba.schur_gn_step)(gj, vj, d)
    sq = _j_sqrt_step(gj, vj, *map(jnp.asarray, tabs), d, chunk=16)
    return gj, vj, gt, vt, tabs, ne, sq


def test_landmark_tables_with_several_priors_match_the_reference(two_priors):
    gj, vj, gt, vt, tabs, _, _ = two_priors
    mine = build_point_obs(gt, layout_of(vt).point_cap)
    for a, b in zip(mine, tabs):
        np.testing.assert_array_equal(a, b)
    assert mine[2].shape[1] == 2


def _tabs(graph, values):
    return [torch.as_tensor(t) for t in
            build_point_obs(graph, layout_of(values).point_cap)]


def test_schur_steps_with_several_priors_match_the_reference(two_priors):
    gj, vj, gt, vt, _, ne, sq = two_priors
    v_ne = schur_gn_step(gt, vt, 1e-3)
    v_sq = sqrt_schur_gn_step(gt, vt, *_tabs(gt, vt), 1e-3, chunk=16)
    for f in ("pose_t", "pose_R", "point"):
        _close(getattr(v_sq, f), getattr(sq, f), 1e-9)
        _close(getattr(v_ne, f), getattr(ne, f), NE_STEP)
        # TestSqrtSchur: both priors ride the QR stack
        _close(getattr(v_sq, f), getattr(v_ne, f), 1e-6)


@pytest.fixture(scope="module")
def sqrt80():
    """``TestSqrtSchur``'s 6-pose, 80-point graph: the JAX package's
    normal-equations and square-root steps and its QR reduction's pieces."""
    gj, vj, _ = j_make_ba_graph(n_poses=6, n_points=80, obs_per_point=4,
                                seed=1, pixel_noise=0.5, dtype=jnp.float64,
                                bucket=16)
    gt, vt = _port(gj, vj)
    lay = j_layout_of(vj)
    tabs = [jnp.asarray(t) for t in jba.build_point_obs(gj, lay.point_cap)]
    d = jnp.asarray(1e-3, jnp.float64)
    ne = jax.jit(jba.schur_gn_step)(gj, vj, d)
    sq = _j_sqrt_step(gj, vj, *tabs, d, chunk=32)
    (S, g), back = jax.jit(jba._landmark_qr_reduce, static_argnums=(2, 9))(
        gj, vj, lay, *tabs, jnp.arange(tabs[0].shape[0]), d, 32)
    return gt, vt, ne, sq, (S, g), back


def test_schur_steps_match_the_reference(sqrt80):
    gt, vt, ne, sq, _, _ = sqrt80
    v_ne = schur_gn_step(gt, vt, 1e-3)
    v_sq = sqrt_schur_gn_step(gt, vt, *_tabs(gt, vt), 1e-3, chunk=32)
    for f in ("pose_t", "pose_R", "point"):
        _close(getattr(v_sq, f), getattr(sq, f), 1e-9)
        _close(getattr(v_ne, f), getattr(ne, f), NE_STEP)
        # test_sqrt_matches_normal_equations_schur_f64
        _close(getattr(v_sq, f), getattr(v_ne, f), 1e-5)


def _hold_to_one_hot(gt, vt, Sj, gj_, back_j, chunk):
    """The Gram-form S and g against the reference's one-hot relocation,
    and each landmark's R3, c1 and, on its own slots, E and pose columns
    against its Householder rows (the reference pads every landmark to the
    longest track, the port to its width class: padded slots' E is zero on
    both sides)."""
    tabs = _tabs(gt, vt)
    (S, g), back = ba_solve._landmark_qr_reduce(
        gt, vt, layout_of(vt), *tabs, torch.arange(tabs[0].shape[0]), 1e-3,
        chunk)
    _close(S, Sj, 1e-9, rel_to_max=True)
    _close(g, gj_, 1e-9, rel_to_max=True)
    R3j, Ej, c1j, cpj, livej = (np.asarray(x) for x in back_j)
    k6 = 6 * tabs[1].sum(1).numpy()
    seen = []
    for rows, R3, E, c1, cols, live in back:
        for l, q in enumerate(rows.tolist()):
            w = k6[q]
            _close(R3[l], R3j[q], 1e-9, rel_to_max=True)
            _close(c1[l], c1j[q], 1e-9, rel_to_max=True)
            if w:                       # no own slots without rows
                _close(E[l, :, :w], Ej[q, :, :w], 1e-9, rel_to_max=True)
            assert not E[l, :, w:].any() and not Ej[q, :, w:].any()
            np.testing.assert_array_equal(cols[l, :w].numpy(), cpj[q, :w])
            assert float(live[l]) == float(livej[q])
            seen.append(q)
    assert sorted(seen) == list(range(tabs[0].shape[0]))


@pytest.mark.parametrize("chunk", [32, 7, 1000])
def test_gram_form_and_kept_rows_match_the_one_hot_form(sqrt80, chunk):
    """The Gram-form S and g equal the reference's one-hot relocation, and
    R3, E, c1 its Householder rows, landmark by landmark, whatever the
    chunk."""
    gt, vt, _, _, (Sj, gj_), back_j = sqrt80
    _hold_to_one_hot(gt, vt, Sj, gj_, back_j, chunk)


@pytest.fixture(scope="module")
def mixed():
    """``ba_tracks.MIXED``: tracks of 0 to 12 rows (four width classes),
    a landmark with two priors, dead bucket rows; both packages, and the
    JAX package's square-root step and QR reduction on it."""
    gj, vj, _ = j_make_ba_graph(dtype=jnp.float64, **MIXED)
    gj = mix_tracks(gj, vj, jnp.asarray)
    gt, vt = _port(gj, vj)
    lay = j_layout_of(vj)
    tabs = [jnp.asarray(t) for t in jba.build_point_obs(gj, lay.point_cap)]
    d = jnp.asarray(1e-3, jnp.float64)
    sq = _j_sqrt_step(gj, vj, *tabs, d, chunk=16)
    (S, g), back = jax.jit(jba._landmark_qr_reduce, static_argnums=(2, 9))(
        gj, vj, lay, *tabs, jnp.arange(tabs[0].shape[0]), d, 16)
    return gj, vj, gt, vt, sq, (S, g), back


@pytest.mark.parametrize("chunk", [5, 16, 1000])
def test_mixed_tracks_match_the_one_hot_form(mixed, chunk):
    """Width classes on tracks of 0 to 12 rows: S, g, the kept rows and
    the step equal the reference's padded one-hot form, whatever the chunk
    (5 splits every class)."""
    _, _, gt, vt, sq, (Sj, gj_), back_j = mixed
    _hold_to_one_hot(gt, vt, Sj, gj_, back_j, chunk)
    v = sqrt_schur_gn_step(gt, vt, *_tabs(gt, vt), 1e-3, chunk=chunk)
    for f in ("pose_t", "pose_R", "point"):
        _close(getattr(v, f), getattr(sq, f), 1e-9)


def test_mixed_tracks_converge_as_the_normal_equations(mixed):
    gj, vj, gt, vt = mixed[:4]
    vals_j, err_j = jba.ba_gn_optimize(gj, vj, iterations=8, damping=1e-4)
    vals, err = ba_gn_optimize_sqrt(gt, vt, iterations=8, damping=1e-4,
                                    chunk=16)
    assert _rel(err, err_j) <= 1e-9
    _close(vals.pose_t, vals_j.pose_t, 1e-7)
    _close(vals.point, vals_j.point, 1e-7)


@pytest.mark.parametrize("counts, classes, widths", [
    ([0, 1, 2, 3, 4, 5, 8, 9, 16, 17, 30, 0],
     [0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 0], [2, 4, 8, 16, 30]),
    ([4, 0, 4, 4, 0], [0, 0, 0, 0, 0], [4]),          # one length: one class
    ([3, 3, 0, 7, 5], [0, 0, 0, 1, 1], [3, 7]),        # own widest member
    ([0, 0], [0, 0], [1]),
])
def test_width_classes_follow_the_counts_alone(counts, classes, widths):
    cls, w = ba_solve._width_classes(np.array(counts))
    assert cls.tolist() == classes and w == widths
    perm = np.random.default_rng(0).permutation(len(counts))
    cls_p, w_p = ba_solve._width_classes(np.array(counts)[perm])
    assert cls_p.tolist() == cls[perm].tolist() and w_p == w


def test_width_classes_scatter_only_each_landmarks_own_entries(
        mixed, sqrt80, monkeypatch):
    """The scatter into S takes 36 k^2 elements of each landmark with k
    active rows, none of a padded slot; one track length is one class at
    the reference's shapes."""
    gt, vt = mixed[2:4]
    lay = layout_of(vt)
    tabs = _tabs(gt, vt)
    k = tabs[1].sum(1).numpy()
    np.testing.assert_array_equal(k[:60], TRACKS)
    classes = ba_solve.landmark_classes(gt, lay, tabs[0], tabs[1])
    assert [c.width for c in classes] == [2, 4, 8, 12]
    assert sum(c.gram_entries for c in classes) == 36 * int((k * k).sum())
    for c in classes:
        n, w = c.rows.shape[0], 6 * c.width
        k6 = 6 * k[c.rows.numpy()]
        lm, rest = divmod(c.src.numpy(), w * w)
        i, j = divmod(rest, w)
        np.testing.assert_array_equal(lm, np.repeat(np.arange(n), k6 * k6))
        assert (i < k6[lm]).all() and (j < k6[lm]).all()
        cols = c.cols.numpy()
        np.testing.assert_array_equal(
            c.dst.numpy(), cols[lm, i] * lay.point_off + cols[lm, j])
    scattered = []
    add = torch.Tensor.index_add_

    def counted(self, dim, index, source, **kw):
        if self.numel() == lay.point_off ** 2:
            scattered.append(source.numel())
        return add(self, dim, index, source, **kw)

    monkeypatch.setattr(torch.Tensor, "index_add_", counted)
    ba_solve._landmark_qr_reduce(gt, vt, lay, *tabs, torch.arange(64), 1e-3,
                                 5, classes=classes)
    assert sum(scattered) == 36 * int((k * k).sum())
    monkeypatch.undo()

    gt, vt = sqrt80[:2]
    tabs = _tabs(gt, vt)
    (one,) = ba_solve.landmark_classes(gt, layout_of(vt), tabs[0], tabs[1])
    assert one.width == tabs[0].shape[1]
    np.testing.assert_array_equal(one.rows.numpy(),
                                  np.arange(tabs[0].shape[0]))
    assert torch.equal(one.obs_idx, tabs[0])


def test_bf16x3_assembly_is_three_bf16_products():
    """``assembly_precision="high"``: each Gram block is hi.hi + hi.lo +
    lo.hi of the bf16 split, held to float64 products of the same parts,
    and within bf16x3's error of the exact Gram."""
    r = np.random.default_rng(2)
    red = torch.as_tensor(r.normal(size=(5, 8, 24)) * 1e3, dtype=torch.float32)
    rhs = torch.as_tensor(r.normal(size=(5, 8)), dtype=torch.float32)
    G, gl = ba_solve._gram(red, rhs, "high")
    assert G.dtype == torch.float32
    hi = red.to(torch.bfloat16).double()
    lo = (red.double() - hi).float().to(torch.bfloat16).double()
    ref = hi.transpose(1, 2) @ hi + hi.transpose(1, 2) @ lo \
        + lo.transpose(1, 2) @ hi
    exact = red.double().transpose(1, 2) @ red.double()
    scale = float(exact.abs().max())
    assert float((G.double() - ref).abs().max()) <= 1e-6 * scale
    assert float((G.double() - exact).abs().max()) <= 1e-4 * scale
    assert float((G.double() - exact).abs().max()) > 0.0
    G32, _ = ba_solve._gram(red, rhs, None)
    assert float((G32.double() - exact).abs().max()) <= 1e-6 * scale
    with pytest.raises(ValueError, match="assembly_precision"):
        ba_solve._gram(red, rhs, "highest")


def test_ba_gn_optimize_and_sqrt_match_the_reference(stress):
    gj, vj, gt, vt, _, _, (vals_j, err_j) = stress
    e0 = float(total_error(gt, vt))
    # the graph is noise-free: its optimum's chi2 (~1e-23) is rounding, so
    # chi2 is held to 1e-9 of the larger of it and 1e-9 e0
    floor = 1e-9 * max(float(err_j), 1e-9 * e0)
    vals, err = ba_gn_optimize(gt, vt, iterations=8, damping=1e-4)
    assert abs(float(err) - float(err_j)) <= floor
    vals_s, err_s = ba_gn_optimize_sqrt(gt, vt, iterations=8, damping=1e-4,
                                        chunk=128)
    assert abs(float(err_s) - float(err_j)) <= floor
    for v in (vals, vals_s):
        _close(v.pose_t, vals_j.pose_t, 1e-7)
        _close(v.point, vals_j.point, 1e-7)
    # TestBaStress: chi2 down > 1e4x, trajectory recovered
    assert float(err) < 1e-4 * e0
    _, ts = stress[4][0]
    for k in range(12):
        np.testing.assert_allclose(vals.pose_t[k].numpy(), ts[k], atol=5e-3)


def test_step_clip_on_the_stress_configuration_at_small_size():
    """``ba_sqrt_100k``'s settings (float32, bucket 64, damping 1e-3,
    ``step_clip=1.0``) at 40 poses x 2,000 landmarks: every update is
    clipped to 1 per variable, and chi2 still drops below 0.1 e0."""
    gt, vt, _ = make_ba_graph(n_poses=40, n_points=2000, seed=0,
                              dtype=torch.float32, device="cpu", bucket=64)
    tabs = _tabs(gt, vt)
    e0 = float(total_error(gt, vt))
    v1 = sqrt_schur_gn_step(gt, vt, *tabs, 1e-3, chunk=512, step_clip=1.0)
    lay = layout_of(vt)
    for x0, x1, w in ((vt.pose_t, v1.pose_t, 3), (vt.point, v1.point, 3)):
        assert float((x1 - x0).norm(dim=1).max()) <= 1.0 + 1e-5
    vals, err = ba_gn_optimize_sqrt(gt, vt, iterations=4, damping=1e-3,
                                    chunk=512, step_clip=1.0)
    assert np.isfinite(float(err)) and float(err) < 0.1 * e0
    d = torch.zeros(lay.dim, dtype=torch.float64)
    d[:6] = 10.0
    assert float(ba_solve._clip_nonpoint(d[:lay.point_off], lay, 1.0)[
        :6].norm()) == pytest.approx(1.0)


def test_clip_nonpoint_groups_by_variable_kind():
    """``tests/test_ba.py::test_clip_nonpoint_groups_by_variable_kind`` on
    the port, and against the reference's ``_clip_nonpoint``."""
    lay = TangentLayout(pose_cap=2, vel_cap=2, bias_cap=1, plane_cap=1,
                        point_cap=0)
    dp = np.zeros(lay.point_off)
    dp[lay.pose_off:lay.pose_off + 6] = 0.1
    dp[lay.vel_off + 3:lay.vel_off + 6] = 100.0
    dp[lay.plane_off:lay.plane_off + 3] = 0.2
    out = ba_solve._clip_nonpoint(torch.as_tensor(dp), lay, 1.0).numpy()
    assert out.shape == dp.shape
    np.testing.assert_allclose(out[:6], dp[:6], rtol=1e-6)
    np.testing.assert_allclose(out[lay.plane_off:lay.plane_off + 3],
                               dp[lay.plane_off:lay.plane_off + 3], rtol=1e-6)
    np.testing.assert_allclose(
        np.linalg.norm(out[lay.vel_off + 3:lay.vel_off + 6]), 1.0, rtol=1e-5)
    assert np.abs(out[lay.vel_off:lay.vel_off + 3]).max() == 0.0
    from graph_slam_tpu.graph.variables import TangentLayout as JLayout

    ref = jba._clip_nonpoint(jnp.asarray(dp), JLayout(*lay), 1.0)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-15, atol=0)


# -- the reference's own BA gates, on the port --------------------------------


def _schur_scene(n_poses=4, n_pts=30, seed=1):
    """``TestSchur._make_ba_graph`` on the port (its projections by the
    port's camera)."""
    r = np.random.default_rng(seed)
    gt_poses = [np_lie.se3_exp(np.concatenate([r.normal(size=3) * 0.05,
                                               [0.3 * k, 0.0, 0.0]]))
                for k in range(n_poses)]
    pts = np.stack([r.uniform(-1.5, 1.5, n_pts), r.uniform(-1, 1, n_pts),
                    r.uniform(2, 4, n_pts)], axis=1)
    K = cal3ds2.Cal3DS2.make(SR4000.fx, SR4000.fy, SR4000.cx, SR4000.cy,
                             SR4000.k1, SR4000.k2, device="cpu")
    b = GraphBuilder()
    for k, (R, t) in enumerate(gt_poses):
        b.add_pose((R, t) if k == 0
                   else np_lie.retract((R, t), r.normal(size=6) * 0.02))
    b.add_prior_pose(0, gt_poses[0], sigmas=np.full(6, 1e-7))
    for q in range(n_pts):
        b.add_point(pts[q] + r.normal(size=3) * 0.02)
        b.add_prior_point(q, pts[q], sigma=0.1)
    for k, (R, t) in enumerate(gt_poses):
        Ri, ti = np_lie.inverse((R, t))
        local = (Ri @ pts.T).T + ti
        uv = cal3ds2.project_point(K, torch.as_tensor(local)).numpy()
        for q in range(n_pts):
            if local[q, 2] > 0.1:
                b.add_projection_factor(k, q, uv[q], SR4000, sigma=1.0)
    return b.build(bucket=16, device="cpu"), gt_poses, pts


def test_schur_matches_dense_lm():
    (graph, values), gt_poses, pts = _schur_scene()
    vals, err = ba_gn_optimize(graph, values, iterations=10)
    res = lm_optimize(graph, values)
    assert float(err) < 1e-8
    assert abs(float(err) - float(res.error)) <= 1e-8
    for k, (R, t) in enumerate(gt_poses):
        np.testing.assert_allclose(vals.pose_t[k].numpy(), t, atol=1e-5)
    np.testing.assert_allclose(vals.point[:len(pts)].numpy(), pts, atol=1e-4)


def test_sqrt_schur_with_point_priors_matches_normal_equations():
    (graph, values), _, _ = _schur_scene()
    _, err = ba_gn_optimize_sqrt(graph, values, iterations=10, damping=1e-6)
    _, err_ne = ba_gn_optimize(graph, values, iterations=10, damping=1e-6)
    assert float(err) < 1e-8
    assert abs(float(err) - float(err_ne)) <= 1e-8


@pytest.mark.parametrize("precision", [None, "high"])
def test_sqrt_schur_converges_in_float32(precision):
    """``TestSqrtSchur``'s float32 gate, exact and bf16x3 assembly: chi2
    down > 1e3x and the trajectory recovered to 1 cm."""
    graph, values, (gt_poses, _) = make_ba_graph(
        n_poses=10, n_points=300, obs_per_point=4, seed=5, pixel_noise=0.0,
        dtype=torch.float32, device="cpu", bucket=32)
    e0 = float(total_error(graph, values))
    vals, err = ba_gn_optimize_sqrt(graph, values, iterations=8,
                                    damping=1e-4, chunk=128,
                                    assembly_precision=precision)
    assert float(err) < 1e-3 * e0, (e0, float(err))
    _, ts = gt_poses
    np.testing.assert_allclose(vals.pose_t[:10].numpy(), np.stack(ts),
                               atol=1e-2)


def _golden_ba(builder):
    fx = json.load(open(os.path.join(GOLDEN, "ba_fixture.json")))
    b = builder()
    for R, t in fx["init_poses"]:
        b.add_pose((np.asarray(R), np.asarray(t)))
    pR, pt = fx["prior_pose"]
    b.add_prior_pose(0, (np.asarray(pR), np.asarray(pt)),
                     sigmas=np.full(6, 1e-6))
    for q, p in enumerate(fx["init_points"]):
        b.add_point(np.asarray(p))
        b.add_prior_point(q, np.asarray(p), sigma=fx["point_prior_sigma"])
    body = (np.asarray(fx["body_R"]), np.asarray(fx["body_t"]))
    for k, q, uv in fx["obs"]:
        b.add_projection_factor(k, q, np.asarray(uv), fx["cal"],
                                body_pose=body, sigma=1.0)
    return b


def test_ba_fixture_reaches_pinned_optimum():
    """``TestBaGolden`` on the port: LM, the square-root and the
    normal-equations Schur each land on the pinned optimum."""
    pins = json.load(open(os.path.join(GOLDEN, "chi2.json")))
    graph, values = _golden_ba(GraphBuilder).build(bucket=8, device="cpu")
    assert _rel(total_error(graph, values), pins["ba_error0"]) <= 1e-6
    res = lm_optimize(graph, values, LMParams(relative_error_tol=1e-14,
                                              absolute_error_tol=1e-14))
    assert _rel(res.error, pins["ba_error"]) <= 1e-6
    _, err_sqrt = ba_gn_optimize_sqrt(graph, values, iterations=25,
                                      damping=1e-6)
    assert _rel(err_sqrt, pins["ba_error"]) <= 1e-6
    _, err_ne = ba_gn_optimize(graph, values, iterations=25, damping=1e-6)
    assert _rel(err_ne, pins["ba_error"]) <= 1e-6


def test_ba_graph_same_optimum_as_the_numpy_oracle():
    """``TestNumpyParityBa`` on the port: the NumPy LM and the port's LM
    and square-root Schur reach the same chi2."""
    r = np.random.default_rng(11)
    n_poses, n_pts = 3, 25
    cal9 = (SR4000.fx, SR4000.fy, 0.0, SR4000.cx, SR4000.cy, SR4000.k1,
            SR4000.k2, 0.0, 0.0)
    bR = np_lie.so3_exp(np.array([0.0, 0.05, 0.0]))
    bt = np.array([0.05, 0.0, 0.01])
    gt_poses = [(np_lie.so3_exp(np.array([0.0, 0.1 * k, 0.0])),
                 np.array([0.3 * k, 0.0, 0.0])) for k in range(n_poses)]
    pts = np.stack([r.uniform(-1, 1, n_pts), r.uniform(-1, 1, n_pts),
                    r.uniform(2.5, 5.0, n_pts)], axis=1)

    def project(Rt, q):
        R, t = np_lie.compose(Rt, (bR, bt))
        return npo.cal3ds2_project(cal9, R.T @ (q - t))

    obs = [(k, q, project(gt_poses[k], pts[q]) + r.normal(size=2) * 0.3)
           for k in range(n_poses) for q in range(n_pts)]
    init_poses = [gt_poses[0]] + [
        (np_lie.so3_exp(r.normal(size=3) * 0.02) @ R,
         t + r.normal(size=3) * 0.03) for R, t in gt_poses[1:]]
    init_pts = pts + r.normal(size=pts.shape) * 0.05

    b = GraphBuilder()
    for Rt in init_poses:
        b.add_pose(Rt)
    b.add_prior_pose(0, gt_poses[0], sigmas=np.full(6, 1e-6))
    for q in range(n_pts):
        b.add_point(init_pts[q])
        b.add_prior_point(q, init_pts[q], sigma=0.5)
    for k, q, uv in obs:
        b.add_projection_factor(k, q, uv, cal9, body_pose=(bR, bt),
                                sigma=1.0)
    graph, values = b.build(bucket=8, device="cpu")
    res = lm_optimize(graph, values, LMParams(relative_error_tol=1e-14,
                                              absolute_error_tol=1e-14))

    factors = [npo.prior_pose_factor(0, gt_poses[0], np.eye(6) * 1e6)]
    factors += [npo.prior_point_factor(q, init_pts[q], np.eye(3) / 0.5)
                for q in range(n_pts)]
    factors += [npo.projection_factor(k, q, uv, cal9, (bR, bt), np.eye(2))
                for k, q, uv in obs]
    nv = npo.NpValues(init_poses, points=list(init_pts))
    e0_np = npo.total_error(factors, nv)
    _, err_np = npo.lm_optimize(factors, nv, max_iters=100)
    assert _rel(total_error(graph, values), e0_np) <= 1e-9
    assert _rel(res.error, err_np) <= 1e-6
    _, err_sqrt = ba_gn_optimize_sqrt(graph, values, iterations=25,
                                      damping=1e-6)
    assert _rel(err_sqrt, err_np) <= 1e-6


# -- gather PCG and convert ---------------------------------------------------


def test_gather_pcg_on_ba_graph_matches_the_reference():
    """``test_sparsity.py::test_gather_pcg_on_ba_graph`` on the port and
    against the reference: the incidence table bit-equal, the gather-PCG
    GN within 1e-9 of the reference's and 1e-3 of the dense GN."""
    gj, vj, _ = j_make_ba_graph(n_poses=6, n_points=80, obs_per_point=3,
                                seed=3, dtype=jnp.float64, bucket=8)
    gt, vt = _port(gj, vj)
    inc_j = jsparsity.build_incidence(gj, vj)
    inc = build_incidence(gt, vt)
    np.testing.assert_array_equal(inc.idx.numpy(), np.asarray(inc_j.idx))
    e0 = float(total_error(gt, vt))
    res_gj = j_gn_optimize(gj, vj, iterations=6, solver="pcg", pcg_iters=500,
                           damping=1e-6, inc=inc_j)
    res_g = gn_optimize(gt, vt, iterations=6, solver="pcg", pcg_iters=500,
                        damping=1e-6, inc=inc)
    res_d = gn_optimize(gt, vt, iterations=6, solver="dense", damping=1e-6)
    assert float(res_g.error) < 0.05 * e0
    assert _rel(res_g.error, res_d.error) <= 1e-3
    assert _rel(res_g.error, res_gj.error) <= 1e-9


def test_convert_carries_a_ba_graph_arena_and_camera(small_ba):
    gj, vj, gt, vt = small_ba
    _tables_equal(gt, vt, gj, vj)       # the builders agree ...
    g2, v2 = _port(gj, vj)              # ... and so does the conversion
    _tables_equal(g2, v2, gj, vj)
    back = convert.to_numpy(g2)
    for name in gj._fields:
        for f in getattr(gj, name)._fields:
            np.testing.assert_array_equal(getattr(getattr(back, name), f),
                                          np.asarray(getattr(getattr(
                                              gj, name), f)))
    Kj, _ = _cams()
    K = convert.cal3ds2_from_numpy(_np_tree(Kj), device="cpu")
    assert isinstance(K, cal3ds2.Cal3DS2)
    np.testing.assert_array_equal(torch.stack(list(K)).numpy(), CAL9)
