"""Parity of the port's plane stack with the JAX package on the CPU in
float64: the PSD repair, the covariance transform, landmark association,
RANSAC extraction, the plane factor rows, the online graph's plane
writers, and the rescue's plane prediction; and, port only, the
prediction's coverage gate and the rescue's growing flush.

Inputs are made from seeds with numpy and fed to both packages. Frames are
rendered by ``tests/test_plane_node.render`` (the two-plane room, 2 mm
depth noise) and fed as float64. Tolerances, each with its reason:

- ``repair_plane_cov``/``inflate_if_uncertain``: exact (the same numpy);
- ``transform_plane_cov``: 1e-12 (the same closed form);
- association: the same landmark ids in the same order (host numpy);
- extraction: masks bit-equal, parameters 1e-9; the RANSAC draws differ
  between the packages, so these scenes are ones where the detection does
  not depend on the draw (``test_extraction_does_not_depend_on_the_draw``);
- the plane factor: error and Jacobian 1e-10 (closed form against the
  reference's autodiff and ``torch.func.jacfwd``);
- the prediction: kept planes, carried ids and masks equal, parameters
  1e-9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_slam_tpu.core import se3 as jse3
from graph_slam_tpu.graph import factors as jfactors
from graph_slam_tpu.graph import online as jonline
from graph_slam_tpu.graph.variables import empty_arena as j_empty_arena
from graph_slam_tpu.planes import association as jassoc
from graph_slam_tpu.planes import plane_node as jnode
from graph_slam_tpu.planes import psd as jpsd
from graph_slam_tpu_torch import convert
from graph_slam_tpu_torch.config import SR4000, SlamParams
from graph_slam_tpu_torch.core import se3, so3
from graph_slam_tpu_torch.graph import factors, online
from graph_slam_tpu_torch.graph.variables import empty_arena
from graph_slam_tpu_torch.pipelines import VioConfig, vio_planes
from graph_slam_tpu_torch.planes import association, extraction, plane_node
from graph_slam_tpu_torch.planes import psd
from test_plane_node import K as JK
from test_plane_node import render

torch.set_num_threads(1)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _rot(w):
    return so3.expmap(torch.as_tensor(w, dtype=torch.float64)).numpy()


def _planes(r, n):
    return np.concatenate([_unit(r.normal(size=(n, 3))),
                           r.normal(size=(n, 1))], axis=-1)


def _covs(r, n, scale=1e-4):
    A = r.normal(size=(n, 3, 3)) * np.sqrt(scale)
    return A @ A.transpose(0, 2, 1) + np.eye(3) * 1e-9


# -- psd ---------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1e-9, 1e-6, 1e-3, 1.0])
def test_repair_plane_cov_matches_reference(scale):
    r = np.random.default_rng(int(-np.log10(scale)))
    for S in _covs(r, 20, scale):
        S[0, 1] += 1e-3 * scale       # asymmetric, as a refit can give
        np.testing.assert_array_equal(psd.repair_plane_cov(S),
                                      jpsd.repair_plane_cov(S))


@pytest.mark.parametrize("trace,new", [(0.5, True), (0.5, False),
                                       (2.0, True), (2.0, False)])
def test_inflate_if_uncertain_matches_reference(trace, new):
    S = _covs(np.random.default_rng(3), 1)[0]
    a, b = psd.inflate_if_uncertain(S, trace, new), \
        jpsd.inflate_if_uncertain(S, trace, new)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]


def test_repair_step_flips_under_rounding():
    """The hazard of the 1e-8 quantization: a diagonal one ulp below a step
    and the same diagonal one ulp above it land a whole step apart, so a
    covariance that differs by rounding can change the factor's
    sqrt-information by far more than rounding. Fed the same covariance,
    both packages agree exactly (the test above). On this file's
    ``transform_plane_cov`` inputs (port and reference differ there by
    ~1e-18 absolute), 0 of 60 repaired diagonals land on another step."""
    step = 7e-8                                     # on a step boundary
    below = np.diag([np.nextafter(step, 0.0), 2e-6, 3e-6])
    above = np.diag([np.nextafter(step, 1.0), 2e-6, 3e-6])
    jump = psd.repair_plane_cov(above)[0, 0] - psd.repair_plane_cov(
        below)[0, 0]
    assert abs(jump - 1e-8) < 1e-15
    assert jump == jpsd.repair_plane_cov(above)[0, 0] - \
        jpsd.repair_plane_cov(below)[0, 0]

    r = np.random.default_rng(11)
    planes, covs = _planes(r, 20), _covs(r, 20, 1e-5)
    pose = _rot([0.1, -0.2, 0.3]), np.array([0.5, -0.1, 0.2])
    _, cb = association.transform_plane_cov(
        torch.as_tensor(planes), torch.as_tensor(covs),
        se3.Pose(*map(torch.as_tensor, pose)))
    _, cbj = jax.vmap(jassoc.transform_plane_cov, (0, 0, None))(
        jnp.asarray(planes), jnp.asarray(covs), jse3.Pose(*map(jnp.asarray,
                                                               pose)))
    flips = sum(int((np.diag(psd.repair_plane_cov(a))
                     != np.diag(jpsd.repair_plane_cov(b))).sum())
                for a, b in zip(_np(cb), np.asarray(cbj)))
    assert flips == 0


# -- association ---------------------------------------------------------------


def _pose(r):
    return _rot(r.normal(size=3) * 0.4), r.normal(size=3)


@pytest.mark.parametrize("seed", [0, 1])
def test_transform_plane_cov_matches_reference(seed):
    r = np.random.default_rng(seed)
    planes, covs = _planes(r, 16), _covs(r, 16)
    planes[:4, :3] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0]]
    R, t = _pose(r)
    out, cov = association.transform_plane_cov(
        torch.as_tensor(planes), torch.as_tensor(covs),
        se3.Pose(torch.as_tensor(R), torch.as_tensor(t)))
    oj, cj = jax.vmap(jassoc.transform_plane_cov, (0, 0, None))(
        jnp.asarray(planes), jnp.asarray(covs),
        jse3.Pose(jnp.asarray(R), jnp.asarray(t)))
    np.testing.assert_allclose(_np(out), np.asarray(oj), atol=1e-12)
    np.testing.assert_allclose(_np(cov), np.asarray(cj), atol=1e-12 * 1e-4)


def test_plane_to_world_and_match_plane_match_reference():
    r = np.random.default_rng(4)
    R, t = _pose(r)
    world = _planes(r, 5)
    P, Pj = se3.Pose(torch.as_tensor(R), torch.as_tensor(t)), \
        jse3.Pose(jnp.asarray(R), jnp.asarray(t))
    for obs in _planes(r, 4):
        np.testing.assert_allclose(
            _np(association.plane_to_world(torch.as_tensor(obs), P)),
            np.asarray(jassoc.plane_to_world(jnp.asarray(obs), Pj)),
            atol=1e-12)
    # an observation of world plane 2 (sign-flipped), and one of nothing
    seen = _np(association.plane_to_world(torch.as_tensor(world[2]),
                                          se3.inverse(P)))
    for obs in (-seen, _planes(r, 1)[0]):
        assert association.match_plane(
            obs, [torch.as_tensor(w) for w in world], P) == \
            jassoc.match_plane(obs, [jnp.asarray(w) for w in world], Pj)
    assert association.match_plane(-seen, [torch.as_tensor(w) for w in world],
                                   P) == 2


def test_landmark_book_sequence_matches_reference():
    """The same observation stream through both books: re-observations of
    a few world planes from moving poses, with noise and sign flips, and
    unmatched planes; the (id, is_new) sequence and the book's state
    agree."""
    r = np.random.default_rng(5)
    world = _planes(r, 3)
    book, jbook = association.PlaneLandmarkBook(), jassoc.PlaneLandmarkBook()
    out, jout = [], []
    for node in range(30):
        R, t = _rot(r.normal(size=3) * 0.05), r.normal(size=3) * 0.05
        k = int(r.integers(0, 4))
        if k < 3:
            n_w, d_w = world[k, :3], world[k, 3]
            obs = np.concatenate([R.T @ n_w, [d_w + n_w @ t]])
            obs = obs + r.normal(size=4) * 0.01
            obs *= -1.0 if r.random() < 0.3 else 1.0
        else:
            obs = _planes(r, 1)[0]
        out.append(book.associate(node, obs, se3.Pose(torch.as_tensor(R),
                                                      torch.as_tensor(t))))
        jout.append(jbook.associate(node, obs, jse3.Pose(jnp.asarray(R),
                                                         jnp.asarray(t))))
    assert out == jout
    assert any(not new for _, new in out) and any(new for _, new in out)
    assert book.node_landmarks == jbook.node_landmarks
    assert book.seen_count == jbook.seen_count
    np.testing.assert_allclose(np.stack(book.world), np.stack(jbook.world),
                               atol=1e-12)


# -- extraction ----------------------------------------------------------------


def _frame(t=(0.05, 0.0, 0.1), w=(0.0, 0.0, 0.0), seed=1):
    X = jse3.Pose(jnp.asarray(_rot(np.asarray(w, float))),
                  jnp.asarray(t, jnp.float64))
    inten, depth = render(X, noise=0.002, seed=seed)
    return inten, depth.astype(np.float64)


@pytest.fixture(scope="module")
def room():
    inten, depth = _frame()
    dets = [plane_node.extract_plane_node((s, 0, 1), SR4000, depth,
                                          device="cpu") for s in (0, 1)]
    jdets = [jnode.extract_plane_node(jax.random.PRNGKey(s), JK, inten,
                                      depth) for s in (0, 1)]
    return inten, depth, dets, jdets


def test_extraction_matches_reference(room):
    _, _, (det, _), (jdet, _) = room
    assert len(det) == len(jdet) == 2
    np.testing.assert_array_equal(det.masks, jdet.masks)
    np.testing.assert_array_equal(det.counts, jdet.counts)
    np.testing.assert_array_equal(det.landmark_ids, jdet.landmark_ids)
    np.testing.assert_allclose(det.params, jdet.params, atol=1e-9)
    np.testing.assert_allclose(det.cov, jdet.cov, rtol=1e-9, atol=0)
    # the wall z = 4 and the floor y = 0.8, seen from (0.05, 0, 0.1)
    for n, d in (([0, 0, 1], 3.9), ([0, 1, 0], 0.8)):
        assert any(abs(p[:3] @ n) > 0.99 and abs(abs(p[3]) - d) < 0.05
                   for p in det.params)


def test_extraction_does_not_depend_on_the_draw(room):
    """Two seeds give the same detection in both packages: every refit on
    the two-plane room ends on the same inlier set whatever the draw,
    which is what lets the packages' different draws agree."""
    _, _, dets, jdets = room
    for a, b in (dets, jdets):
        np.testing.assert_array_equal(a.masks, b.masks)
        np.testing.assert_array_equal(a.params, b.params)


def test_draw_is_keyed_and_maps_to_remaining_points():
    u = extraction.hypothesis_uniforms((0, 0, 7), 4, 512)
    assert u.shape == (4, 512, 3) and u.dtype == torch.float64
    assert torch.equal(u, extraction.hypothesis_uniforms((0, 0, 7), 4, 512))
    assert not torch.equal(u, extraction.hypothesis_uniforms((0, 0, 8), 4,
                                                             512))
    remaining = torch.tensor([[False, True, False, True, True, False]])
    k = torch.tensor([[0.0, 0.34, 0.67, 0.999]], dtype=torch.float64)
    assert extraction._sample(k, remaining).tolist() == [[1, 3, 4, 4]]
    none = torch.zeros_like(remaining)
    assert extraction._sample(k, none).max() < 6


# -- plane factor --------------------------------------------------------------


def _factor_rows(seed, F=8):
    """Poses, landmarks and measurements: noisy observations, coincident
    normals (rows 0-1: meas == prediction) and a row whose normal's largest
    component changes the tangent basis's axis."""
    r = np.random.default_rng(seed)
    R = np.stack([_rot(w) for w in r.normal(size=(F, 3)) * 0.5])
    t = r.normal(size=(F, 3))
    L = _planes(r, F)
    n_p = np.einsum("fji,fj->fi", R, L[:, :3])
    pred = np.concatenate([n_p, (L[:, 3] + np.sum(L[:, :3] * t, -1))[:, None]],
                          -1)
    meas = pred + np.concatenate([r.normal(size=(F, 3)) * 0.05,
                                  r.normal(size=(F, 1)) * 0.01], -1)
    meas[:2] = pred[:2]
    meas[2, :3] = _unit(np.array([0.6, 0.6, 0.52]))
    meas[:, :3] = _unit(meas[:, :3])
    return R, t, L, meas


def _ref_plane_graph(R, t, L, meas, S):
    F = len(R)
    vals = j_empty_arena(pose_cap=F, plane_cap=F)._replace(
        pose_R=jnp.asarray(R), pose_t=jnp.asarray(t), plane=jnp.asarray(L),
        num_poses=jnp.asarray(F), num_planes=jnp.asarray(F))
    graph = jfactors.empty_graph(plane_cap=F)
    graph = graph._replace(plane=graph.plane._replace(
        pose_idx=jnp.arange(F), plane_idx=jnp.arange(F),
        meas=jnp.asarray(meas), sqrt_info=jnp.asarray(S),
        active=jnp.ones(F, bool)))
    return graph, vals


@pytest.mark.parametrize("seed", [0, 1])
def test_plane_factor_matches_reference(seed):
    R, t, L, meas = _factor_rows(seed)
    S = np.linalg.cholesky(np.linalg.inv(_covs(np.random.default_rng(seed),
                                               len(R), 1e-4))).transpose(
        0, 2, 1)
    jg, jv = _ref_plane_graph(R, t, L, meas, S)
    g = convert.graph_from_numpy(jax.tree.map(np.asarray, jg), device="cpu")
    v = convert.arena_from_numpy(jax.tree.map(np.asarray, jv), device="cpu")
    e, ej = float(factors.total_error(g, v)), float(jfactors.total_error(jg,
                                                                         jv))
    assert abs(e - ej) <= 1e-10 * max(1.0, abs(ej))
    (r, J, cols), = factors.linearize_blocks(g, v)
    (rj, Jj, colsj), = jfactors.linearize_blocks(jg, jv)
    np.testing.assert_allclose(_np(r), np.asarray(rj), atol=1e-10)
    np.testing.assert_allclose(_np(J), np.asarray(Jj), atol=1e-10)
    np.testing.assert_array_equal(_np(cols), np.asarray(colsj))


def test_plane_jacobian_matches_jacfwd_and_is_finite_in_float32():
    """The closed form against ``torch.func.jacfwd`` of the residual in
    float64, coincident normals included; in float32 it stays finite there
    (the chart's atan2 form) and within float32 rounding of float64."""
    R, t, L, meas = _factor_rows(2)
    g = factors._PlaneRows(*map(torch.as_tensor, (R, t, L, meas)))
    J = factors._plane_jacobian(g)
    Jf = torch.stack([
        torch.func.jacfwd(lambda d, i=i: factors._plane_residual(
            factors._PlaneRows(*(x[i] for x in g)), d))(
            torch.zeros(9, dtype=torch.float64)) for i in range(len(R))])
    np.testing.assert_allclose(_np(J), _np(Jf), atol=1e-10)
    J32 = factors._plane_jacobian(factors._PlaneRows(
        *(x.float() for x in g)))
    assert bool(torch.isfinite(J32).all())
    np.testing.assert_allclose(_np(J32), _np(J), atol=1e-5)


# -- online graph ----------------------------------------------------------------


def test_online_plane_writers_and_grow_match_reference():
    r = np.random.default_rng(6)
    planes = _planes(r, 5) * 1.5          # not unit: the writers normalize
    meas = _planes(r, 4) * 0.9
    S = np.tile(np.eye(3) * 30.0, (4, 1, 1))
    og = online.OnlineGraph(factors.empty_graph(plane_cap=2, device="cpu"),
                            empty_arena(3, plane_cap=2, device="cpu"))
    jog = jonline.OnlineGraph(jfactors.empty_graph(plane_cap=2),
                              j_empty_arena(pose_cap=3, plane_cap=2))
    for o in (og, jog):
        o.set_planes([0, 1], planes[:2])
        o.add_plane_factors([0, 1], [1, 0], meas[:2], S[:2])
        o.grow(plane_var_cap=8, factor_caps={"plane": 8})
        o.set_planes([2], planes[2:3])
        o.set_planes([3, 4], planes[3:])
        o.add_plane_factors([2], [3], meas[2:3], S[2:3])
        o.add_plane_factors([0], [4], meas[3:], S[3:])
    assert og.num_planes == jog.num_planes == 5
    assert og._n["plane"] == jog._n["plane"] == 4
    np.testing.assert_allclose(_np(og.values.plane),
                               np.asarray(jog.values.plane), atol=1e-15)
    assert int(og.values.num_planes) == int(jog.values.num_planes)
    for f in factors.PlaneTable._fields:
        np.testing.assert_allclose(_np(getattr(og.graph.plane, f)),
                                   np.asarray(getattr(jog.graph.plane, f)),
                                   atol=1e-15, err_msg=f)
    with pytest.raises(RuntimeError, match="plane variable arena full"):
        og.set_planes([8], planes[:1])


# -- prediction ----------------------------------------------------------------


@pytest.fixture(scope="module")
def rescue_pair(room):
    """Frame A (``room``'s) and frame B after a small motion, with the
    relative pose a rescue would predict."""
    inten_b, depth_b = _frame(t=(0.08, 0.01, 0.16), w=(0.01, -0.02, 0.0),
                              seed=2)
    pre = np.eye(3), np.array([0.05, 0.0, 0.1])
    est = _rot([0.01, -0.02, 0.0]), np.array([0.08, 0.01, 0.16])
    S66 = np.diag([1e-6] * 3 + [1e-5] * 3)
    return room[3][0], pre, est, S66, inten_b, depth_b


@pytest.mark.parametrize("kept,ids", [([0, 1], [7, 3]), ([1], [3, -1])])
def test_predict_plane_node_matches_reference(rescue_pair, kept, ids):
    """A rescue pair through ``predict_plane_node_start``/``_finish``: both
    planes carried (their ids kept), or the floor only, whose 14% of the
    frame sends the rest through the fresh extraction, which finds the wall
    (id -1) past the overlap merge."""
    jprev, pre, est, S66, inten, depth = rescue_pair
    jprev = dataclasses.replace(
        jprev, params=jprev.params[kept], cov=jprev.cov[kept],
        masks=jprev.masks[kept], counts=jprev.counts[kept],
        landmark_ids=np.asarray([7, 3], np.int64)[kept])
    prev = convert.plane_node_from_numpy(jprev)
    args = [*pre, *est, S66]
    jdet, (jpb, jcb) = jnode.predict_plane_node_finish(
        jnode.predict_plane_node_start(
            jax.random.PRNGKey(3), JK, jprev,
            *(jnp.asarray(a) for a in args), inten, depth))
    det, (pb, cb) = plane_node.predict_plane_node_finish(
        plane_node.predict_plane_node_start(
            (0, 1, 1), SR4000, prev, *(torch.as_tensor(a) for a in args),
            inten, depth))
    assert list(det.landmark_ids) == list(jdet.landmark_ids) == ids
    np.testing.assert_array_equal(det.masks, jdet.masks)
    np.testing.assert_array_equal(det.counts, jdet.counts)
    np.testing.assert_allclose(det.params, jdet.params, atol=1e-9)
    np.testing.assert_allclose(det.cov, jdet.cov, rtol=1e-9, atol=0)
    np.testing.assert_allclose(pb, jpb, atol=1e-9)
    np.testing.assert_allclose(cb, jcb, rtol=1e-9, atol=0)


@pytest.mark.parametrize("kept,runs", [([0, 1], False), ([1], True)])
def test_coverage_gate_enqueues_the_extraction_only_when_it_runs(
        rescue_pair, kept, runs, monkeypatch):
    """The reference's ``lax.cond``: with both planes carried they cover
    more than half the frame and no extraction is enqueued (the handle
    holds none); with the floor only (14%) the extraction runs once."""
    jprev, pre, est, S66, inten, depth = rescue_pair
    prev = convert.plane_node_from_numpy(dataclasses.replace(
        jprev, params=jprev.params[kept], cov=jprev.cov[kept],
        masks=jprev.masks[kept], counts=jprev.counts[kept],
        landmark_ids=np.arange(len(kept), dtype=np.int64)))
    calls = []
    monkeypatch.setattr(plane_node, "extract_planes",
                        lambda *a, **k: calls.append(1)
                        or extraction.extract_planes(*a, **k))
    handle = plane_node.predict_plane_node_start(
        (0, 1, 1), SR4000, prev,
        *(torch.as_tensor(a) for a in [*pre, *est, S66]), inten, depth)
    res = handle[1]
    covered = int(torch.where(res.ok, res.count, 0).sum())
    assert (covered <= 0.5 * depth.size) == runs
    assert len(calls) == int(runs)
    assert (handle[2] is not None) == runs
    det, _ = plane_node.predict_plane_node_finish(handle)
    assert len(det) == 2


def test_plane_stack_flush_grows_the_arenas():
    """The rescue's flush writes staged landmarks, then their factor rows,
    re-homing a full landmark arena and plane-factor table first (twice
    the capacity, at least 8 landmarks and 64 rows); a landmark staged out
    of append order is refused."""
    r = np.random.default_rng(7)
    og = online.OnlineGraph(factors.empty_graph(plane_cap=2, device="cpu"),
                            empty_arena(3, plane_cap=2, device="cpu"))
    flush = vio_planes._PlaneStack(og, VioConfig(), SlamParams(), SR4000,
                                   None, None, None, "cpu", torch.float64,
                                   None)._flush
    planes = _planes(r, 3)
    rows = [(k % 3, k % 3, _planes(r, 1)[0], np.eye(3) * (k + 1))
            for k in range(5)]
    flush(list(enumerate(planes)), rows)
    assert og.values.plane.shape[0] == 8 and og.num_planes == 3
    assert og.graph.plane.pose_idx.shape[0] == 64 and og._n["plane"] == 5
    np.testing.assert_allclose(_np(og.values.plane)[:3], planes,
                               atol=1e-15)
    np.testing.assert_array_equal(_np(og.graph.plane.plane_idx)[:5],
                                  [0, 1, 2, 0, 1])
    np.testing.assert_allclose(_np(og.graph.plane.sqrt_info)[:5],
                               np.stack([r[3] for r in rows]))
    with pytest.raises(RuntimeError, match="append invariant"):
        flush([(4, planes[0])], [])
