"""Parity of the port's visual frontend with the JAX package, on the CPU:
Harris and SIFT extraction, descriptor matching, Umeyama, RANSAC, PnP,
the VO information, the frontend's pairwise and batched matchers, and
place recognition; and the cases of ``tests/test_sift.py``,
``test_place.py`` and ``test_pnp.py`` on the port.

The frames are ``test_pipelines2.render_wall_frame``'s SR4000 wall and
``test_sift.py``'s 160 x 160 texture, each extracted once by each package
in module-scoped fixtures. Matchers are held to JAX on the SAME features
(the reference's, carried over with ``convert.feature_frame_from_numpy``).

The RANSAC draws cannot be JAX's (``jax.random.categorical``), so the
matchers are compared where the answer does not depend on the draw:
exact frames, where every hypothesis drawn from true matches finds the
same consensus set.

Tolerances, each with its reason:
- Harris response and DoG score 1e-5 relative, descriptors and 3D points
  1e-5 (float32 convolutions and reductions summed in another order);
  keypoints, their octaves and scales, the valid sets: equal;
- ``match_descriptors`` on the same descriptors: equal;
- ``umeyama`` 1e-12 (float64) and 1e-5 (float32);
- ``vo_information`` 1e-6 relative (float32 sums of 256 rows);
- matchers on exact frames: ``ok`` and inlier masks equal, R and t within
  1e-5 (float32 SVDs of the same inlier set);
- PnP: inlier masks equal, R and t within 1e-6 (both iterate to the same
  least-squares optimum);
- the codebook bit-equal, global descriptors 1e-6, query ids equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import np_lie
from test_pipelines2 import render_wall_frame

from graph_slam_tpu.config import CameraIntrinsics as JCameraIntrinsics
from graph_slam_tpu.config import SR4000 as J_SR4000
from graph_slam_tpu.vision import cal3ds2 as jcal
from graph_slam_tpu.vision import features as jfeat
from graph_slam_tpu.vision import frontend as jfront
from graph_slam_tpu.vision import matching as jmatch
from graph_slam_tpu.vision import place as jplace
from graph_slam_tpu.vision import sift as jsift
from graph_slam_tpu_torch import convert
from graph_slam_tpu_torch.config import CameraIntrinsics, SR4000
from graph_slam_tpu_torch.vision import (Cal3DS2, FeatureFrame,
                                         MatchingResult, PlaceIndex,
                                         dog_keypoints, extract_features,
                                         get_extractor, global_descriptor,
                                         harris_corners, match_descriptors,
                                         match_frames_device,
                                         match_node_pair, match_one_to_many,
                                         pnp_ransac, project_point,
                                         ransac_rigid, sift_features,
                                         umeyama, vo_information)
from graph_slam_tpu_torch.vision import place as tplace
from graph_slam_tpu_torch.vision.features import stack_frames

CPU = "cpu"
XS = (0.0, 0.12, 0.06, 0.18)          # wall frames: camera x in metres


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(
        x, torch.Tensor) else x)


def _port(frame):
    """A JAX FeatureFrame -> the port's, on the CPU."""
    return convert.feature_frame_from_numpy(
        jax.tree.map(np.asarray, frame), device=CPU)


@pytest.fixture(scope="module")
def walls():
    """(images, JAX features, port features) of the wall frames."""
    imgs = [render_wall_frame(SR4000, np.array([x, 0.0, 0.0])) for x in XS]
    jf = [jfeat.extract_features(J_SR4000, jnp.asarray(i), jnp.asarray(d))
          for i, d in imgs]
    tf = [extract_features(SR4000, i, d, device=CPU) for i, d in imgs]
    return imgs, jf, tf


# ---------------------------------------------------------------- Harris
def test_harris_response_matches_jax(walls):
    (img, _), *_ = walls[0]
    uv_j, s_j = jfeat.harris_corners(jnp.asarray(img))
    uv_t, s_t = harris_corners(torch.as_tensor(img))
    np.testing.assert_array_equal(_np(uv_t), np.asarray(uv_j))
    s_j = np.asarray(s_j)
    fin = np.isfinite(s_j)
    np.testing.assert_array_equal(np.isfinite(_np(s_t)), fin)
    np.testing.assert_allclose(_np(s_t)[fin], s_j[fin], rtol=1e-5)


@pytest.mark.parametrize("k", range(len(XS)))
def test_extract_features_matches_jax(walls, k):
    _, jf, tf = walls
    a, b = jf[k], tf[k]
    np.testing.assert_array_equal(_np(b.valid), np.asarray(a.valid))
    np.testing.assert_array_equal(_np(b.uv), np.asarray(a.uv))
    np.testing.assert_allclose(_np(b.desc), np.asarray(a.desc), atol=1e-5)
    np.testing.assert_allclose(_np(b.pts3), np.asarray(a.pts3), atol=1e-5)
    assert b.desc.dtype == torch.float32 and b.valid.dtype == torch.bool


def test_patch_crop_clamps_like_dynamic_slice():
    """Fewer candidate pixels than slots (a 30 x 34 image keeps 6 x 10
    inside its border): the -inf slots of the top-k are the first pixels,
    (0, 0) among them, where a patch starts at u - 8 < 0: lax.dynamic_slice
    counts a negative start from the end, then clamps it into the image."""
    img = np.random.default_rng(4).uniform(0, 255, (30, 34)).astype(
        np.float32)
    depth = np.full_like(img, 2.0)
    K = CameraIntrinsics(fx=80.0, fy=80.0, cx=17.0, cy=15.0)
    JK = JCameraIntrinsics(fx=80.0, fy=80.0, cx=17.0, cy=15.0)
    a = jfeat.extract_features(JK, jnp.asarray(img), jnp.asarray(depth),
                               max_features=64)
    b = extract_features(K, img, depth, max_features=64, device=CPU)
    empty = ~np.asarray(a.valid)
    assert empty.sum() > 20 and (np.asarray(a.uv) == 0).all(1).any()
    np.testing.assert_array_equal(_np(b.uv), np.asarray(a.uv))
    np.testing.assert_array_equal(_np(b.valid), np.asarray(a.valid))
    np.testing.assert_allclose(_np(b.desc), np.asarray(a.desc), atol=1e-5)


# -------------------------------------------------------------- matching
@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("ratio", [0.8, 0.95])
def test_match_descriptors_equal_on_the_same_descriptors(walls, mutual,
                                                         ratio):
    _, jf, _ = walls
    idx_j, ok_j = jmatch.match_descriptors(jf[1].desc, jf[0].desc,
                                           ratio=ratio, mutual=mutual)
    idx_t, ok_t = match_descriptors(_port(jf[1]).desc, _port(jf[0]).desc,
                                    ratio=ratio, mutual=mutual)
    np.testing.assert_array_equal(_np(idx_t), np.asarray(idx_j))
    np.testing.assert_array_equal(_np(ok_t), np.asarray(ok_j))
    assert np.asarray(ok_j).sum() > 50


def _rigid_sets(dtype, batch=(), n=30, seed=0):
    r = np.random.default_rng(seed)
    src = r.normal(size=batch + (n, 3))
    R = np_lie.so3_exp(r.normal(size=3) * 0.5)
    dst = src @ R.T + np.array([0.3, -0.2, 0.5]) \
        + r.normal(size=batch + (n, 3)) * 0.01
    w = r.uniform(0.2, 1.0, size=batch + (n,))
    return src.astype(dtype), dst.astype(dtype), w.astype(dtype)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
def test_umeyama_matches_jax(dtype, tol):
    for batch in ((), (5,)):
        src, dst, w = _rigid_sets(dtype, batch)
        Rj, tj = jmatch.umeyama(jnp.asarray(src), jnp.asarray(dst),
                                jnp.asarray(w))
        Rt, tt = umeyama(*(torch.as_tensor(x) for x in (src, dst, w)))
        np.testing.assert_allclose(_np(Rt), np.asarray(Rj), atol=tol)
        np.testing.assert_allclose(_np(tt), np.asarray(tj), atol=tol)


def test_umeyama_degenerate_draws_stay_rotations():
    """Repeated draws (rank-deficient S) and zero weights (S = 0) give a
    finite rotation, as XLA's do."""
    p = torch.tensor([[1.0, 2.0, 3.0]] * 3, dtype=torch.float64)
    cases = [(p, p + 0.5, torch.ones(3, dtype=torch.float64)),
             (p, p, torch.zeros(3, dtype=torch.float64))]
    for src, dst, w in cases:
        R, t = umeyama(src, dst, w)
        assert torch.isfinite(R).all() and torch.isfinite(t).all()
        np.testing.assert_allclose(_np(R @ R.T), np.eye(3), atol=1e-12)
        assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-12


def test_vo_information_matches_jax(walls):
    _, jf, _ = walls
    f = jf[0]
    r = np.random.default_rng(1)
    R = np_lie.so3_exp(r.normal(size=3) * 0.1).astype(np.float32)
    mask = np.asarray(f.valid) & (r.uniform(size=len(f.valid)) < 0.7)
    Ij = np.asarray(jmatch.vo_information(jnp.asarray(R), jnp.zeros(3),
                                          jnp.asarray(mask), f.pts3))
    It = vo_information(torch.as_tensor(R), torch.zeros(3),
                        torch.as_tensor(mask), _port(f).pts3)
    np.testing.assert_allclose(_np(It), Ij, rtol=1e-6,
                               atol=1e-6 * np.abs(Ij).max())


def _corrupted_pairs(n=120, outliers=30, seed=3):
    """Exact rigid pairs in float32 with a planted outlier block."""
    r = np.random.default_rng(seed)
    src = np.stack([r.uniform(-1, 1, n), r.uniform(-0.8, 0.8, n),
                    r.uniform(1.5, 3.5, n)], 1).astype(np.float32)
    R = np_lie.so3_exp(np.array([0.02, -0.05, 0.03]))
    dst = (src @ R.T + np.array([0.1, 0.02, -0.05])).astype(np.float32)
    dst[:outliers] += r.uniform(0.3, 1.0, size=(outliers, 3)).astype(
        np.float32)
    valid = np.ones(n, bool)
    valid[-5:] = False
    return src, dst, valid


def test_ransac_rigid_matches_jax():
    src, dst, valid = _corrupted_pairs()
    Rj, tj, mj, okj = jmatch.ransac_rigid(
        jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(valid), n_hyp=512)
    Rt, tt, mt, okt = ransac_rigid((0,), *(torch.as_tensor(x) for x in
                                           (src, dst, valid)), n_hyp=512)
    assert bool(okj) and bool(okt)
    np.testing.assert_array_equal(_np(mt), np.asarray(mj))
    assert not _np(mt)[:30].any() and _np(mt)[30:-5].all()
    np.testing.assert_allclose(_np(Rt), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(_np(tt), np.asarray(tj), atol=1e-5)


def test_ransac_rigid_without_valid_points_fails():
    """No valid point: the draw is uniform over all points (the
    reference's 1e-30 logits) and the answer is ok=False, finite."""
    src, dst, _ = _corrupted_pairs()
    none = np.zeros(len(src), bool)
    *_, okj = jmatch.ransac_rigid(jax.random.PRNGKey(0), jnp.asarray(src),
                                  jnp.asarray(dst), jnp.asarray(none),
                                  n_hyp=512)
    R, t, m, ok = ransac_rigid((0,), torch.as_tensor(src),
                               torch.as_tensor(dst), torch.as_tensor(none),
                               n_hyp=512)
    assert not bool(okj) and not bool(ok) and not bool(m.any())
    assert torch.isfinite(R).all() and torch.isfinite(t).all()


def test_draws_are_keyed():
    from graph_slam_tpu_torch.vision.matching import uniforms

    a = uniforms((0, 1), (4, 3), CPU)
    assert torch.equal(a, uniforms((0, 1), (4, 3), CPU))
    assert not torch.equal(a, uniforms((0, 2), (4, 3), CPU))
    assert a.dtype == torch.float64 and ((a >= 0) & (a < 1)).all()


# -------------------------------------------------------------- frontend
@pytest.mark.parametrize("pair", [(0, 1), (0, 2), (2, 3)])
def test_match_frames_device_matches_jax(walls, pair):
    _, jf, _ = walls
    i, j = pair
    Rj, tj, Ij, nj, okj = jfront.match_frames_device(
        jax.random.PRNGKey(i), jf[i], jf[j], n_hyp=512)
    Rt, tt, It, nt, okt = match_frames_device(
        (i,), _port(jf[i]), _port(jf[j]), n_hyp=512)
    assert bool(okt) == bool(okj) is True
    assert int(nt) == int(nj)
    np.testing.assert_allclose(_np(Rt), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(_np(tt), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(_np(It), np.asarray(Ij), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(Ij)).max())
    np.testing.assert_allclose(_np(tt)[0], XS[j] - XS[i], atol=5e-3)


def test_match_frames_device_inlier_mask_matches_jax(walls):
    """The inlier mask itself, through ransac_rigid on the matched pairs."""
    _, jf, _ = walls
    a, b = jf[0], jf[1]
    idx, ok = jmatch.match_descriptors(b.desc, a.desc)
    valid = ok & b.valid & a.valid[idx]
    _, _, mj, _ = jmatch.ransac_rigid(jax.random.PRNGKey(5), b.pts3,
                                      a.pts3[idx], valid, n_hyp=512)
    _, _, mt, _ = ransac_rigid((5,), _port(b).pts3, _port(a).pts3[
        torch.as_tensor(np.array(idx))], torch.as_tensor(np.array(valid)),
        n_hyp=512)
    np.testing.assert_array_equal(_np(mt), np.asarray(mj))


def test_match_one_to_many_matches_jax(walls):
    _, jf, _ = walls
    cands_j = jax.tree.map(lambda *xs: jnp.stack(xs), jf[0], jf[2], jf[3])
    out_j = jfront.match_one_to_many(jax.random.PRNGKey(3), jf[1], cands_j,
                                     n_hyp=512)
    cands_t = stack_frames([_port(jf[k]) for k in (0, 2, 3)])
    out_t = match_one_to_many((3,), _port(jf[1]), cands_t, n_hyp=512)
    Rj, tj, Ij, nj, okj = (np.asarray(x) for x in out_j)
    Rt, tt, It, nt, okt = (_np(x) for x in out_t)
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    np.testing.assert_allclose(tt, tj, atol=1e-5)
    np.testing.assert_allclose(It, Ij, rtol=1e-5, atol=1e-5 * np.abs(Ij)
                               .max())
    # candidate c keyed (3, c): its own pairwise match, the same draw
    single = match_frames_device((3, 1), _port(jf[2]), _port(jf[1]),
                                 n_hyp=512)
    np.testing.assert_allclose(_np(single[0]), Rt[1], atol=1e-6)


def test_match_node_pair_record(walls):
    _, _, tf = walls
    res = match_node_pair((0,), tf[0], tf[1], 10, 11, n_hyp=512)
    assert isinstance(res, MatchingResult)
    assert (res.id_from, res.id_to) == (10, 11) and res.valid
    assert isinstance(res.T[0], np.ndarray) and res.information.shape == (
        6, 6)
    assert res.num_inliers >= 12
    assert abs(res.T[1][0] - 0.12) < 5e-3


# ------------------------------------------------------------------- PnP
PNP_CAL = (250.0, 250.0, 90.0, 70.0)


def _pnp_scene(n=200, noise_px=0.5, outliers=40, seed=0,
               xi=(0.02, -0.03, 0.05, 0.1, -0.05, 0.08)):
    """``tests/test_pnp.py``'s scene."""
    r = np.random.default_rng(seed)
    pts = np.stack([r.uniform(-1, 1, n), r.uniform(-0.8, 0.8, n),
                    r.uniform(1.5, 3.5, n)], 1)
    T_ij = np_lie.se3_exp(np.asarray(xi))
    Rji, tji = np_lie.inverse(T_ij)
    pts_j = pts @ Rji.T + tji
    uv = np.array(jcal.project_point(jcal.Cal3DS2.make(*PNP_CAL),
                                     jnp.asarray(pts_j)))
    uv += r.normal(size=(n, 2)) * noise_px
    if outliers:
        bad = r.choice(n, outliers, replace=False)
        uv[bad] += r.uniform(30, 100, size=(outliers, 2))
    return pts, uv, T_ij


def _pnp_pair(pts, uv, seed, **kw):
    valid = np.ones(len(pts), bool)
    j = jmatch.pnp_ransac(jax.random.PRNGKey(seed), jnp.asarray(pts),
                          jnp.asarray(uv), jnp.asarray(valid),
                          jcal.Cal3DS2.make(*PNP_CAL), **kw)
    t = pnp_ransac((seed,), torch.as_tensor(pts), torch.as_tensor(uv),
                   torch.as_tensor(valid), Cal3DS2.make(*PNP_CAL,
                                                        device=CPU), **kw)
    return [np.asarray(x) for x in j], [_np(x) for x in t]


@pytest.fixture(scope="module")
def pnp_runs():
    out = {}
    for seed in (0, 1):
        pts, uv, T = _pnp_scene(seed=seed)
        out[seed] = (pts, uv, T) + tuple(_pnp_pair(pts, uv, seed))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_pnp_matches_jax(pnp_runs, seed):
    _, _, _, (Rj, tj, mj, okj), (Rt, tt, mt, okt) = pnp_runs[seed]
    assert bool(okj) and bool(okt)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_allclose(Rt, Rj, atol=1e-6)
    np.testing.assert_allclose(tt, tj, atol=1e-6)


def test_pnp_recovers_pose_with_outliers(pnp_runs):
    """``test_pnp.py::test_recovers_pose_with_outliers`` on the port."""
    _, _, T_gt, _, (R, t, inl, ok) = pnp_runs[0]
    assert bool(ok)
    assert int(inl.sum()) >= 150
    np.testing.assert_allclose(t, T_gt[1], atol=5e-3)
    np.testing.assert_allclose(R, T_gt[0], atol=2e-3)


def test_pnp_inliers_exclude_corrupted(pnp_runs):
    """``test_pnp.py::test_inliers_exclude_corrupted`` on the port."""
    pts, uv, T_gt, _, (_, _, inl, _) = pnp_runs[1]
    Rji, tji = np_lie.inverse(T_gt)
    uv_true = _np(project_point(Cal3DS2.make(*PNP_CAL, device=CPU),
                                torch.as_tensor(pts @ Rji.T + tji)))
    bad = np.linalg.norm(uv - uv_true, axis=1) > 10
    assert bad.sum() > 0 and not inl[bad].any()


def test_pnp_fails_without_consensus():
    """``test_pnp.py::test_fails_without_consensus`` on the port."""
    r = np.random.default_rng(2)
    pts = np.stack([r.uniform(-1, 1, 60), r.uniform(-0.8, 0.8, 60),
                    r.uniform(1.5, 3.5, 60)], 1)
    uv = r.uniform(0, 180, size=(60, 2))
    *_, ok = pnp_ransac((2,), torch.as_tensor(pts), torch.as_tensor(uv),
                        torch.ones(60, dtype=torch.bool),
                        Cal3DS2.make(*PNP_CAL, device=CPU), min_inliers=12)
    assert not bool(ok)


# ------------------------------------------------------------------ SIFT
SIFT_H = SIFT_W = 160
SIFT_K = CameraIntrinsics(fx=100.0, fy=100.0, cx=SIFT_W / 2, cy=SIFT_H / 2)
J_SIFT_K = JCameraIntrinsics(fx=100.0, fy=100.0, cx=SIFT_W / 2,
                             cy=SIFT_H / 2)


@pytest.fixture(scope="module")
def textured():
    """``tests/test_sift.py``'s texture, its rotated and zoomed copies and
    each package's SIFT frames of them."""
    from scipy.ndimage import gaussian_filter, rotate, zoom

    rng = np.random.default_rng(0)
    img = gaussian_filter(np.kron(rng.normal(size=(SIFT_H // 8,
                                                   SIFT_W // 8)),
                                  np.ones((8, 8))), 2.0)
    img = (img - img.min()) / (np.ptp(img) + 1e-9)
    depth = np.full((SIFT_H, SIFT_W), 2.0, np.float32)
    big = zoom(img, 1.5, order=1)
    y0 = (big.shape[0] - SIFT_H) // 2
    x0 = (big.shape[1] - SIFT_W) // 2
    imgs = {"plain": img, "rot": rotate(img, 30, reshape=False, order=1),
            "zoom": big[y0:y0 + SIFT_H, x0:x0 + SIFT_W]}
    jf = {k: jsift.sift_features(J_SIFT_K, jnp.asarray(v),
                                 jnp.asarray(depth), max_features=128)
          for k, v in imgs.items()}
    tf = {k: sift_features(SIFT_K, v, depth, max_features=128, device=CPU)
          for k, v in imgs.items()}
    return imgs, depth, (x0, y0), jf, tf


def test_dog_keypoints_match_jax(textured):
    imgs = textured[0]
    for img in (imgs["plain"], render_wall_frame(
            SR4000, np.array([0.0, 0.0, 0.0]))[0]):
        a = jsift.dog_keypoints(jnp.asarray(img), max_features=128)
        b = dog_keypoints(torch.as_tensor(img), max_features=128)
        for f in ("uv", "sigma", "octave", "scale_idx", "valid"):
            np.testing.assert_array_equal(_np(getattr(b, f)),
                                          np.asarray(getattr(a, f)))
        v = np.asarray(a.valid)
        np.testing.assert_allclose(_np(b.score)[v], np.asarray(a.score)[v],
                                   rtol=1e-5)


@pytest.mark.parametrize("name", ["plain", "rot", "zoom"])
def test_sift_features_match_jax(textured, name):
    _, _, _, jf, tf = textured
    a, b = jf[name], tf[name]
    np.testing.assert_array_equal(_np(b.valid), np.asarray(a.valid))
    np.testing.assert_array_equal(_np(b.uv), np.asarray(a.uv))
    np.testing.assert_allclose(_np(b.desc), np.asarray(a.desc), atol=1e-5)
    np.testing.assert_allclose(_np(b.pts3), np.asarray(a.pts3), atol=1e-5)


def test_sift_on_a_wall_frame_matches_jax(walls):
    (img, depth), *_ = walls[0]
    a = jsift.sift_features(J_SR4000, jnp.asarray(img), jnp.asarray(depth),
                            max_features=128)
    b = sift_features(SR4000, img, depth, max_features=128, device=CPU)
    np.testing.assert_array_equal(_np(b.valid), np.asarray(a.valid))
    np.testing.assert_array_equal(_np(b.uv), np.asarray(a.uv))
    np.testing.assert_allclose(_np(b.desc), np.asarray(a.desc), atol=1e-5)


def _sift_match(f0, f1, ratio=0.92, min_sim=0.75):
    """``test_sift.py``'s ratio-test matcher."""
    v0, v1 = _np(f0.valid), _np(f1.valid)
    D = _np(f0.desc) @ _np(f1.desc).T
    D[~v0] = -1
    D[:, ~v1] = -1
    j = D.argmax(1)
    sim = D.max(1)
    D2 = D.copy()
    D2[np.arange(len(j)), j] = -1
    keep = v0 & (sim > min_sim) & (D2.max(1) < ratio * sim)
    return np.where(keep)[0], j[keep]


def _rot_predict(uv, deg):
    th = np.deg2rad(-deg)
    c, s = np.cos(th), np.sin(th)
    ctr = np.array([SIFT_W / 2 - 0.5, SIFT_H / 2 - 0.5])
    d = uv - ctr
    return np.stack([c * d[:, 0] - s * d[:, 1],
                     s * d[:, 0] + c * d[:, 1]], 1) + ctr


def test_sift_static_shapes_and_masking(textured):
    """``test_sift.py::test_static_shapes_and_masking`` on the port."""
    imgs, depth, _, _, _ = textured
    f = sift_features(SIFT_K, imgs["plain"], depth, max_features=96,
                      device=CPU)
    assert f.uv.shape == (96, 2) and f.desc.shape == (96, 128)
    assert f.pts3.shape == (96, 3)
    v = _np(f.valid)
    assert v.sum() > 30
    np.testing.assert_allclose(np.linalg.norm(_np(f.desc), axis=1)[v], 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(_np(f.pts3)[v, 2], 2.0, atol=1e-5)


def test_sift_multiscale_detection(textured):
    kp = dog_keypoints(torch.as_tensor(textured[0]["plain"]),
                       max_features=128)
    v = _np(kp.valid)
    assert len(np.unique(_np(kp.octave)[v])) >= 2
    assert _np(kp.sigma)[v].min() > 1.0


def test_sift_rotation_invariance(textured):
    _, _, _, _, tf = textured
    qi, ti = _sift_match(tf["plain"], tf["rot"])
    assert len(qi) >= 40
    pred = _rot_predict(_np(tf["plain"].uv)[qi], 30)
    err = np.linalg.norm(pred - _np(tf["rot"].uv)[ti], axis=1)
    assert np.median(err) < 2.0
    assert (err < 3.0).mean() > 0.85


def test_sift_beats_harris_under_rotation(textured):
    imgs, depth, _, _, tf = textured
    h0 = extract_features(SIFT_K, imgs["plain"], depth, max_features=128,
                          device=CPU)
    h1 = extract_features(SIFT_K, imgs["rot"], depth, max_features=128,
                          device=CPU)

    def inliers(f0, f1):
        qi, ti = _sift_match(f0, f1)
        if len(qi) == 0:
            return 0
        pred = _rot_predict(_np(f0.uv)[qi], 30)
        return int((np.linalg.norm(pred - _np(f1.uv)[ti], axis=1)
                    < 3.0).sum())

    assert inliers(tf["plain"], tf["rot"]) > 4 * max(inliers(h0, h1), 1)


def test_sift_scale_invariance(textured):
    _, _, (x0, y0), _, tf = textured
    qi, ti = _sift_match(tf["plain"], tf["zoom"])
    assert len(qi) >= 20
    pred = _np(tf["plain"].uv)[qi] * 1.5 - np.array([x0, y0])
    err = np.linalg.norm(pred - _np(tf["zoom"].uv)[ti], axis=1)
    assert (err < 3.0).mean() > 0.5


def test_extractor_dispatch():
    assert get_extractor("sift") is sift_features
    assert get_extractor("harris") is extract_features
    with pytest.raises(ValueError):
        get_extractor("orb")


# ----------------------------------------------------------------- place
def test_codebook_bit_equal():
    for dim, n, seed in ((256, 16, 0), (128, 16, 0), (256, 8, 3)):
        a = np.asarray(jplace._codebook(dim, n, seed))
        b = tplace._codebook(dim, n, seed)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(b, a)


@pytest.fixture(scope="module")
def place_frames():
    """``test_place.py``'s frames (128 features), both packages."""
    specs = {"x0": (0.0, 0), "x002": (0.02, 0), "new": (0.0, 5),
             "x04": (0.4, 0), "x08": (0.8, 0), "x12": (1.2, 0)}
    out = {}
    for name, (x, seed) in specs.items():
        img, d = render_wall_frame(SR4000, np.array([x, 0.0, 0.0]),
                                   seed=seed)
        out[name] = (jfeat.extract_features(J_SR4000, jnp.asarray(img),
                                            jnp.asarray(d),
                                            max_features=128),
                     extract_features(SR4000, img, d, max_features=128,
                                      device=CPU))
    return out


def test_global_descriptor_matches_jax(place_frames):
    for j, _ in place_frames.values():
        a = np.asarray(jplace.global_descriptor(j))
        b = _np(global_descriptor(_port(j)))
        np.testing.assert_allclose(b, a, atol=1e-6)


def test_same_place_beats_different_place(place_frames):
    """``test_place.py::test_same_place_beats_different_place``."""
    g_a, g_a2, g_b = (_np(global_descriptor(place_frames[k][1]))
                      for k in ("x0", "x002", "new"))
    assert np.linalg.norm(g_a) == pytest.approx(1.0, abs=1e-5)
    assert g_a @ g_a2 > g_a @ g_b + 0.05


def test_index_query_matches_jax(place_frames):
    """``test_place.py::test_index_query_ranks_revisit_first``, with every
    query's ids held to the reference's on the same features."""
    jidx, tidx = jplace.PlaceIndex(capacity=2), PlaceIndex(capacity=2)
    for k in ("x0", "x04", "x08", "x12"):
        jidx.add(place_frames[k][0])
        tidx.add(_port(place_frames[k][0]))
    assert len(tidx) == 4 and tidx._bank.shape[0] == 4   # doubled twice
    q_j, q_t = place_frames["x002"][0], _port(place_frames["x002"][0])
    for kw in ({"top_k": 2}, {"top_k": 4, "max_id": 2},
               {"top_k": 2, "max_id": 0}, {"top_k": 9}):
        ids_j, sims_j = jidx.query(q_j, **kw)
        ids_t, sims_t = tidx.query(q_t, **kw)
        np.testing.assert_array_equal(ids_t, np.asarray(ids_j))
        np.testing.assert_allclose(sims_t, np.asarray(sims_j), atol=1e-6)
    ids, sims = tidx.query(q_t, top_k=2)
    assert ids[0] == 0 and sims[0] > sims[-1] - 1e-9
    assert set(tidx.query(q_t, top_k=4, max_id=2)[0].tolist()) <= {0, 1}
    assert len(tidx.query(q_t, top_k=2, max_id=0)[0]) == 0


def test_feature_frame_from_numpy(walls):
    _, jf, _ = walls
    f = _port(jf[0])
    assert isinstance(f, FeatureFrame)
    assert f.uv.dtype == torch.float32 and f.valid.dtype == torch.bool
    np.testing.assert_array_equal(_np(f.desc), np.asarray(jf[0].desc))
