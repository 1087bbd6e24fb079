"""The port's plane propagation against the JAX package, on rendered SR4000
frames of the two-plane room (wall z = 4, floor y = 0.8) seen from two
nearby camera poses.

Tolerances, each with its reason:
- float64: masks, counts and ``ok`` bit-equal; planes atol 1e-9 and
  covariances rtol 1e-9 — the same arithmetic, summed in another order
  (the LS refit sums ~10^4 points and takes an eigenvector);
- float32: the membership test ``dis*dis <= gate`` can flip a pixel that
  sits at the threshold when the two frameworks round differently, so at
  most 0.2% of a plane's pixels may differ, and planes agree to 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_slam_tpu.config import SR4000 as J_SR4000
from graph_slam_tpu.core import se3 as jse3
from graph_slam_tpu.datasets.synthetic import _render_plane_frame as j_render
from graph_slam_tpu.planes import propagation as jprop
from graph_slam_tpu_torch.config import SR4000
from graph_slam_tpu_torch.convert import propagation_inputs, to_numpy
from graph_slam_tpu_torch.datasets.synthetic import _render_plane_frame
from graph_slam_tpu_torch.planes import propagate_plane, propagate_planes

torch.set_num_threads(1)

SCENE = [(np.array([0.0, 0.0, 1.0, -4.0]), 150.0),
         (np.array([0.0, 1.0, 0.0, -0.8]), 80.0)]


def _rot(w):
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th**2 * W @ W


def _frames():
    """Two rendered frames and the numpy propagation inputs between them."""
    R_i, t_i = _rot(np.array([0.02, -0.03, 0.01])), np.array([0.1, -0.05, 0.3])
    R_j = R_i @ _rot(np.array([-0.01, 0.02, 0.015]))
    t_j = t_i + R_i @ np.array([0.03, 0.01, 0.05])
    inten_i, depth_i = _render_plane_frame(SR4000, R_i, t_i, SCENE,
                                           noise=0.002, seed=1)
    inten_j, depth_j = _render_plane_frame(SR4000, R_j, t_j, SCENE,
                                           noise=0.002, seed=2)
    planes_i, masks = [], []
    for plane_w, value in SCENE:
        n, d = plane_w[:3], plane_w[3]
        planes_i.append(np.concatenate([R_i.T @ n, [d + n @ t_i]]))
        masks.append((inten_i == value) & (depth_i > 0))
    T_R, T_t = R_i.T @ R_j, R_i.T @ (t_j - t_i)
    return dict(planes_i=np.stack(planes_i),
                S_ni=np.stack([np.eye(3) * 1e-5] * 2),
                S_di=np.array([2e-4, 3e-4]),
                prev_masks=np.stack(masks),
                prev_counts=np.stack(masks).sum(axis=(1, 2)),
                T_R=T_R, T_t=T_t, S_tij=np.eye(3) * 1e-4,
                intensity=inten_j, depth=depth_j)


@pytest.fixture(scope="module")
def frames():
    return _frames()


def _jax_args(f, dtype):
    return (jnp.asarray(f["planes_i"], dtype), jnp.asarray(f["S_ni"], dtype),
            jnp.asarray(f["S_di"], dtype), jnp.asarray(f["prev_masks"]),
            jnp.asarray(f["prev_counts"]),
            jse3.Pose(jnp.asarray(f["T_R"], dtype),
                      jnp.asarray(f["T_t"], dtype)),
            jnp.asarray(f["S_tij"], dtype), jnp.asarray(f["intensity"]),
            jnp.asarray(f["depth"], dtype))


def _port_args(f, dtype):
    return propagation_inputs(**f, dtype=dtype, device="cpu")


def test_render_matches_reference():
    R, t = _rot(np.array([0.05, 0.1, -0.02])), np.array([0.2, 0.1, -0.3])
    for a, b in zip(_render_plane_frame(SR4000, R, t, SCENE, 0.002, 5),
                    j_render(J_SR4000, R, t, SCENE, 0.002, 5)):
        np.testing.assert_array_equal(a, b)


def _check(res_t, res_j, exact):
    out = to_numpy(res_t)
    if exact:
        np.testing.assert_array_equal(out.mask, np.asarray(res_j.mask))
        np.testing.assert_array_equal(out.count, np.asarray(res_j.count))
        np.testing.assert_array_equal(out.ok, np.asarray(res_j.ok))
        np.testing.assert_allclose(out.plane, np.asarray(res_j.plane),
                                   atol=1e-9)
        np.testing.assert_allclose(out.cov, np.asarray(res_j.cov), rtol=1e-9)
    else:
        diff = np.sum(out.mask != np.asarray(res_j.mask), axis=(-2, -1))
        assert np.all(diff <= 0.002 * np.asarray(res_j.count)), diff
        np.testing.assert_array_equal(out.ok, np.asarray(res_j.ok))
        np.testing.assert_allclose(out.plane, np.asarray(res_j.plane),
                                   atol=1e-4)
    assert np.all(out.ok) and np.all(out.count > 0)


def test_propagate_planes_f64_matches(frames):
    res_j = jprop.propagate_planes(J_SR4000, *_jax_args(frames, jnp.float64))
    res_t = propagate_planes(SR4000, *_port_args(frames, torch.float64))
    _check(res_t, res_j, exact=True)


@pytest.mark.parametrize("k", [0, 1])
def test_propagate_plane_f64_matches(frames, k):
    a = _jax_args(frames, jnp.float64)
    res_j = jprop.propagate_plane(J_SR4000, a[0][k], a[1][k], a[2][k],
                                  a[3][k], a[4][k], *a[5:])
    p = _port_args(frames, torch.float64)
    res_t = propagate_plane(SR4000, p.planes_i[k], p.S_ni[k], p.S_di[k],
                            p.prev_masks[k], p.prev_counts[k], *p[5:])
    _check(res_t, res_j, exact=True)


def test_propagate_planes_f32_within_pixel_tolerance(frames):
    res_j = jprop.propagate_planes(J_SR4000, *_jax_args(frames, jnp.float32))
    res_t = propagate_planes(SR4000, *_port_args(frames, torch.float32))
    assert res_t.plane.dtype == torch.float32
    _check(res_t, res_j, exact=False)
