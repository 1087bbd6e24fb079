"""Parity of the port's Lie cores and small numeric helpers with the JAX
package (so3, se3, oriented_plane, point_plane_dist, noise models), on the
CPU in float64.

Tolerance: atol 1e-12 everywhere. Both sides evaluate the same closed forms
in float64; they differ only in rounding (the reference's polynomial trig
against libm's sin/cos, and the order of 3-term sums), which stays within a
few ulp of values of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_slam_tpu.core import se3 as jse3
from graph_slam_tpu.core import so3 as jso3
from graph_slam_tpu.noise import models as jnoise
from graph_slam_tpu.planes import extraction as jext
from graph_slam_tpu.planes import oriented_plane as jop
from graph_slam_tpu_torch.core import se3, so3
from graph_slam_tpu_torch.noise import models as noise
from graph_slam_tpu_torch.planes import extraction as ext
from graph_slam_tpu_torch.planes import oriented_plane as op

torch.set_num_threads(1)

ATOL = 1e-12


def _rotvecs(seed=0):
    """Generic angles, Taylor-branch angles, and angles near pi."""
    r = np.random.default_rng(seed)
    axes = r.normal(size=(12, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([r.uniform(0.01, 3.0, 6), [1e-7, 3e-6, 0.0],
                             np.pi - np.array([1e-5, 2e-4, 1e-9])])
    return axes * angles[:, None]


def _xis(seed=1):
    r = np.random.default_rng(seed)
    return np.concatenate([_rotvecs(seed), r.normal(size=(12, 3))], axis=1)


def _planes(seed=2):
    r = np.random.default_rng(seed)
    n = r.normal(size=(8, 3))
    n[0] = [0.0, 0.0, 1.0]      # |n_z| largest: basis crosses with x
    n[1] = [1.0, 0.0, 0.0]
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return np.concatenate([n, r.normal(size=(8, 1))], axis=1)


def _np(fn, *args):
    """Test inputs made by one of the port's functions, as numpy."""
    return fn(*[torch.as_tensor(a) for a in args]).numpy()


def _both(fn_j, fn_t, *args, jit=True):
    out_j = (jax.jit(fn_j) if jit else fn_j)(*[jnp.asarray(a) for a in args])
    out_t = fn_t(*[torch.as_tensor(np.array(a)) for a in args])
    return out_j, out_t


def _close(out_j, out_t):
    if isinstance(out_t, tuple):
        for a, b in zip(out_j, out_t):
            _close(a, b)
        return
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=ATOL)


SO3_CASES = {
    "hat": (jso3.hat, so3.hat, lambda: (_rotvecs(),)),
    "vee": (jso3.vee, so3.vee, lambda: (_np(so3.hat, _rotvecs()),)),
    "expmap": (jso3.expmap, so3.expmap, lambda: (_rotvecs(),)),
    "logmap": (jso3.logmap, so3.logmap, lambda: (_np(so3.expmap, _rotvecs()),)),
    "left_jacobian": (jso3.left_jacobian, so3.left_jacobian,
                      lambda: (_rotvecs(),)),
    "left_jacobian_inverse": (jso3.left_jacobian_inverse,
                              so3.left_jacobian_inverse,
                              lambda: (_rotvecs()[:9],)),
    "quat_to_matrix": (jso3.quat_to_matrix, so3.quat_to_matrix,
                       lambda: (np.random.default_rng(3).normal(size=(10, 4)),)),
    "matrix_to_quat": (jso3.matrix_to_quat, so3.matrix_to_quat,
                       lambda: (_np(so3.expmap, _rotvecs()),)),
}


@pytest.mark.parametrize("name", sorted(SO3_CASES))
def test_so3_matches_jax(name):
    fn_j, fn_t, make = SO3_CASES[name]
    _close(*_both(fn_j, fn_t, *make()))


def _pose_pair():
    a, b = se3.expmap(torch.as_tensor(_xis(4))), se3.expmap(
        torch.as_tensor(_xis(5)))
    return [x.numpy() for x in (a.R, a.t, b.R, b.t)]


def _pose_fn(module, name, n_poses):
    fn = getattr(module, name)

    def call(*arrs):
        poses = [module.Pose(arrs[2 * k], arrs[2 * k + 1])
                 for k in range(n_poses)]
        return fn(*poses, *arrs[2 * n_poses:])

    return call


SE3_CASES = {
    "compose": 2, "between": 2, "local": 2, "inverse": 1, "logmap": 1,
    "adjoint": 1, "transform_from": 1, "transform_to": 1,
}


@pytest.mark.parametrize("name", sorted(SE3_CASES))
def test_se3_pose_ops_match_jax(name):
    n = SE3_CASES[name]
    args = _pose_pair()[:2 * n]
    if name.startswith("transform"):
        args.append(np.random.default_rng(6).normal(size=(12, 3)))
    _close(*_both(_pose_fn(jse3, name, n), _pose_fn(se3, name, n), *args))


@pytest.mark.parametrize("name", ["expmap", "right_jacobian_inverse",
                                  "left_jacobian_inverse"])
def test_se3_tangent_ops_match_jax(name):
    xi = _xis(7)[:9]    # the near-pi rows are outside Jr^-1's domain
    if name == "expmap":
        xi = _xis(7)
    else:
        # the reference's Q-matrix coefficients cancel for 1e-6 < theta <
        # ~1e-2 (its own fault); those rows are held to the series in
        # test_q_left_coefficients_follow_their_series
        theta = np.linalg.norm(xi[:, :3], axis=1)
        xi = xi[(theta <= 1e-6) | (theta >= 1e-2)]
    # Eager, not jitted: XLA's fused jit evaluates the reference's
    # coefficients in another order.
    _close(*_both(getattr(jse3, name), getattr(se3, name), xi,
                  jit=name == "expmap"))


def _q_series(theta):
    """c1, c2, c3 of Q by 25 terms of their Taylor series, each
    coefficient an exact fraction."""
    from fractions import Fraction
    from math import factorial

    t2 = np.asarray(theta) ** 2
    out = []
    for c in (1, 2, 3):
        coefs = [float(Fraction((-1) ** k * (k + 1 if c == 3 else 1),
                                factorial(2 * k + 2 + c)))
                 for k in range(25)]
        out.append(sum(a * t2 ** k for k, a in enumerate(coefs)))
    return out


def test_q_left_coefficients_follow_their_series():
    """The port evaluates Q's coefficients by their Taylor series up to
    theta = 0.5 and the closed forms beyond.

    The reference keeps the closed forms down to theta^2 = 1e-12, whose
    numerators are differences of O(1) terms divided by theta^4 and
    theta^5: c3 reads 8470 instead of 1/120 at theta = 1e-5, and its Jr^-1
    is off by up to 8.4e-10 (theta = 1e-4, |v| ~ 1; measured). That is
    the reference's own fault, so Jr^-1 is held to it at 1e-9 only, and
    the coefficients to the series at 1e-12.
    """
    theta = np.concatenate([np.geomspace(1e-8, 1e-1, 29),
                            [0.2, 0.499, 0.5, 0.501], np.linspace(0.6, 3.0, 9)])
    got = se3._q_coeffs(torch.as_tensor(theta ** 2))
    for c, ref in zip(got, _q_series(theta)):
        np.testing.assert_allclose(c.numpy(), ref, rtol=1e-12, atol=0)
    r = np.random.default_rng(12)
    axes = r.normal(size=(29, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    xi = np.concatenate([axes * theta[:29, None], r.normal(size=(29, 3))],
                        axis=1)
    out_j, out_t = _both(jse3.right_jacobian_inverse,
                         se3.right_jacobian_inverse, xi, jit=False)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-9)


def _plane_xi():
    r = np.random.default_rng(8)
    xi = r.normal(size=(8, 3)) * 0.3
    xi[0, :2] = 1e-9             # Taylor branch of the sphere retract
    return xi


PLANE_CASES = {
    "normalize": (lambda: (_planes() * 3.0,)),
    "basis": (lambda: (_planes()[:, :3],)),
    "retract": (lambda: (_planes(), _plane_xi())),
    "local": (lambda: (_planes(), _np(op.retract, _planes(), _plane_xi()))),
    "transform": (lambda: (_planes(), _pose_pair()[0][:8],
                           _pose_pair()[1][:8])),
}


@pytest.mark.parametrize("name", sorted(PLANE_CASES))
def test_oriented_plane_matches_jax(name):
    args = PLANE_CASES[name]()
    _close(*_both(getattr(jop, name), getattr(op, name), *args))


def test_point_plane_dist_matches_jax():
    pts = np.random.default_rng(9).normal(size=(20, 3))
    _close(*_both(jext.point_plane_dist, ext.point_plane_dist, _planes(), pts))


def _spd(seed, scale=1.0):
    A = np.random.default_rng(seed).normal(size=(4, 6, 6))
    return scale * (A @ A.transpose(0, 2, 1) + 6.0 * np.eye(6))


def _huber_args():
    d = np.array([0.0, 1e-300, 0.5, -0.5, 1.345, -1.345, 1.35, 7.0, -40.0])
    return d, np.array(1.345)


NOISE_CASES = {
    "sqrt_info_from_sigmas": (
        lambda: (np.random.default_rng(10).uniform(0.01, 2.0, (5, 6)),)),
    "sqrt_info_from_information": (lambda: (_spd(11, 10.0),)),
    "sqrt_info_from_covariance": (lambda: (_spd(12, 0.1),)),
    "huber_weight": _huber_args,
}


@pytest.mark.parametrize("name", sorted(NOISE_CASES) + ["isotropic_sqrt_info"])
def test_noise_models_match_jax(name):
    if name == "isotropic_sqrt_info":
        _close(*_both(lambda s: jnoise.isotropic_sqrt_info(6, s),
                      lambda s: noise.isotropic_sqrt_info(6, s, device="cpu"),
                      np.array(0.3)))
        return
    _close(*_both(getattr(jnoise, name), getattr(noise, name),
                  *NOISE_CASES[name]()))


@pytest.mark.parametrize("precision", [None, "high"])
def test_import_changes_no_process_wide_setting(precision):
    """Importing the port (its vision and online SLAM too), in a fresh
    process, leaves torch's default dtype float32, its float32 matmul
    precision what the caller set (TF32 off, torch's default, when the
    caller set nothing) and cuDNN's TF32 switch at torch's default (the
    extractors turn it off only around their own convolutions)."""
    import os
    import subprocess
    import sys

    code = "import torch\n"
    if precision:
        code += f"torch.set_float32_matmul_precision({precision!r})\n"
    code += ("import graph_slam_tpu_torch, graph_slam_tpu_torch.pipelines\n"
             "import graph_slam_tpu_torch.vision\n"
             "import graph_slam_tpu_torch.pipelines.online_slam\n"
             "print(torch.get_default_dtype(),"
             " torch.get_float32_matmul_precision(),"
             " torch.backends.cudnn.allow_tf32)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split()
    assert out == ["torch.float32", precision or "highest", "True"]
