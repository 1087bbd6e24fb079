"""The port against the independent NumPy LM (``tests/np_optimizer.py``),
as ``tests/test_np_parity.py`` holds the JAX package to it.

The oracle shares no code with either package (numeric Jacobians, dense
normal equations, its own LM schedule), so it catches a convention fault
that the port shares with the reference. The bars are the reference's:
the initial chi2 at 1e-9 and the optimum at 1e-6 relative; on the VRO
fixture the trajectory, gauge-fixed by the same node-0 prior in both,
within 1e-6 m RMSE without alignment. The bundle-adjustment case is
``tests/test_torch_ba.py::test_ba_graph_same_optimum_as_the_numpy_oracle``.
Each oracle run is shared through a module-scoped fixture.
"""

import os

import numpy as np
import pytest
import torch

import np_optimizer as npo
from graph_slam_tpu_torch.config import SlamParams
from graph_slam_tpu_torch.graph import (GraphBuilder, LMParams, lm_optimize,
                                        total_error)
from graph_slam_tpu_torch.imu import (init_preint, integrate_segment,
                                      vn100_params)
from graph_slam_tpu_torch.io import read_vro_log
from graph_slam_tpu_torch.pipelines import run_pose_graph, trajectory_arrays
from graph_slam_tpu_torch.utils.metrics import ate_rmse

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")

torch.set_num_threads(1)


def _rel(a, b, floor):
    return abs(float(a) - float(b)) / max(float(b), floor)


@pytest.fixture(scope="module")
def vro_oracle():
    """The NumPy LM on the committed VRO fixture: (log, e0, optimum)."""
    log = read_vro_log(os.path.join(HERE, "posegraph_vro.log"))
    nf, nv = npo.graph_from_vro(log)
    return log, npo.total_error(nf, nv), npo.lm_optimize(nf, nv,
                                                         max_iters=80)


def test_vro_fixture_same_optimum_and_trajectory(vro_oracle):
    """``TestNumpyParityPoseGraph`` on the port: ``run_pose_graph`` and
    the NumPy LM reach the same chi2 and the same trajectory."""
    log, np_e0, (nv_opt, np_err) = vro_oracle
    res = run_pose_graph(log, SlamParams(), bucket=64, device="cpu")
    assert abs(res.error0 - np_e0) <= 1e-9 * np_e0
    assert abs(res.error - np_err) <= 1e-6 * np_err, (res.error, np_err)
    _, est_t, _, _ = trajectory_arrays(res.values, res.seq_ids)
    np_t = np.stack([t for _, t in nv_opt.poses])
    assert est_t.shape == np_t.shape
    ate = ate_rmse(est_t, np_t, align=False)
    assert ate < 1e-6, f"trajectory parity broke: ATE {ate}"


@pytest.fixture(scope="module")
def imu_plane_case():
    """``TestNumpyParityImuPlane``'s graph: pose, velocity and bias
    priors, IMU factors over real preintegrated windows (the port's
    ``integrate_segment``, consumed as data by both graphs) and plane
    factors; with the NumPy LM's e0 and optimum."""
    r = np.random.default_rng(5)
    params = vn100_params(device="cpu")
    gravity = params.gravity.numpy()
    dt = 1.0 / 200.0
    n_frames, per = 4, 15
    acc = r.normal(size=(n_frames * per, 3)) * 0.3 - gravity
    gyr = r.normal(size=(n_frames * per, 3)) * 0.3
    preints = [integrate_segment(
        init_preint(torch.zeros(6, dtype=torch.float64), params,
                    device="cpu"),
        torch.as_tensor(acc[(f - 1) * per:f * per]),
        torch.as_tensor(gyr[(f - 1) * per:f * per]),
        torch.full((per,), dt, dtype=torch.float64), params)
        for f in range(1, n_frames)]
    planes_body = [np.array([0.0, 0.0, 1.0, -2.0]),
                   np.array([0.0, 1.0, 0.0, -1.5])]
    plane_S = np.diag([1e2, 1e2, 1e2])

    factors = [npo.prior_pose_factor(0, (np.eye(3), np.zeros(3)),
                                     np.eye(6) * 1e7),
               npo.prior_vec_factor("vel", 0, np.zeros(3), np.eye(3) * 1e3),
               npo.prior_vec_factor("bias", 0, np.zeros(6), np.eye(6) * 1e3)]
    for f, st in enumerate(preints, start=1):
        st = st._replace(**{k: v.numpy() for k, v in st._asdict().items()})
        C = 0.5 * (st.cov + st.cov.T)
        S = np.linalg.inv(np.linalg.cholesky(C))
        factors.append(npo.imu_factor(
            f - 1, f, st.dR, st.dp, st.dv, st.H_R_bg, st.H_p_ba, st.H_p_bg,
            st.H_v_ba, st.H_v_bg, st.bias_hat, float(st.dt), gravity, S))
    np_planes = [p / np.linalg.norm(p[:3]) for p in planes_body]
    factors += [npo.plane_factor(f, l, lp, plane_S)
                for f in range(n_frames) for l, lp in enumerate(np_planes)]
    nv = npo.NpValues([(np.eye(3), np.zeros(3) + 0.01 * f)
                       for f in range(n_frames)], [np.zeros(3)] * n_frames,
                      [np.zeros(6)] * n_frames, np_planes)
    e0_np = npo.total_error(factors, nv)
    _, err_np = npo.lm_optimize(factors, nv, max_iters=120)
    return (n_frames, preints, gravity, planes_body, plane_S), e0_np, err_np


def test_imu_plane_graph_same_optimum(imu_plane_case):
    """``TestNumpyParityImuPlane`` on the port: the same measurements
    through ``GraphBuilder`` and ``lm_optimize`` reach the NumPy LM's e0
    and optimum."""
    (n_frames, preints, gravity, planes_body, plane_S), e0_np, err_np = \
        imu_plane_case
    b = GraphBuilder()
    for f in range(n_frames):
        b.add_pose((np.eye(3), np.zeros(3) + 0.01 * f))
        b.add_vel(np.zeros(3))
        b.add_bias(np.zeros(6))
    b.add_prior_pose(0, (np.eye(3), np.zeros(3)), sigmas=np.full(6, 1e-7))
    b.add_prior_vel(0, np.zeros(3), sigma=1e-3)
    b.add_prior_bias(0, np.zeros(6), sigma=1e-3)
    for f, st in enumerate(preints, start=1):
        b.add_imu_factor(f - 1, f, st, gravity)
    for lp in planes_body:
        b.add_plane(lp)
    for f in range(n_frames):
        for l, lp in enumerate(planes_body):
            b.add_plane_factor(f, l, lp, sqrt_info=plane_S)
    graph, values = b.build(bucket=8, device="cpu")
    res = lm_optimize(graph, values, LMParams(relative_error_tol=1e-14,
                                              absolute_error_tol=1e-14))
    e0 = total_error(graph, values)
    assert _rel(e0, e0_np, 1e-12) <= 1e-9, (float(e0), e0_np)
    assert _rel(res.error, err_np, 1e-9) <= 1e-6, (float(res.error), err_np)
