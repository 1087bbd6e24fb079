"""Parity of the port's IMU slice with the JAX package, on the CPU in
float64: preintegration (the sequential oracle and the log-depth form),
NavState prediction, presets, streams, extrinsics, the builder's VIO rows
and the IMU / velocity-prior / bias-prior factor rows.

Tolerances, each with its reason:
- preintegration fields: atol 1e-10, ``cov`` rtol 1e-9 — the same
  recurrences evaluated in a different order (sequential, Hillis-Steele
  product scan, pairwise tree) against the reference's associative scan;
- numpy-only pieces (presets, streams, tables): exact or 1e-15;
- factor rows: r and J within 1e-10 of the reference's, relative to the
  largest entry of the row block (the IMU sqrt-information is ~1e3-1e5,
  so absolute entries carry that scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_slam_tpu.core import extrinsics as jext
from graph_slam_tpu.core import se3 as jse3
from graph_slam_tpu.core import so3 as jso3
from graph_slam_tpu.graph import builder as jbuilder
from graph_slam_tpu.graph import factors as jfactors
from graph_slam_tpu import imu as jimu
from graph_slam_tpu.imu import streams as jstreams
from graph_slam_tpu_torch import convert
from graph_slam_tpu_torch.core import extrinsics, se3, so3
from graph_slam_tpu_torch.graph import (GraphBuilder, linearize_blocks,
                                        total_error)
from graph_slam_tpu_torch import imu

torch.set_num_threads(1)

FIELDS = ("dR", "dp", "dv", "H_R_bg", "H_p_ba", "H_p_bg", "H_v_ba",
          "H_v_bg", "dt", "bias_hat")


def _np(x):
    return convert.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _window(n, seed, pad):
    """IMU window of ``n`` rows, the last ``pad`` of them dt = 0."""
    r = np.random.default_rng(seed)
    acc = r.normal(size=(n, 3)) + np.array([0.0, 0.0, 9.81])
    gyr = r.normal(size=(n, 3)) * 0.5
    dt = np.full(n, 0.005)
    dt[n - pad:] = 0.0
    return acc, gyr, dt, r.normal(size=6) * 0.02


def _params():
    jp = jimu.vn100_params()
    return jp, convert.imu_params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu")


def _assert_state(port, ref):
    for f in FIELDS:
        np.testing.assert_allclose(_np(getattr(port, f)),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=1e-10, err_msg=f)
    np.testing.assert_allclose(_np(port.cov), np.asarray(ref.cov),
                               rtol=1e-9, atol=1e-300)


@pytest.mark.parametrize("n,pad", [(1, 0), (7, 2), (32, 9), (64, 20)])
@pytest.mark.parametrize("form", ["scan", "log_depth"])
def test_integrate_segment_matches_reference(n, pad, form):
    acc, gyr, dt, b = _window(n, seed=n, pad=pad)
    jp, tp = _params()
    ref = jimu.integrate_segment_parallel(jimu.init_preint(jnp.asarray(b),
                                                           jp),
                                          acc, gyr, dt, jp)
    fn = imu.integrate_segment_scan if form == "scan" \
        else imu.integrate_segment
    port = fn(imu.init_preint(b, tp, device="cpu"), acc, gyr, dt, tp)
    _assert_state(port, ref)


def test_padded_rows_are_exact_identities():
    acc, gyr, dt, b = _window(32, seed=3, pad=0)
    _, tp = _params()
    s0 = imu.init_preint(b, tp, device="cpu")
    short = imu.integrate_segment(s0, acc[:20], gyr[:20], dt[:20], tp)
    dt_pad = dt.copy()
    dt_pad[20:] = 0.0
    padded = imu.integrate_segment(s0, acc, gyr, dt_pad, tp)
    seq = imu.integrate_segment_scan(s0, acc, gyr, dt_pad, tp)
    for f in FIELDS + ("cov",):
        a, c = getattr(short, f), getattr(seq, f)
        np.testing.assert_allclose(_np(getattr(padded, f)), _np(a),
                                   rtol=1e-12, atol=1e-15, err_msg=f)
        np.testing.assert_allclose(_np(c), _np(a), rtol=1e-12, atol=1e-15,
                                   err_msg=f)


def test_batched_windows_match_one_at_a_time():
    _, tp = _params()
    wins = [_window(16, seed=s, pad=s) for s in range(3)]
    acc, gyr, dt, b = (np.stack(x) for x in zip(*wins))
    batch = imu.integrate_segment(imu.init_preint(b, tp, device="cpu"),
                                  acc, gyr, dt, tp)
    for k, (a, g, d, bk) in enumerate(wins):
        one = imu.integrate_segment(imu.init_preint(bk, tp, device="cpu"),
                                    a, g, d, tp)
        for f in FIELDS + ("cov",):
            np.testing.assert_allclose(_np(getattr(batch, f)[k]),
                                       _np(getattr(one, f)), rtol=1e-13,
                                       atol=1e-15, err_msg=f)


def test_predict_navstate_and_corrected_deltas():
    acc, gyr, dt, b = _window(40, seed=5, pad=4)
    jp, tp = _params()
    jst = jimu.integrate_segment_parallel(jimu.init_preint(jnp.asarray(b),
                                                           jp),
                                          acc, gyr, dt, jp)
    st = convert.preint_from_numpy(jax.tree.map(np.asarray, jst),
                                   device="cpu")
    r = np.random.default_rng(6)
    bias_i = b + r.normal(size=6) * 0.01
    R0 = np.asarray(jso3.expmap(jnp.asarray(r.normal(size=3))))
    t0, v0 = r.normal(size=3), r.normal(size=3)
    ref = jimu.corrected_deltas(jst, jnp.asarray(bias_i))
    port = imu.corrected_deltas(st, torch.as_tensor(bias_i))
    for a, c in zip(port, ref):
        np.testing.assert_allclose(_np(a), np.asarray(c), atol=1e-12)
    jX, jv = jimu.predict_navstate(jst, jse3.Pose(jnp.asarray(R0),
                                                  jnp.asarray(t0)),
                                   jnp.asarray(v0), jnp.asarray(bias_i),
                                   jp.gravity)
    X, v = imu.predict_navstate(st, se3.Pose(torch.as_tensor(R0),
                                             torch.as_tensor(t0)),
                                torch.as_tensor(v0), torch.as_tensor(bias_i),
                                tp.gravity)
    np.testing.assert_allclose(_np(X.R), np.asarray(jX.R), atol=1e-12)
    np.testing.assert_allclose(_np(X.t), np.asarray(jX.t), atol=1e-12)
    np.testing.assert_allclose(_np(v), np.asarray(jv), atol=1e-12)


@pytest.mark.parametrize("name", ["vn100_params", "mems_params"])
def test_presets(name):
    ref = getattr(jimu, name)()
    port = getattr(imu, name)(device="cpu")
    for f in ref._fields:
        np.testing.assert_array_equal(_np(getattr(port, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert (imu.VN100_DT, imu.MEMS_DT) == (jimu.VN100_DT, jimu.MEMS_DT)


def test_streams(tmp_path):
    r = np.random.default_rng(7)
    n = 300
    rows = np.column_stack([np.arange(n) * 0.005, r.normal(size=(n, 9))])
    path = tmp_path / "vn100.log"
    np.savetxt(path, rows)
    a, b = imu.read_vn100_log(str(path)), jimu.read_vn100_log(str(path))
    for f in ("t", "acc", "gyr", "rpy"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    mems = np.column_stack([np.r_[np.arange(5, 105), np.arange(100)],
                            r.integers(-500, 500, size=(200, 6))])
    path = tmp_path / "mems.log"
    np.savetxt(path, mems, fmt="%d")
    a, b = imu.read_mems_log(str(path)), jimu.read_mems_log(str(path))
    assert a.start == b.start == 100
    for f in ("t", "acc", "gyr"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for t in (-1.0, 0.0, 0.2512, 0.7, 1.4975, 2.0):
        for start in (0, 17):
            assert imu.find_index_at(a.t, t, start) == \
                jimu.find_index_at(b.t, t, start)
    assert imu.mems_frame_times([5, 34, 120, 160, 60], start_index=3) == \
        jimu.mems_frame_times([5, 34, 120, 160, 60], start_index=3)
    a.set_start_time(0.31)
    b.set_start_time(0.31)
    np.testing.assert_array_equal(a.window(3, 9)[0], b.window(3, 9)[0])
    bias_a, g_a = imu.static_bias_estimate(a, 50)
    bias_b, g_b = jimu.static_bias_estimate(b, 50)
    np.testing.assert_array_equal(bias_a, bias_b)
    for d in (g_a, [0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.3, -0.2, 0.9]):
        np.testing.assert_array_equal(imu.gravity_aligning_rotation(d),
                                      jstreams.gravity_aligning_rotation(d))


def test_extrinsics_and_euler():
    for pitch in (0.0, 0.13, -0.4):
        for name in ("world_to_original", "camera_to_imu"):
            ref = getattr(jext, name)(pitch)
            port = getattr(extrinsics, name)(pitch, device="cpu")
            np.testing.assert_allclose(_np(port.R), np.asarray(ref.R),
                                       atol=1e-15)
            np.testing.assert_array_equal(_np(port.t), np.asarray(ref.t))
    ref = jext.camera_to_imu_translation(0.1, -0.2, 0.3)
    port = extrinsics.camera_to_imu_translation(0.1, -0.2, 0.3, device="cpu")
    np.testing.assert_array_equal(_np(port.t), np.asarray(ref.t))
    np.testing.assert_array_equal(_np(port.R), np.eye(3))
    rpy = np.random.default_rng(8).uniform(-1.2, 1.2, size=(5, 3))
    Rj = jso3.rzryrx(*jnp.asarray(rpy.T))
    Rt = so3.rzryrx(*torch.as_tensor(rpy.T))
    np.testing.assert_allclose(_np(Rt), np.asarray(Rj), atol=1e-15)
    np.testing.assert_allclose(_np(so3.rpy(Rt)), rpy, atol=1e-13)


def _vio_graph(builder_cls, preints, gravity, r_seed=9):
    """Four poses with velocities and biases, priors on the first, three
    IMU factors and a between factor: the VIO window shape."""
    r = np.random.default_rng(r_seed)
    b = builder_cls()
    for k in range(4):
        b.add_pose((np.asarray(jso3.expmap(jnp.asarray(
            r.normal(size=3) * 0.3))), r.normal(size=3)))
        b.add_vel(r.normal(size=3))
        b.add_bias(r.normal(size=6) * 0.01)
    b.add_prior_pose(0, b.pose(0), sigmas=np.full(6, 1e-3))
    b.add_prior_vel(0, np.zeros(3), sigma=1e-2)
    b.add_prior_bias(0, np.zeros(6), sigma=1e-2, robust=0.5)
    b.add_between(0, 2, b.pose(2), sigmas=np.full(6, 0.1))
    for k, st in enumerate(preints):
        b.add_imu_factor(k, k + 1, st, gravity)
    return b


def _preints():
    jp, _ = _params()
    out = []
    for k in range(3):
        acc, gyr, dt, b = _window(20, seed=20 + k, pad=3)
        out.append(jax.tree.map(np.asarray, jimu.integrate_segment_parallel(
            jimu.init_preint(jnp.asarray(b), jp), acc, gyr, dt, jp)))
    return out, np.asarray(jp.gravity)


@pytest.fixture(scope="module")
def vio_graphs():
    preints, g = _preints()
    gj, vj = _vio_graph(jbuilder.GraphBuilder, preints, g).build(bucket=8)
    gt, vt = _vio_graph(GraphBuilder, preints, g).build(bucket=8,
                                                        device="cpu")
    return gj, vj, gt, vt


def test_builder_vio_tables_match(vio_graphs):
    gj, vj, gt, vt = vio_graphs
    for name in ("prior_pose", "between", "prior_vel", "prior_bias", "imu"):
        for f in getattr(gj, name)._fields:
            np.testing.assert_allclose(
                _np(getattr(getattr(gt, name), f)),
                np.asarray(getattr(getattr(gj, name), f)), rtol=1e-15,
                atol=0, err_msg=f"{name}.{f}")
    for f in ("pose_R", "pose_t", "vel", "bias", "num_vels", "num_biases"):
        np.testing.assert_array_equal(_np(getattr(vt, f)),
                                      np.asarray(getattr(vj, f)), err_msg=f)


def _assert_blocks(port_blocks, ref_blocks):
    assert len(port_blocks) == len(ref_blocks)
    for (r, J, c), (rj, Jj, cj) in zip(port_blocks, ref_blocks):
        np.testing.assert_array_equal(_np(c), np.asarray(cj))
        for a, b in ((r, rj), (J, Jj)):
            b = np.asarray(b)
            scale = max(1.0, float(np.abs(b).max()))
            np.testing.assert_allclose(_np(a), b, rtol=0, atol=1e-10 * scale)


def test_vio_rows_total_error_and_linearize(vio_graphs):
    gj, vj, _, _ = vio_graphs
    # the reference's own tables, carried over: the comparison is of the
    # factor code alone
    gt = convert.graph_from_numpy(jax.tree.map(np.asarray, gj), device="cpu")
    vt = convert.arena_from_numpy(jax.tree.map(np.asarray, vj), device="cpu")
    e_ref = float(jfactors.total_error(gj, vj))
    assert abs(float(total_error(gt, vt)) - e_ref) <= 1e-12 * e_ref
    _assert_blocks(linearize_blocks(gt, vt),
                   jax.jit(jfactors.linearize_blocks)(gj, vj))


def test_imu_jacobian_finite_at_identity():
    """An IMU row whose states already agree with its deltas: the residual
    is zero, ``logmap`` sits on its Taylor branch at an identity rotation,
    and the jacfwd Jacobian must still be finite and match the
    reference's."""
    jp, _ = _params()
    st = jax.tree.map(np.asarray, jimu.init_preint(jnp.zeros(6), jp))
    st = st._replace(dt=np.asarray(0.1), cov=np.eye(15) * 1e-4)
    g = np.asarray(jp.gravity)
    graphs = []
    for cls in (jbuilder.GraphBuilder, GraphBuilder):
        b = cls()
        b.add_pose((np.eye(3), np.zeros(3)))
        b.add_pose((np.eye(3), 0.5 * g * 0.1 * 0.1))
        b.add_vel(np.zeros(3))
        b.add_vel(g * 0.1)
        for _ in range(2):
            b.add_bias(np.zeros(6))
        b.add_imu_factor(0, 1, st, g)
        graphs.append(b)
    gj, vj = graphs[0].build(bucket=4)
    gt, vt = graphs[1].build(bucket=4, device="cpu")
    blocks = linearize_blocks(gt, vt)
    r, J, _ = blocks[-1]
    assert float(r.abs().max()) < 1e-12
    assert bool(torch.isfinite(J).all())
    _assert_blocks(blocks, jax.jit(jfactors.linearize_blocks)(gj, vj))


def test_convert_round_trip():
    jp, _ = _params()
    acc, gyr, dt, b = _window(8, seed=11, pad=1)
    jst = jax.tree.map(np.asarray, jimu.integrate_segment_parallel(
        jimu.init_preint(jnp.asarray(b), jp), acc, gyr, dt, jp))
    st = convert.preint_from_numpy(jst, device="cpu")
    back = convert.to_numpy(st)
    for f in jst._fields:
        np.testing.assert_array_equal(getattr(back, f), getattr(jst, f))
    assert st.dR.dtype == torch.float64
    p32 = convert.imu_params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu", dtype=torch.float32)
    assert p32.gravity.dtype == torch.float32


def _random_imu_rows(F, seed, identity=False):
    from graph_slam_tpu_torch.graph.factors import _ImuRows

    r = np.random.default_rng(seed)

    def rot(n):
        return so3.expmap(torch.as_tensor(r.normal(size=(n, 3)) * 0.4))

    def vec(*shape, s=1.0):
        return torch.as_tensor(r.normal(size=(F, *shape)) * s)

    rows = _ImuRows(rot(F), vec(3), vec(3), vec(6, s=0.02), rot(F), vec(3),
                    vec(3), vec(6, s=0.02), rot(F), vec(3), vec(3),
                    vec(3, 3, s=0.1), vec(3, 3, s=0.1), vec(3, 3, s=0.1),
                    vec(3, 3, s=0.1), vec(3, 3, s=0.1), vec(6, s=0.02),
                    torch.as_tensor(r.uniform(0.05, 0.2, size=F)),
                    torch.tensor([0.0, 0.0, -9.81],
                                 dtype=torch.float64).expand(F, 3))
    if identity:   # every rotation and bias at its identity / estimate
        eye = torch.eye(3, dtype=torch.float64).expand(F, 3, 3)
        rows = rows._replace(Ri=eye, Rj=eye, dR=eye, bi=rows.bias_hat)
    return rows


@pytest.mark.parametrize("identity", [False, True])
def test_imu_closed_form_jacobian_matches_jacfwd(identity):
    """The port's closed-form IMU Jacobian against ``torch.func.jacfwd`` of
    its residual under ``vmap``, on random rows and at identity rotations
    (logmap on its Taylor branch): 1e-10 relative to the largest entry."""
    from graph_slam_tpu_torch.graph import factors

    rows = _random_imu_rows(8, seed=31, identity=identity)
    zero = torch.zeros(8, 30, dtype=torch.float64)
    J_ad = torch.func.vmap(torch.func.jacfwd(factors._imu_residual,
                                             argnums=1))(rows, zero)
    J = factors._imu_jacobian(rows, factors._imu_parts(rows))
    assert bool(torch.isfinite(J_ad).all()) and bool(torch.isfinite(J).all())
    scale = float(J_ad.abs().max())
    np.testing.assert_allclose(J.numpy(), J_ad.numpy(), rtol=0,
                               atol=1e-10 * scale)
    np.testing.assert_allclose(
        factors._imu_residual(rows, zero).numpy(),
        factors._imu_parts(rows).e.numpy(), rtol=0, atol=1e-15)
