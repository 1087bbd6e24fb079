"""The port's default device is the CUDA card.

Without ``device=`` every entry point that creates tensors resolves to
``cuda`` and, where there is no card, raises a RuntimeError that names it;
nothing steps down to the CPU quietly. With ``device="cpu"`` each runs on
the CPU. Whether there is a card is decided inside each test.
"""

import types

import numpy as np
import pytest
import torch

from graph_slam_tpu_torch import convert
from graph_slam_tpu_torch import imu
from graph_slam_tpu_torch.config import SR4000
from graph_slam_tpu_torch.core import extrinsics, se3
from graph_slam_tpu_torch.datasets import (make_ba_graph, make_sphere_graph,
                                           make_vio_plane_scenario)
from graph_slam_tpu_torch.device import resolve
from graph_slam_tpu_torch.graph import (GraphBuilder, factors, online,
                                        variables)
from graph_slam_tpu_torch.io import Trajectory, VROLog
from graph_slam_tpu_torch.mapping import (accumulate_cloud, fuse_trajectory,
                                          make_volume)
from graph_slam_tpu_torch.noise import models as noise
from graph_slam_tpu_torch.pipelines import (BaImuConfig, VioConfig,
                                            build_graph_from_g2o,
                                            build_pose_graph, run_ba_imu,
                                            run_g2o_file, run_pose_graph,
                                            run_vio, vio_planes)
from graph_slam_tpu_torch.vision import (Cal3DS2, depth_to_cloud,
                                         extract_features, make_ba_fn,
                                         make_feature_cache, sift_features,
                                         two_frame_ba)

torch.set_num_threads(1)


def _log(n=6):
    xi = np.tile(np.array([0.0, 0.0, 0.05, 0.1, 0.0, 0.0]), (n - 1, 1))
    info = np.tile(np.eye(6) * 100.0, (n - 1, 1, 1))
    return VROLog(np.arange(1, n), np.arange(n - 1), xi, info)


def _two_pose_graph():
    b = GraphBuilder()
    i = b.add_pose((np.eye(3), np.zeros(3)))
    j = b.add_pose((np.eye(3), np.array([1.0, 0.0, 0.0])))
    b.add_prior_pose(i, (np.eye(3), np.zeros(3)), sigmas=np.full(6, 1e-3))
    b.add_between(i, j, (np.eye(3), np.array([1.0, 0.0, 0.0])),
                  sigmas=np.full(6, 0.1))
    return b


def _np_graph_and_arena():
    graph, values = _two_pose_graph().build(bucket=4, device="cpu")
    return convert.to_numpy(graph), convert.to_numpy(values)


def _vio_run(engine="scan", **kw):
    log, times, stream, _, _, _ = make_vio_plane_scenario(
        6, render=False, device="cpu")
    params = imu.vn100_params(device="cpu")
    return run_vio(log, times, stream, params,
                   cfg=VioConfig(engine=engine, plane_mode="off",
                                 optimize_step=3, max_imu_window=24,
                                 bucket=8, final_batch=False),
                   **kw).values.pose_t


def _load_state(**kw):
    """A checkpoint written from the CPU, loaded where ``kw`` says."""
    import os
    import tempfile

    og = online.OnlineGraph(factors.empty_graph(1, 1, device="cpu"),
                            variables.empty_arena(2, device="cpu"))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        og.save_state(path)
        return online.OnlineGraph.load_state(path, **kw).values.pose_t


def _rescue_run(**kw):
    """A provider-fed rescue: every other record failed, one wall seen."""
    log, times, stream, _, _, _ = make_vio_plane_scenario(
        6, fail_every=2, render=False, device="cpu")
    params = imu.vn100_params(device="cpu")
    return run_vio(log, times, stream, params,
                   plane_obs_provider=lambda seq: [
                       (np.array([0.0, 0.0, 1.0, -4.0]), np.eye(3) * 1e-5)],
                   cfg=VioConfig(engine="scan", plane_mode="rescue",
                                 optimize_step=3, max_imu_window=24,
                                 final_batch=False), **kw).values.plane


def _g2o_graph():
    """Three poses on a line and two edges, as ``io.read_g2o`` gives them."""
    q = np.array([1.0, 0.0, 0.0, 0.0])
    vertices = {k: (np.array([float(k), 0.0, 0.0]), q) for k in range(3)}
    edges = [(k, k + 1, np.array([1.0, 0.0, 0.0]), q, np.eye(6) * 100.0)
             for k in range(2)]
    return vertices, edges


def _g2o_file_run(**kw):
    import os
    import tempfile

    from graph_slam_tpu_torch.io import write_g2o

    vertices, edges = _g2o_graph()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "line.g2o")
        write_g2o(path, np.stack([v[0] for v in vertices.values()]),
                  np.stack([v[1] for v in vertices.values()]), edges)
        return run_g2o_file(path, bucket=8, **kw).values.pose_t


def _np_preint():
    st = imu.init_preint(np.zeros(6), imu.vn100_params(device="cpu"),
                         device="cpu")
    return convert.to_numpy(st)


def _propagation_fields():
    z = np.zeros
    return dict(planes_i=z((1, 4)), S_ni=z((1, 3, 3)), S_di=z(1),
                prev_masks=z((1, 4, 4), bool), prev_counts=z(1), T_R=np.eye(3),
                T_t=z(3), S_tij=z((3, 3)), intensity=z((4, 4)),
                depth=z((4, 4)))


def _two_frame_run(**kw):
    """Two frames 10 cm apart seeing eight points; the refined pose comes
    back as numpy, so the device is read off the camera it built."""
    pts = np.stack([np.linspace(-0.5, 0.5, 8), np.linspace(0.4, -0.4, 8),
                    np.linspace(2.0, 3.0, 8)], axis=1)
    K = Cal3DS2.make(250.0, 250.0, 90.0, 70.0, device="cpu")

    def uv(p):
        return (p[:, :2] / p[:, 2:] * 250.0 + np.array([90.0, 70.0]))

    t = np.array([0.1, 0.0, 0.0])
    (R, _), _, _ = two_frame_ba(pts, uv(pts), uv(pts - t), K,
                                (np.eye(3), t), bucket=8, **kw)
    return torch.as_tensor(R, device=resolve(kw.get("device")))


def _ba_imu_run(**kw):
    """Three frames of four landmarks, no IMU, LM."""
    W = np.array([[0.0, 0.0, 3.0], [0.5, 0.2, 2.5], [-0.4, 0.3, 3.5],
                  [0.2, -0.5, 3.0]])
    frames = [{"uv": W[:, :2] / W[:, 2:] * 250.0 + 80.0, "pts3": W}
              for _ in range(3)]
    return run_ba_imu(frames, lambda i, j: [(k, k) for k in range(4)],
                      {0: 0.0, 1: 0.1, 2: 0.2}, None, None, SR4000,
                      cfg=BaImuConfig(use_imu=False, solver="lm", bucket=4),
                      **kw).values.point


def _frame(h=48, w=56):
    """A random texture at 2 m."""
    img = np.random.default_rng(0).uniform(0, 255, (h, w)).astype(np.float32)
    return img, np.full((h, w), 2.0, np.float32)


def _online_slam(**kw):
    from graph_slam_tpu_torch.pipelines import OnlineSlam

    return OnlineSlam(cam=SR4000, **kw).og.values.pose_t


def _feature_frame(**kw):
    f = extract_features(SR4000, *_frame(), max_features=8, device="cpu")
    return convert.feature_frame_from_numpy(convert.to_numpy(f), **kw).uv


def _fuse(**kw):
    """Two frames fused into a 16^3 grid."""
    ids = np.arange(2)
    traj = Trajectory(ids, np.zeros((2, 3)), np.tile([1.0, 0, 0, 0], (2, 1)),
                      ids)
    return fuse_trajectory(traj, lambda s: _frame(), SR4000, (-1, -1, 0),
                           4.0, n=16, **kw).tsdf


def _euler(**kw):
    from graph_slam_tpu_torch.imu.euler import integrate_euler

    return integrate_euler(np.zeros((3, 3)), 0.01, **kw)


ENTRY_POINTS = {
    "extract_features": lambda **kw: extract_features(
        SR4000, *_frame(), max_features=8, **kw).uv,
    "sift_features": lambda **kw: sift_features(
        SR4000, *_frame(), max_features=8, n_octaves=2, **kw).uv,
    "make_feature_cache": lambda **kw: make_feature_cache(
        {0: _frame()}.get, SR4000, max_features=8, **kw)(0).uv,
    "OnlineSlam": _online_slam,
    "convert.feature_frame_from_numpy": _feature_frame,
    "integrate_euler": _euler,
    "fuse_trajectory": _fuse,
    "make_volume": lambda **kw: make_volume((0, 0, 0), 1.0, 4, **kw).weight,
    "make_ba_graph": lambda **kw: make_ba_graph(
        4, 30, bucket=8, **kw)[1].point,
    "Cal3DS2.make": lambda **kw: Cal3DS2.make(1.0, 1.0, 0.0, 0.0, **kw).fx,
    "depth_to_cloud": lambda **kw: depth_to_cloud(
        SR4000, np.ones((4, 5)), **kw)[0],
    "two_frame_ba": _two_frame_run,
    "run_ba_imu": _ba_imu_run,
    "convert.cal3ds2_from_numpy": lambda **kw: convert.cal3ds2_from_numpy(
        convert.to_numpy(Cal3DS2.make(1.0, 1.0, 0.0, 0.0, device="cpu")),
        **kw).fx,
    "run_pose_graph": lambda **kw: run_pose_graph(
        _log(), bucket=8, **kw).values.pose_t,
    "build_pose_graph": lambda **kw: build_pose_graph(
        _log(), bucket=8, **kw)[1].pose_t,
    "run_g2o_file": _g2o_file_run,
    "build_graph_from_g2o": lambda **kw: build_graph_from_g2o(
        *_g2o_graph(), bucket=8, **kw)[1].pose_t,
    "make_sphere_graph": lambda **kw: make_sphere_graph(
        20, bucket=8, **kw)[1].pose_t,
    "GraphBuilder.build": lambda **kw: _two_pose_graph().build(**kw)[1].pose_t,
    "empty_arena": lambda **kw: variables.empty_arena(4, **kw).pose_t,
    "empty_table": lambda **kw: factors.empty_table(
        factors.PlaneTable, **kw).active,
    "se3.identity": lambda **kw: se3.identity((2,), **kw).t,
    "isotropic_sqrt_info": lambda **kw: noise.isotropic_sqrt_info(
        3, 0.5, **kw),
    "convert.tensor": lambda **kw: convert.tensor(np.arange(3.0), **kw),
    "convert.graph_from_numpy": lambda **kw: convert.graph_from_numpy(
        _np_graph_and_arena()[0], **kw).between.active,
    "convert.arena_from_numpy": lambda **kw: convert.arena_from_numpy(
        _np_graph_and_arena()[1], **kw).pose_t,
    "convert.propagation_inputs": lambda **kw: convert.propagation_inputs(
        **_propagation_fields(), **kw).depth,
    "convert.imu_params_from_numpy": lambda **kw:
        convert.imu_params_from_numpy(convert.to_numpy(
            imu.vn100_params(device="cpu")), **kw).gravity,
    "convert.preint_from_numpy": lambda **kw: convert.preint_from_numpy(
        _np_preint(), **kw).cov,
    "run_vio": _vio_run,
    "run_vio (online)": lambda **kw: _vio_run(engine="online", **kw),
    "OnlineGraph.load_state": _load_state,
    "_OnlineVioGraph": lambda **kw: vio_planes._OnlineVioGraph(
        4, 3, 8, 4, 8, **kw).og.values.pose_t,
    "run_vio (plane rescue)": _rescue_run,
    "make_vio_plane_scenario": lambda **kw: make_vio_plane_scenario(
        4, render=False, **kw)[3].gravity,
    "init_preint": lambda **kw: imu.init_preint(
        np.zeros(6), imu.vn100_params(device="cpu"), **kw).dR,
    "vn100_params": lambda **kw: imu.vn100_params(**kw).gyro_cov,
    "mems_params": lambda **kw: imu.mems_params(**kw).gyro_cov,
    "world_to_original": lambda **kw: extrinsics.world_to_original(
        0.1, **kw).R,
    "camera_to_imu": lambda **kw: extrinsics.camera_to_imu(0.1, **kw).R,
    "camera_to_imu_translation": lambda **kw:
        extrinsics.camera_to_imu_translation(0.1, 0.2, 0.3, **kw).t,
    "empty_graph": lambda **kw: factors.empty_graph(2, imu_cap=2,
                                                    **kw).imu.dR,
    "OnlineGraph": lambda **kw: online.OnlineGraph(
        factors.empty_graph(1, 1, **kw),
        variables.empty_arena(2, 2, 2, **kw)).values.pose_t,
}


def test_resolve():
    assert resolve("cpu") == torch.device("cpu")
    assert resolve(torch.device("cpu")) == torch.device("cpu")
    assert resolve("cuda:1") == torch.device("cuda", 1)
    if torch.cuda.is_available():
        assert resolve(None) == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            resolve(None)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    call = ENTRY_POINTS[name]
    assert call(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


def _host_entry_points():
    """Entry points that return host arrays: each computes on ``device``
    (the card unless told otherwise); ``device="cpu"`` runs them here."""
    from graph_slam_tpu_torch import tools
    from graph_slam_tpu_torch.pipelines import (features_from_store,
                                                plane_check)

    plane = np.array([0.0, 0.0, 1.0, -2.0])
    cov = np.eye(3) * 1e-4
    return {
        "features_from_store": lambda **kw: features_from_store(
            {0: _frame()}.get, [0], SR4000, max_features=8, **kw),
        "make_frame_matcher": lambda **kw: tools.make_frame_matcher(
            {0: _frame()}.get, SR4000, max_features=8, **kw),
        "make_ba_fn": lambda **kw: make_ba_fn({0: _frame()}.get, SR4000,
                                              max_features=8, **kw),
        "compute_trans_difference": lambda **kw:
            tools.compute_trans_difference(_log(), _log(), **kw),
        "plane_pair_mahalanobis": lambda **kw:
            plane_check.plane_pair_mahalanobis(plane, cov, plane, cov,
                                               np.zeros(6), np.eye(6) * 1e-4,
                                               **kw),
        "plane_set_consistency": lambda **kw:
            plane_check.plane_set_consistency([plane], [cov], [plane], [cov],
                                              np.zeros(6), np.eye(6) * 1e-4,
                                              **kw),
        "check_vo_edges": lambda **kw: plane_check.check_vo_edges(
            _log(3), lambda s: ([plane], [cov]), **kw),
    }


def _accumulate(**kw):
    ids = np.arange(2)
    traj = Trajectory(ids, np.zeros((2, 3)), np.tile([1.0, 0, 0, 0], (2, 1)),
                      ids)
    return accumulate_cloud(traj, lambda s: _frame(), SR4000, **kw)


def _serve(**kw):
    """``serve_slam`` that binds and stops before its first message."""
    from graph_slam_tpu_torch.serving import serve_slam

    return serve_slam(SR4000, port=0, max_messages=0, **kw)


def _cli(**kw):
    """``python -m graph_slam_tpu_torch [--device D] diff`` in process: the
    top-level option or, without it, the card."""
    import contextlib
    import io
    import os
    import tempfile

    from graph_slam_tpu_torch import cli
    from graph_slam_tpu_torch.io import write_vro_log

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vro.log")
        write_vro_log(path, _log())
        argv = ["diff", "--log1", path, "--log2", path]
        if "device" in kw:
            argv = ["--device", kw["device"]] + argv
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        return buf.getvalue()


def _host_and_service_entry_points():
    return dict(_host_entry_points(), accumulate_cloud=_accumulate,
                serve_slam=_serve, cli=_cli)


@pytest.mark.parametrize("name", sorted(_host_and_service_entry_points()))
def test_host_entry_point_defaults_to_the_card(name):
    call = _host_and_service_entry_points()[name]
    assert call(device="cpu") is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


def test_no_signature_defaults_to_the_cpu():
    """No function of the port has a ``device`` parameter that defaults to
    anything but None."""
    import importlib
    import inspect
    import pkgutil

    import graph_slam_tpu_torch

    seen = 0
    for info in pkgutil.walk_packages(graph_slam_tpu_torch.__path__,
                                      "graph_slam_tpu_torch."):
        mod = importlib.import_module(info.name)
        for _, obj in inspect.getmembers(mod):
            members = [obj] if inspect.isfunction(obj) else (
                [f for _, f in inspect.getmembers(obj, inspect.isfunction)]
                if inspect.isclass(obj) else [])
            for fn in members:
                if not getattr(fn, "__module__", "").startswith(
                        "graph_slam_tpu_torch"):
                    continue
                param = inspect.signature(fn).parameters.get("device")
                if param is None or param.default is inspect.Parameter.empty:
                    continue        # no default: the caller has resolved it
                seen += 1
                assert param.default is None, (fn.__module__, fn.__name__)
    assert seen >= len(ENTRY_POINTS) - 1
