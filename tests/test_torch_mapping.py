"""The port's mapping (``graph_slam_tpu_torch.mapping``) against the JAX
package, on the CPU: TSDF integration and marching tetrahedra (with the
cases of ``tests/test_tsdf.py`` on the port), fused trajectories, global
clouds, the numpy filters, grid meshes, PCD and PLY files, map-video
snapshots and the headless viewers.

Frames are ``frontend_reference_ate.py``'s box room rendered at an 80 x 60
pinhole camera along its closed path, and ``test_pipelines2``'s SR4000
wall.

Tolerances: ``integrate`` with float32 poses within 1e-6 of JAX's grid and
with float64 poses within 1e-6 (the port stores the float32 grid that JAX
widens to float64), weights equal on every voxel (no flipped voxel);
``extract_mesh`` bit-equal to JAX's on the same arrays, and its device
candidate mask equal to numpy's; clouds within 1e-6 m, colours equal;
filters, meshes, files, snapshots and viewers equal (PLY points read back
within 1e-6 m).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import frontend_reference_ate as fra
from test_pipelines2 import render_wall_frame

from graph_slam_tpu import mapping as jm
from graph_slam_tpu.config import CameraIntrinsics as JCameraIntrinsics
from graph_slam_tpu.config import SR4000 as JSR4000
from graph_slam_tpu.core import extrinsics as jext
from graph_slam_tpu.io import Trajectory as JTrajectory
from graph_slam_tpu.io import frames as jframes
from graph_slam_tpu.mapping import tsdf as jtsdf
from graph_slam_tpu_torch import mapping as tm
from graph_slam_tpu_torch.config import CameraIntrinsics, SR4000
from graph_slam_tpu_torch.core import extrinsics
from graph_slam_tpu_torch.io import FrameStore, Trajectory
from graph_slam_tpu_torch.mapping import tsdf

CPU = "cpu"
K = CameraIntrinsics(fx=200.0, fy=200.0, cx=80.0, cy=60.0,
                     width=160, height=120)
JK = JCameraIntrinsics(**dataclasses.asdict(K))
ROOM_K = CameraIntrinsics(fx=60.0, fy=60.0, cx=39.5, cy=29.5, width=80,
                          height=60)
JROOM_K = JCameraIntrinsics(**dataclasses.asdict(ROOM_K))


def _read_ply_points(path):
    with open(path) as f:
        lines = f.read().splitlines()
    k = lines.index("end_header")
    rows = np.asarray([x.split() for x in lines[k + 1:]], float)
    return rows.reshape(-1, 6)[:, :3], rows.reshape(-1, 6)[:, 3:]


@pytest.fixture(scope="module")
def room():
    """12 frames of the box room's closed path at the 80 x 60 camera:
    (R (12, 3, 3), t (12, 3), [(intensity, depth)] numpy)."""
    R, t = fra.room_path(12)
    tex, rays = fra.room_scene(ROOM_K, CPU)
    frames = [tuple(x.numpy() for x in
                    fra.render_room_frame(ROOM_K, R[k], t[k], tex, rays))
              for k in range(12)]
    return R, t, frames


def _traj(R, t):
    from graph_slam_tpu_torch.core import so3

    q = so3.matrix_to_quat(torch.as_tensor(R)).numpy()
    ids = np.arange(len(t))
    return Trajectory(ids, np.asarray(t), q, ids), \
        JTrajectory(ids, np.asarray(t), q, ids)


# -- the cases of tests/test_tsdf.py on the port -------------------------------

def _sphere_volume(n=48, r=0.6, trunc=0.2):
    vol = tsdf.make_volume(origin=(-1, -1, -1), size_m=2.0, n=n, device=CPU)
    idx = (np.arange(n) + 0.5) * float(vol.voxel)
    X, Y, Z = np.meshgrid(idx - 1, idx - 1, idx - 1, indexing="ij")
    sdf = np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - r
    return vol._replace(
        tsdf=torch.as_tensor(np.clip(sdf / trunc, -1, 1), dtype=torch.float32),
        weight=torch.ones((n, n, n), dtype=torch.float32))


def test_sphere_isosurface():
    V, F = tsdf.extract_mesh(_sphere_volume())
    assert len(V) > 1000 and len(F) > 2000
    rad = np.linalg.norm(V, axis=1)
    assert abs(rad.mean() - 0.6) < 2e-3
    assert np.abs(rad - 0.6).max() < 0.01
    assert F.max() < len(V)
    assert (F[:, 0] != F[:, 1]).all()


def test_unobserved_region_is_skipped():
    vol = _sphere_volume()
    w = vol.weight.clone()
    w[:24] = 0.0
    V, _ = tsdf.extract_mesh(vol._replace(weight=w))
    assert (V[:, 0] > -0.05).all()


def test_empty_volume():
    V, F = tsdf.extract_mesh(tsdf.make_volume((0, 0, 0), 1.0, 8, device=CPU))
    assert len(V) == 0 and len(F) == 0


def test_flat_wall_fuses_at_depth():
    depth = np.full((120, 160), 1.5, np.float32)
    vol = tsdf.make_volume((-1.0, -1.0, 0.0), 2.0, 64, device=CPU)
    for dx in (0.0, 0.05, -0.05):
        tsdf.integrate(vol, K, depth, torch.eye(3),
                       torch.tensor([dx, 0.0, 0.0]))
    V, F = tsdf.extract_mesh(vol)
    assert len(F) > 1000
    np.testing.assert_allclose(V[:, 2], 1.5, atol=1e-3)
    assert float(vol.weight.max()) == 3.0


def test_noise_averages_out():
    rng = np.random.default_rng(0)
    vol = tsdf.make_volume((-1.0, -1.0, 0.0), 2.0, 64, device=CPU)
    for _ in range(16):
        depth = (1.5 + rng.normal(0, 0.03, (120, 160))).astype(np.float32)
        tsdf.integrate(vol, K, depth, torch.eye(3), torch.zeros(3))
    V, _ = tsdf.extract_mesh(vol, min_weight=8.0)
    assert len(V) > 100
    assert abs(np.mean(V[:, 2]) - 1.5) < 5e-3
    assert np.std(V[:, 2]) < 0.02


def test_behind_surface_not_carved():
    depth = np.full((120, 160), 1.0, np.float32)
    vol = tsdf.make_volume((-1.0, -1.0, 0.0), 2.0, 32, device=CPU)
    tsdf.integrate(vol, K, depth, torch.eye(3), torch.zeros(3))
    w = vol.weight.numpy()
    n = 32
    z = (np.arange(n) + 0.5) * float(vol.voxel)
    assert w[n // 2, n // 2, z > 1.0 + 5 * float(vol.voxel)].max() == 0.0
    assert w[n // 2, n // 2, (z > 0.2) & (z < 0.9)].min() == 1.0


# -- integrate and extract_mesh against JAX ----------------------------------

@pytest.mark.parametrize("pose_dtype", [np.float32, np.float64])
def test_integrate_matches_jax(room, pose_dtype, monkeypatch):
    """Six room frames into a 48^3 grid over the room, in both packages;
    the port in slabs of 5 planes."""
    monkeypatch.setattr(tsdf, "SLAB_VOXELS", 5 * 48 * 48)
    R, t, frames = room
    jv = jtsdf.make_volume((-4.0, -2.0, -4.0), 8.0, 48)
    tv = tsdf.make_volume((-4.0, -2.0, -4.0), 8.0, 48, device=CPU)
    for k in range(0, 12, 2):
        Rk, tk = R[k].astype(pose_dtype), t[k].astype(pose_dtype)
        jv = jtsdf.integrate(jv, JROOM_K, jnp.asarray(frames[k][1]),
                             jnp.asarray(Rk), jnp.asarray(tk))
        out = tsdf.integrate(tv, ROOM_K, frames[k][1], torch.as_tensor(Rk),
                             torch.as_tensor(tk))
        assert out is tv
    assert tv.tsdf.dtype == torch.float32
    jw = np.asarray(jv.weight)
    assert (tv.weight.numpy() != jw).sum() == 0
    assert jw.max() >= 3 and (jw > 0).mean() > 0.05
    np.testing.assert_allclose(tv.tsdf.numpy(), np.asarray(jv.tsdf),
                               rtol=0, atol=1e-6)


def test_slabs_do_not_change_the_grid(room, monkeypatch):
    R, t, frames = room
    vols = []
    for slab in (24, 1, 7):
        monkeypatch.setattr(tsdf, "SLAB_VOXELS", slab * 24 * 24)
        v = tsdf.make_volume((-4.0, -2.0, -4.0), 8.0, 24, device=CPU)
        for k in range(3):
            tsdf.integrate(v, ROOM_K, frames[k][1], torch.as_tensor(R[k]),
                           torch.as_tensor(t[k]))
        vols.append(v)
    for v in vols[1:]:
        assert torch.equal(v.tsdf, vols[0].tsdf)
        assert torch.equal(v.weight, vols[0].weight)


@pytest.mark.parametrize("min_weight", [1.0, 2.5])
def test_extract_mesh_bit_equal_to_jax(room, min_weight):
    """The same fused arrays through JAX's extraction, the port's (device
    mask + host triangles) and the port's plain numpy one."""
    R, t, frames = room
    jv = jtsdf.make_volume((-4.0, -2.0, -4.0), 8.0, 48)
    for k in range(12):
        jv = jtsdf.integrate(jv, JROOM_K, jnp.asarray(frames[k][1]),
                             jnp.asarray(R[k], jnp.float32),
                             jnp.asarray(t[k], jnp.float32))
    arrays = [np.asarray(x) for x in jv]
    Vj, Fj = jtsdf.extract_mesh(jv, min_weight=min_weight)
    tv = tsdf.TsdfVolume(*(torch.as_tensor(a.copy()) for a in arrays))
    V, F = tsdf.extract_mesh(tv, min_weight=min_weight)
    Vn, Fn = tsdf.extract_mesh_numpy(*arrays, min_weight=min_weight)
    assert len(F) > 500
    np.testing.assert_array_equal(V, Vj)
    np.testing.assert_array_equal(F, Fj)
    np.testing.assert_array_equal(Vn, Vj)
    np.testing.assert_array_equal(Fn, Fj)

    # the device mask is numpy's, cube for cube and value for value
    cubes, values = tsdf.candidate_cubes(tv, min_weight)
    tsdf64, wgt, n = arrays[0].astype(np.float64), arrays[1], 48
    vals8 = np.stack([tsdf._shifted(tsdf64, c, n) for c in tsdf._CORNERS])
    wt8 = np.stack([tsdf._shifted(wgt, c, n) for c in tsdf._CORNERS])
    cand = ((wt8 >= min_weight).all(0) & (vals8 < 0).any(0)
            & (vals8 >= 0).any(0))
    np.testing.assert_array_equal(cubes.numpy(), np.argwhere(cand))
    np.testing.assert_array_equal(values.numpy().astype(np.float64),
                                  vals8[:, cand].T)


def test_fuse_trajectory_matches_jax(room):
    """float64 poses (the reference widens its grid to float64 under x64;
    the port keeps float32), every other frame, with an extrinsic."""
    R, t, frames = room
    traj, jtraj = _traj(R, t)
    u2c = extrinsics.camera_to_imu(0.05, device=CPU)
    vol = tm.fuse_trajectory(traj, lambda s: frames[s], ROOM_K,
                             (-4.0, -2.0, -4.0), 8.0, n=40, stride=2,
                             u2c=u2c, device=CPU)
    jv = jm.fuse_trajectory(jtraj, lambda s: frames[s], JROOM_K,
                            (-4.0, -2.0, -4.0), 8.0, n=40, stride=2,
                            u2c=jext.camera_to_imu(0.05))
    assert (vol.weight.numpy() != np.asarray(jv.weight)).sum() == 0
    np.testing.assert_allclose(vol.tsdf.numpy(), np.asarray(jv.tsdf),
                               rtol=0, atol=1e-6)


# -- clouds, filters, files ----------------------------------------------------

def test_accumulate_cloud_matches_jax(room):
    R, t, frames = room
    traj, jtraj = _traj(R, t)
    for kw in (dict(stride=3, skip=2), dict(stride=5, skip=1, z_max=4.0)):
        pts, cols = tm.accumulate_cloud(traj, lambda s: frames[s], ROOM_K,
                                        u2c=extrinsics.camera_to_imu(
                                            0.1, device=CPU),
                                        device=CPU, **kw)
        want, want_c = jm.accumulate_cloud(jtraj, lambda s: frames[s],
                                           JROOM_K,
                                           u2c=jext.camera_to_imu(0.1), **kw)
        assert len(pts) > 1000
        np.testing.assert_allclose(pts, want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(cols, want_c)
    empty = tm.accumulate_cloud(traj, lambda s: None, ROOM_K, device=CPU)
    assert empty[0].shape == (0, 3) and empty[1].dtype == np.uint8


def _cloud(n=4000, seed=0):
    r = np.random.default_rng(seed)
    pts = r.normal(0, 0.4, (n, 3)) * np.array([2.0, 1.0, 0.2])
    return pts, r.integers(0, 256, (n, 3)).astype(np.uint8)


def test_numpy_filters_equal():
    pts, cols = _cloud()
    for a, b in ((tm.voxel_filter(pts, cols, 0.05),
                  jm.voxel_filter(pts, cols, 0.05)),
                 (tm.passthrough(pts, cols, axis=1, lo=-0.2, hi=0.3),
                  jm.passthrough(pts, cols, axis=1, lo=-0.2, hi=0.3)),
                 (tm.occupancy_denoise(pts, cols, 0.1, 4),
                  jm.occupancy_denoise(pts, cols, 0.1, 4))):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tm.voxel_filter(pts), jm.voxel_filter(pts))
    np.testing.assert_array_equal(tm.occupancy_denoise(pts),
                                  jm.occupancy_denoise(pts))
    np.testing.assert_array_equal(tm.passthrough(pts, hi=0.0),
                                  jm.passthrough(pts, hi=0.0))


def test_meshes_equal(tmp_path):
    pts, _ = _cloud(3000, seed=1)
    V, F = tm.grid_triangulate(pts, 0.05, 0.2)
    Vj, Fj = jm.grid_triangulate(pts, 0.05, 0.2)
    assert len(F) > 100
    np.testing.assert_array_equal(V, Vj)
    np.testing.assert_array_equal(F, Fj)
    tm.pcd_to_mesh(pts, str(tmp_path / "t.ply"), 0.05, 0.2)
    jm.pcd_to_mesh(pts, str(tmp_path / "j.ply"), 0.05, 0.2)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    assert tm.grid_triangulate(pts[:2])[1].shape == (0, 3)


@pytest.mark.parametrize("with_colors", [True, False])
def test_pcd_round_trip_equal(tmp_path, monkeypatch, with_colors):
    from graph_slam_tpu_torch import native

    pts, cols = _cloud(500, seed=2)
    cols = cols if with_colors else None
    tm.write_pcd(str(tmp_path / "t.pcd"), pts, cols)
    jm.write_pcd(str(tmp_path / "j.pcd"), pts, cols)
    assert (tmp_path / "t.pcd").read_bytes() == \
        (tmp_path / "j.pcd").read_bytes()
    back, back_c = tm.read_pcd(str(tmp_path / "t.pcd"))
    want, want_c = jm.read_pcd(str(tmp_path / "j.pcd"))
    np.testing.assert_array_equal(back, want)
    np.testing.assert_allclose(back, pts.astype(np.float32), rtol=1e-6)
    if with_colors:
        np.testing.assert_array_equal(back_c, cols)
        np.testing.assert_array_equal(back_c, want_c)
    else:
        assert back_c is None and want_c is None
    # the Python fallback writes the same float32 cloud (it prints each
    # value whole, the native writer to 8 significant digits)
    monkeypatch.setattr(native, "_LIB", False)
    tm.write_pcd(str(tmp_path / "f.pcd"), pts.astype(np.float32), cols)
    fb, fb_c = tm.read_pcd(str(tmp_path / "f.pcd"))
    np.testing.assert_array_equal(fb, pts.astype(np.float32))
    np.testing.assert_allclose(back, fb, rtol=1e-7)
    if with_colors:
        np.testing.assert_array_equal(fb_c, cols)


def test_map_from_frames_equal(room, tmp_path):
    R, t, frames = room
    traj, jtraj = _traj(R, t)
    for fmt in ("pcd", "ply"):
        tm.map_from_frames(traj, lambda s: frames[s], ROOM_K,
                           str(tmp_path / f"t.{fmt}"), fmt=fmt, stride=4,
                           voxel=0.1, device=CPU)
        jm.map_from_frames(jtraj, lambda s: frames[s], JROOM_K,
                           str(tmp_path / f"j.{fmt}"), fmt=fmt, stride=4,
                           voxel=0.1)
    a, ac = tm.read_pcd(str(tmp_path / "t.pcd"))
    b, bc = jm.read_pcd(str(tmp_path / "j.pcd"))
    np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_array_equal(ac, bc)
    a, ac = _read_ply_points(str(tmp_path / "t.ply"))
    b, bc = _read_ply_points(str(tmp_path / "j.ply"))
    np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_array_equal(ac, bc)


# -- video and viewers ------------------------------------------------------------

def test_video_equal(room, tmp_path):
    R, t, frames = room
    traj, jtraj = _traj(R, t)
    traj2, jtraj2 = _traj(R[:7], t[:7] + 0.1)
    snaps = tm.incremental_map_video(
        [traj, traj2], lambda s: frames[s] if s % 2 else None, ROOM_K,
        str(tmp_path / "t"), u2c=extrinsics.camera_to_imu(0.1, device=CPU),
        every=4, voxel=0.1, device=CPU)
    jsnaps = jm.incremental_map_video(
        [jtraj, jtraj2], lambda s: frames[s] if s % 2 else None, JROOM_K,
        str(tmp_path / "j"), u2c=jext.camera_to_imu(0.1), every=4,
        voxel=0.1)
    assert [s.replace(str(tmp_path / "t"), "") for s in snaps] == \
        [s.replace(str(tmp_path / "j"), "") for s in jsnaps]
    for a, b in zip(snaps, jsnaps):
        pa, ca = _read_ply_points(a)
        pb, cb = _read_ply_points(b)
        np.testing.assert_allclose(pa, pb, atol=1e-6)
        np.testing.assert_array_equal(ca, cb)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / "camera_path.txt"),
                               np.loadtxt(tmp_path / "j" / "camera_path.txt"),
                               atol=1e-12)
    from graph_slam_tpu.core import se3 as jse3
    from graph_slam_tpu_torch.core import se3

    eye, at = tm.follow_camera_pose(se3.Pose(torch.as_tensor(R[3]),
                                             torch.as_tensor(t[3])), 1.5, 0.5)
    jeye, jat = jm.follow_camera_pose(jse3.Pose(jnp.asarray(R[3]),
                                                jnp.asarray(t[3])), 1.5, 0.5)
    np.testing.assert_allclose(eye, jeye, atol=1e-12)
    np.testing.assert_array_equal(at, jat)


def test_viewers_equal(tmp_path):
    from graph_slam_tpu.core import se3 as jse3
    from graph_slam_tpu_torch.core import se3

    fi = render_wall_frame(SR4000, np.array([0.0, 0.0, 0.0]))
    fj = render_wall_frame(SR4000, np.array([0.1, 0.0, 0.0]))
    xi = np.array([0.01, -0.02, 0.03, 0.1, 0.0, 0.02])
    n = tm.write_registration_ply(str(tmp_path / "t.ply"), SR4000, fi, fj,
                                  se3.expmap(torch.as_tensor(xi)), skip=2)
    nj = jm.write_registration_ply(str(tmp_path / "j.ply"), JSR4000, fi, fj,
                                   jse3.expmap(jnp.asarray(xi)), skip=2)
    assert n == nj > 1000
    a, ac = _read_ply_points(str(tmp_path / "t.ply"))
    b, bc = _read_ply_points(str(tmp_path / "j.ply"))
    np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_array_equal(ac, bc)

    pytest.importorskip("PIL")
    from PIL import Image

    imgs = [fi[0], fj[0][:100, :150], np.zeros((20, 30))]
    assert tm.write_image_grid(str(tmp_path / "t.png"), imgs, cols=2) == \
        jm.write_image_grid(str(tmp_path / "j.png"), imgs, cols=2)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))


def test_frame_store_frames_through_the_mapping(tmp_path):
    """The tools read ``.gsf`` stores: a store's decoded frames give the
    same cloud in both packages."""
    store = FrameStore(str(tmp_path))
    for k in range(3):
        store.save(k, *render_wall_frame(SR4000, np.array([0.1 * k, 0, 0])))
    ids = np.arange(3)
    tt = np.stack([[0.1 * k, 0.0, 0.0] for k in range(3)])
    q = np.tile([1.0, 0.0, 0.0, 0.0], (3, 1))
    pts, cols = tm.accumulate_cloud(Trajectory(ids, tt, q, ids), store,
                                    SR4000, device=CPU)
    want, want_c = jm.accumulate_cloud(JTrajectory(ids, tt, q, ids),
                                       jframes.FrameStore(str(tmp_path)),
                                       JSR4000)
    np.testing.assert_allclose(pts, want, atol=1e-6)
    np.testing.assert_array_equal(cols, want_c)
