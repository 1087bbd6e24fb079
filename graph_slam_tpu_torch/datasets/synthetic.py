"""Synthetic generators (port of ``datasets/synthetic.py``).

``make_sphere_graph`` builds the sphere2500-class pose graph: a spiral over
a sphere with odometry edges and short-range loop closures, ~4 edges per
pose like the classic g2o sphere2500 (2500 poses / 9799 edges). It draws
the same numpy random numbers in the same order as the reference, so the
two packages build the same graph from the same seed.

``make_ba_graph`` is the bundle-adjustment stress problem (cameras on an
arc, Cal3DS2 projections of a point cloud): the reference's draws in the
reference's order, with the rows added in blocks, so its tables equal the
reference's and a 100,000-landmark graph builds in seconds.

``_render_plane_frame`` ray-casts depth and intensity of world planes
(the plane-rescue scenario's renderer), a numpy copy.

``make_vio_plane_scenario`` is the plane-aided VIO workload: an IMU stream,
the VRO log with periodic tracking failures, optional rendered frames and
the exact ground truth. It draws the reference's random numbers in the
reference's order and builds everything in float64 on the CPU, whatever
dtype the replay under test runs in.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..graph import GraphBuilder

__all__ = ["make_sphere_graph", "sphere_ground_truth", "make_ba_graph",
           "make_vio_plane_scenario"]


def _so3_exp(w):
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-10:
        return np.eye(3) + W
    return np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th**2 * (W @ W)


def sphere_ground_truth(n_poses: int, radius: float = 10.0, turns: int = 25):
    """Spiral over a sphere: positions + smooth headings (numpy)."""
    k = np.arange(n_poses)
    phi = np.arccos(1 - 2 * (k + 0.5) / n_poses)      # polar angle 0..pi
    lam = np.pi * turns * phi                          # azimuth spiral
    pos = radius * np.stack(
        [np.sin(phi) * np.cos(lam), np.sin(phi) * np.sin(lam), np.cos(phi)],
        axis=1,
    )
    Rs = []
    for i in range(n_poses):
        if i + 1 < n_poses:
            fwd = pos[i + 1] - pos[i]
        else:
            fwd = pos[i] - pos[i - 1]
        fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
        up = pos[i] / (np.linalg.norm(pos[i]) + 1e-12)
        left = np.cross(up, fwd)
        left /= np.linalg.norm(left) + 1e-12
        fwd2 = np.cross(left, up)
        Rs.append(np.stack([fwd2, left, up], axis=1))
    return np.stack(Rs), pos


def make_sphere_graph(n_poses: int = 2500, edges_per_pose: float = 4.0,
                      meas_noise: float = 0.02, init_noise: float = 0.1,
                      seed: int = 0, *, dtype=torch.float32, device=None,
                      bucket: int = 256):
    """Build (graph, values, gt) for the sphere stress benchmark, on the
    CUDA card unless ``device`` names another."""
    device = resolve(device)
    r = np.random.default_rng(seed)
    Rs, ts = sphere_ground_truth(n_poses)

    def between(i, j):
        return Rs[i].T @ Rs[j], Rs[i].T @ (ts[j] - ts[i])

    b = GraphBuilder()
    for i in range(n_poses):
        if i == 0 or init_noise == 0:
            b.add_pose((Rs[i], ts[i]))
        else:
            dR = _so3_exp(r.normal(size=3) * init_noise * 0.3)
            b.add_pose((Rs[i] @ dR, ts[i] + r.normal(size=3) * init_noise))
    b.add_prior_pose(0, (Rs[0], ts[0]), sigmas=np.full(6, 1e-6))

    info = np.diag([100.0, 100.0, 100.0, 25.0, 25.0, 25.0])

    def noisy(Rij, tij):
        dR = _so3_exp(r.normal(size=3) * meas_noise * 0.3)
        return Rij @ dR, tij + r.normal(size=3) * meas_noise

    for i in range(n_poses - 1):
        b.add_between(i, i + 1, noisy(*between(i, i + 1)), information=info)

    n_extra = int((edges_per_pose - 1.0) * n_poses)
    # short-range loop closures: nodes nearby in space (same sphere band)
    cand_i = r.integers(0, n_poses - 1, size=3 * n_extra)
    cand_j = cand_i + r.integers(2, 50, size=3 * n_extra)
    keep = cand_j < n_poses
    cand_i, cand_j = cand_i[keep][:n_extra], cand_j[keep][:n_extra]
    for i, j in zip(cand_i, cand_j):
        b.add_between(int(i), int(j), noisy(*between(int(i), int(j))),
                      information=info)

    graph, values = b.build(bucket=bucket, device=device, dtype=dtype)
    return graph, values, (Rs, ts)


def make_ba_graph(n_poses: int = 100, n_points: int = 10000,
                  obs_per_point: int = 4, pixel_noise: float = 0.5,
                  init_noise: float = 0.05, seed: int = 0, *,
                  dtype=torch.float32, device=None, bucket: int = 256,
                  cal=None):
    """Bundle-adjustment stress problem: cameras on an arc looking at a point
    cloud, each landmark observed from ``obs_per_point`` nearby cameras
    through a Cal3DS2 projection (``cal``, default the SR4000), a pose prior
    on camera 0 and a point prior on every landmark. On the CUDA card unless
    ``device`` names another. Returns (graph, values, (gt (Rs, ts),
    gt_points)).

    Draws as the reference does: one (3,) normal per landmark in landmark
    order equals one (n_points, 3) draw, so the landmarks' noise is drawn
    at once.
    """
    from ..config import SR4000

    device = resolve(device)
    cal = cal or SR4000
    r = np.random.default_rng(seed)

    def project_np(local):
        z = np.maximum(local[:, 2], 1e-6)
        x = local[:, 0] / z
        y = local[:, 1] / z
        r2 = x * x + y * y
        g = 1.0 + cal.k1 * r2 + cal.k2 * r2 * r2
        dx = 2 * cal.p1 * x * y + cal.p2 * (r2 + 2 * x * x)
        dy = 2 * cal.p2 * x * y + cal.p1 * (r2 + 2 * y * y)
        px = g * x + dx
        py = g * y + dy
        return np.stack([cal.fx * px + cal.cx, cal.fy * py + cal.cy], axis=1)

    Rs, ts = [], []
    for k in range(n_poses):
        ang = 0.5 * np.sin(2 * np.pi * k / n_poses)
        Rs.append(_so3_exp(np.array([0.0, ang, 0.0])))
        ts.append(np.array([2.0 * k / n_poses,
                            0.1 * np.sin(4 * np.pi * k / n_poses), 0.0]))
    pts = np.stack([r.uniform(-2, 4, n_points), r.uniform(-2, 2, n_points),
                    r.uniform(3.0, 8.0, n_points)], axis=1)

    b = GraphBuilder()
    for k in range(n_poses):
        if k == 0 or init_noise == 0:
            b.add_pose((Rs[k], ts[k]))
        else:
            dR = _so3_exp(r.normal(size=3) * init_noise * 0.3)
            b.add_pose((Rs[k] @ dR, ts[k] + r.normal(size=3) * init_noise))
    b.add_prior_pose(0, (Rs[0], ts[0]), sigmas=np.full(6, 1e-6))

    b._add_points(pts + r.normal(size=(n_points, 3)) * init_noise)
    b._add_rows("prior_point", n_points, idx=np.arange(n_points), mean=pts,
                sqrt_info=np.broadcast_to(np.eye(3) / 0.1, (n_points, 3, 3)))

    anchors = r.integers(0, n_poses, size=n_points)
    Rs_a = np.stack(Rs)
    ts_a = np.stack(ts)
    cal9 = np.array([cal.fx, cal.fy, 0.0, cal.cx, cal.cy, cal.k1, cal.k2,
                     cal.p1, cal.p2])
    for o in range(obs_per_point):
        cams = (anchors + o * 3) % n_poses
        local = np.einsum("qji,qj->qi", Rs_a[cams], pts - ts_a[cams])
        vis = local[:, 2] >= 0.3
        uv = project_np(local) + r.normal(size=(n_points, 2)) * pixel_noise
        q = np.flatnonzero(vis)
        n = q.shape[0]
        b._add_rows("projection", n, pose_idx=cams[q], point_idx=q,
                    uv=uv[q], cal=np.broadcast_to(cal9, (n, 9)),
                    body_R=np.broadcast_to(np.eye(3), (n, 3, 3)),
                    body_t=np.zeros((n, 3)),
                    sqrt_info=np.broadcast_to(np.eye(2), (n, 2, 2)))

    graph, values = b.build(bucket=bucket, device=device, dtype=dtype)
    return graph, values, ((Rs, ts), pts)


def _render_plane_frame(K, R_cam, t_cam, scene, noise=0.0, seed=0):
    """Ray-cast depth+intensity of a set of world planes from a camera pose.

    ``scene`` is [(plane4_world, intensity_value), ...] with plane form
    ``n . x + d = 0``; the camera pose is world-from-camera (R, t). Returns
    float32 numpy (intensity, depth), depth 0 where no plane is hit.
    """
    r = np.random.default_rng(seed)
    h, w = K.height, K.width
    us, vs = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    rays = np.stack([(us - K.cx) / K.fx, (vs - K.cy) / K.fy,
                     np.ones_like(us)], axis=-1)          # (H, W, 3)
    depth = np.full((h, w), np.inf)
    inten = np.zeros((h, w), np.float32)
    for plane_w, value in scene:
        n, d = np.asarray(plane_w[:3]), float(plane_w[3])
        # plane in the camera frame: n_c = R^T n, d_c = d + n . t
        n_c = R_cam.T @ n
        d_c = d + n @ t_cam
        denom = rays @ n_c
        safe = np.where(np.abs(denom) > 1e-9, denom, 1.0)
        z = np.where(np.abs(denom) > 1e-9, -d_c / safe, np.inf)
        hit = (z > 0.2) & (z < depth)
        depth = np.where(hit, z, depth)
        inten = np.where(hit, value, inten)
    depth = np.where(np.isfinite(depth), depth, 0.0)
    if noise:
        depth = depth + r.normal(size=depth.shape) * noise * (depth > 0)
    return inten.astype(np.float32), depth.astype(np.float32)


def _so3_exp_batch(w):
    """Batched numpy Rodrigues with the reference's small-angle guard."""
    th2 = np.sum(w * w, axis=-1)
    big = th2 > 1e-10
    th = np.sqrt(np.where(big, th2, 1.0))
    a = np.where(big, np.sin(th) / th, 1.0 - th2 / 6.0)
    b = np.where(big, 2.0 * np.sin(0.5 * th) ** 2 / th2, 0.5 - th2 / 24.0)
    z = np.zeros_like(w[..., 0])
    W = np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                  np.stack([w[..., 2], z, -w[..., 0]], -1),
                  np.stack([-w[..., 1], w[..., 0], z], -1)], -2)
    return np.eye(3) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def make_vio_plane_scenario(n_frames: int = 200, per: int = 20,
                            fail_every: int = 20, seed: int = 0,
                            motion: float = 0.08, noise: float = 0.002,
                            render: bool = True, return_gt: bool = False, *,
                            device=None):
    """Plane-aided VIO benchmark workload: IMU stream + VRO log with
    periodic tracking failures + rendered SR4000 frames of a two-plane
    room (wall z=4, floor y=0.8).

    The VO log carries exact relative poses except the failed records
    (info sentinel 1e4). The ground truth integrates the synthetic IMU
    windows with the port's preintegration, in float64 on the CPU: a long
    float32 attitude/velocity chain diverges. Only the returned
    ``ImuParams`` live on ``device`` (``None``: the CUDA card).

    Returns ``(log, times, stream, imu_params, frames, K)`` where
    ``frames`` is a ``seq -> (intensity, depth)`` dict, a lazy callable
    (``render="lazy"``) or None (``render=False``). With ``return_gt=True``
    the exact per-frame ground-truth poses ``(Rs (N,3,3), ts (N,3))`` are
    appended.
    """
    from ..config import SR4000
    from ..core import se3
    from ..imu import (ImuStream, init_preint, integrate_segment,
                       predict_navstate, vn100_params)
    from ..imu.preintegration import PreintState
    from ..io.vro_log import FAILED_INFO_SENTINEL, VROLog

    params = vn100_params(device=device)
    cpu = vn100_params(device="cpu")
    K = SR4000
    dt = 1.0 / 200.0
    n_meas = n_frames * per + 10
    r = np.random.default_rng(seed)
    gyr = r.normal(size=(n_meas, 3)) * (motion * 0.25)
    drive = r.normal(size=(n_meas, 3)) * motion
    for k in range(1, n_meas):
        gyr[k] = 0.9 * gyr[k - 1] + 0.1 * gyr[k]
        drive[k] = 0.9 * drive[k - 1] + 0.1 * drive[k]

    # gravity-consistent accelerometer: rotate gravity into the current
    # body frame and drive a mean-reverting world velocity, so the
    # trajectory stays room-scale and the specific force matches the
    # integrated attitude
    g_w = cpu.gravity.numpy()
    E = _so3_exp_batch(gyr * dt)
    acc = np.empty((n_meas, 3))
    R, v = np.eye(3), np.zeros(3)
    for k in range(n_meas):
        R = R @ E[k]
        v_new = 0.999 * v + drive[k] * dt
        acc[k] = R.T @ ((v_new - v) / dt - g_w)
        v = v_new
    stream = ImuStream(t=np.arange(n_meas) * dt, acc=acc, gyr=gyr, dt=dt)

    # ground-truth chain: every frame's window preintegrated (batched),
    # then the NavState predictions one frame after another
    m = n_frames - 1
    acc_w = torch.as_tensor(acc[:m * per].reshape(m, per, 3))
    gyr_w = torch.as_tensor(gyr[:m * per].reshape(m, per, 3))
    f64 = torch.float64
    parts = []
    for lo in range(0, m, 2048):
        hi = min(m, lo + 2048)
        st0 = init_preint(torch.zeros(hi - lo, 6, dtype=f64), cpu,
                          device="cpu")
        parts.append(integrate_segment(
            st0, acc_w[lo:hi], gyr_w[lo:hi],
            torch.full((hi - lo, per), dt, dtype=f64), cpu))
    st = PreintState(*(torch.cat(x) for x in zip(*parts))) if parts else None
    Rs = np.empty((n_frames, 3, 3))
    ts = np.empty((n_frames, 3))
    X = se3.Pose(torch.eye(3, dtype=f64), torch.zeros(3, dtype=f64))
    vel = torch.zeros(3, dtype=f64)
    Rs[0], ts[0] = np.eye(3), np.zeros(3)
    for f in range(1, n_frames):
        X, vel = predict_navstate(PreintState(*(x[f - 1] for x in st)), X,
                                  vel, torch.zeros(6, dtype=f64), cpu.gravity)
        Rs[f], ts[f] = X.R.numpy(), X.t.numpy()

    scene = [(np.array([0.0, 0.0, 1.0, -4.0]), 150.0),
             (np.array([0.0, 1.0, 0.0, -0.8]), 80.0)]
    frames = None
    if render == "lazy":
        # render on demand with a small cache
        cache: dict = {}

        def frames(f):
            if not (0 <= f < n_frames):
                return None
            if f not in cache:
                if len(cache) > 128:
                    cache.clear()
                cache[f] = _render_plane_frame(K, Rs[f], ts[f], scene,
                                               noise=noise, seed=seed + f)
            return cache[f]
    elif render:
        frames = {f: _render_plane_frame(K, Rs[f], ts[f], scene,
                                         noise=noise, seed=seed + f)
                  for f in range(n_frames)}

    info = np.diag([8e3] * 3 + [2500.0] * 3)
    f_all = np.arange(1, n_frames)
    failed = (f_all % fail_every == 0) if fail_every else \
        np.zeros(m, bool)
    xis = np.zeros((m, 6))
    infos = np.tile(info, (m, 1, 1))
    infos[failed] = np.eye(6) * FAILED_INFO_SENTINEL
    ok = f_all[~failed]
    if len(ok):
        Rt = torch.as_tensor
        xis[~failed] = se3.logmap(se3.between(
            se3.Pose(Rt(Rs[ok - 1]), Rt(ts[ok - 1])),
            se3.Pose(Rt(Rs[ok]), Rt(ts[ok])))).numpy()
    log = VROLog(f_all, f_all - 1, xis, infos)
    times = {f: f * per * dt for f in range(n_frames)}
    if return_gt:
        return log, times, stream, params, frames, K, (Rs, ts)
    return log, times, stream, params, frames, K
