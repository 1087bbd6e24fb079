"""Incremental 3D reconstruction playback (map_video / map_video_mtraj twin;
port of ``graph_slam_tpu/mapping/video.py``).

The reference's ``mapping/map_video*.cpp`` replay a trajectory, accumulate a
voxel-filtered cloud, overlay the trajectory polyline, and record a
camera-follow animation with VTK. Headless equivalent: an incremental map
builder that emits periodic snapshots (cloud + trajectory polyline + a
follow-camera pose per frame) to PLY files — the same artifacts, viewable
in any point-cloud viewer, no GUI dependency. Each frame is backprojected
and moved on ``device`` (``None``: the CUDA card); the cloud is kept and
voxel-filtered on the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import CameraIntrinsics
from ..core import se3
from ..device import resolve, to_host
from ..io.trajectory import Trajectory, write_ply_points
from .pointcloud import _traj_pose, _world_cloud, voxel_filter

__all__ = ["incremental_map_video", "follow_camera_pose"]


def follow_camera_pose(pose: se3.Pose, back: float = 2.0, up: float = 1.0):
    """Camera-follow viewpoint behind/above the current pose (the VTK
    camera animation's key pose)."""
    offset = torch.tensor([-back, 0.0, up], dtype=pose.t.dtype,
                          device=pose.t.device)
    return to_host((se3.transform_from(pose, offset), pose.t))


def incremental_map_video(trajs, frames, K: CameraIntrinsics, out_dir: str,
                          u2c: se3.Pose | None = None, every: int = 5,
                          skip: int = 3, voxel: float = 0.05,
                          traj_colors=((255, 40, 40), (40, 255, 40),
                                       (60, 60, 255)), *, device=None):
    """Replay one or more trajectories, writing snapshot PLYs.

    ``trajs``: a Trajectory or list of Trajectory (mtraj overlay variant).
    ``frames``: callable seq_id -> (intensity, depth) or None (only applied
    to the first trajectory, like the reference).
    Returns the list of snapshot paths.
    """
    dev = resolve(device)
    if isinstance(trajs, Trajectory):
        trajs = [trajs]
    os.makedirs(out_dir, exist_ok=True)
    main = trajs[0]
    cloud_pts = np.zeros((0, 3))
    cloud_cols = np.zeros((0, 3), np.uint8)
    snaps = []
    cams = []

    for k in range(len(main.ids)):
        got = frames(int(main.seq[k])) if frames is not None else None
        pose = _traj_pose(main, k, None, dev)
        if got is not None:
            pw = pose if u2c is None else _traj_pose(main, k, u2c, dev)
            pts, cols = _world_cloud(K, got, pw, skip)
            cloud_pts = np.concatenate([cloud_pts, pts])
            cloud_cols = np.concatenate([cloud_cols, cols])
            cloud_pts, cloud_cols = voxel_filter(cloud_pts, cloud_cols, voxel)
        cams.append(follow_camera_pose(pose))

        if k % every == 0 or k == len(main.ids) - 1:
            pts_out = [cloud_pts]
            cols_out = [cloud_cols]
            # overlay trajectory polylines up to the current frame
            for ti, tr in enumerate(trajs):
                upto = min(k + 1, len(tr.ids))
                pts_out.append(np.asarray(tr.t[:upto]))
                cols_out.append(np.tile(
                    np.asarray(traj_colors[ti % len(traj_colors)], np.uint8),
                    (upto, 1)))
            path = os.path.join(out_dir, f"frame_{k:05d}.ply")
            write_ply_points(path, np.concatenate(pts_out),
                             np.concatenate(cols_out))
            snaps.append(path)

    np.savetxt(os.path.join(out_dir, "camera_path.txt"),
               np.asarray([np.concatenate(c) for c in cams]))
    return snaps
