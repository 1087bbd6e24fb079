"""Global map generation from trajectory logs + RGB-D frames (port of
``graph_slam_tpu/mapping/pointcloud.py``).

Twins of the ``mapping/`` tools (SURVEY.md §2.5):
- ``mapping_PCD.cpp`` / ``mapping_PLY.cpp``: trajectory (``id x y z qx qy
  qz qw sid``) + image dir -> global colored cloud, written as PCD or PLY;
- the rs variants' voxel-grid and passthrough filtering
  (``mapping_PCD_rs.cpp``);
- ``pcd_filter.cpp``: z-passthrough floor removal + cluster-style denoise
  (here: voxel-occupancy denoise).

Each frame is backprojected and moved to the world on ``device`` (``None``:
the CUDA card) and comes back to the host in one copy, as the reference's
``np.asarray`` brings it. The filters are numpy copies (``np.unique`` on
the host, as in the reference), and file IO stays on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import CameraIntrinsics
from ..core import se3, so3
from ..device import resolve, to_host
from ..io.trajectory import Trajectory, write_ply_points
from ..vision.camera import cloud_from_images

__all__ = ["accumulate_cloud", "voxel_filter", "passthrough",
           "write_pcd", "read_pcd", "occupancy_denoise", "map_from_frames"]


def _traj_pose(traj: Trajectory, k: int, u2c: se3.Pose | None, device):
    """Row ``k`` of ``traj`` as a float64 Pose on ``device``, moved into the
    camera frame by ``u2c`` when given (``Pw2c = Pw2j * Pu2c``)."""
    R = so3.quat_to_matrix(torch.as_tensor(np.asarray(traj.quat[k]),
                                           dtype=torch.float64,
                                           device=device))
    pose = se3.Pose(R, torch.as_tensor(np.asarray(traj.t[k]),
                                       dtype=torch.float64, device=device))
    if u2c is not None:
        pose = se3.compose(pose, se3.Pose(*(x.to(device) for x in u2c)))
    return pose


def _world_cloud(K: CameraIntrinsics, frame, pose: se3.Pose, skip: int,
                 z_min: float = 0.05, z_max: float = 10.0):
    """One frame's valid points moved to the world by ``pose`` and their
    gray colors, on the host: ``(points (N, 3) f64, colors (N, 3) u8)``."""
    inten, depth = frame
    pts, cols, valid = cloud_from_images(K, inten, depth, skip=skip,
                                         z_min=z_min, z_max=z_max,
                                         device=pose.t.device)
    world = se3.transform_from(pose, pts.to(pose.t.dtype))
    world, cols, m = to_host((world, cols, valid))
    return world[m], np.clip(cols[m], 0, 255).astype(np.uint8)


def accumulate_cloud(traj: Trajectory, frames, K: CameraIntrinsics,
                     u2c: se3.Pose | None = None, stride: int = 1,
                     skip: int = 2, z_min: float = 0.05,
                     z_max: float = 10.0, *, device=None):
    """Build the global cloud: for every ``stride``-th pose, backproject the
    frame and transform to world (``mapPCD`` loop, mapping_PCD.cpp:86-167).

    ``frames``: callable seq_id -> (intensity, depth_meters) or None to skip.
    Returns (points (N,3), colors (N,3) uint8) numpy arrays.
    """
    dev = resolve(device)
    all_pts, all_cols = [], []
    for k in range(0, len(traj.ids), stride):
        got = frames(int(traj.seq[k]))
        if got is None:
            continue
        pts, cols = _world_cloud(K, got, _traj_pose(traj, k, u2c, dev),
                                 skip, z_min, z_max)
        all_pts.append(pts)
        all_cols.append(cols)
    if not all_pts:
        return np.zeros((0, 3)), np.zeros((0, 3), np.uint8)
    return np.concatenate(all_pts), np.concatenate(all_cols)


def voxel_filter(points, colors=None, voxel: float = 0.02):
    """Voxel-grid downsample (pcl::VoxelGrid role): one point per voxel."""
    points = np.asarray(points)
    keys = np.floor(points / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    idx.sort()
    if colors is None:
        return points[idx]
    return points[idx], np.asarray(colors)[idx]


def passthrough(points, colors=None, axis: int = 2, lo: float = -np.inf,
                hi: float = np.inf):
    """Axis range filter (pcl::PassThrough role, floor removal)."""
    points = np.asarray(points)
    m = (points[:, axis] >= lo) & (points[:, axis] <= hi)
    if colors is None:
        return points[m]
    return points[m], np.asarray(colors)[m]


def occupancy_denoise(points, colors=None, voxel: float = 0.05,
                      min_neighbors: int = 3):
    """Drop points whose voxel has too few occupants (cluster-denoise role
    of pcd_filter.cpp)."""
    points = np.asarray(points)
    keys = np.floor(points / voxel).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    m = counts[inv] >= min_neighbors
    if colors is None:
        return points[m]
    return points[m], np.asarray(colors)[m]


def write_pcd(path: str, points, colors=None) -> None:
    """ASCII PCD v0.7 writer (pcl::io::savePCDFile role).

    Body rows go through the native runtime (``native.write_cloud_ascii``,
    buffered fprintf) with this Python loop as the fallback.
    """
    points = np.asarray(points)
    n = len(points)
    header = "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
    if colors is not None:
        header += ("FIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F U\n"
                   "COUNT 1 1 1 1\n")
    else:
        header += "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
    header += (f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
               f"POINTS {n}\nDATA ascii\n")
    from .. import native

    if native.write_cloud_ascii(path, header, points, colors,
                                mode=1 if colors is not None else 0):
        return
    with open(path, "w") as f:
        f.write(header)
        if colors is not None:
            cols = np.asarray(colors).astype(np.uint32)
            rgb = (cols[:, 0] << 16) | (cols[:, 1] << 8) | cols[:, 2]
            for p, c in zip(points, rgb):
                f.write(f"{float(p[0])!r} {float(p[1])!r} {float(p[2])!r} "
                        f"{int(c)}\n")
        else:
            for p in points:
                f.write(f"{float(p[0])!r} {float(p[1])!r} {float(p[2])!r}\n")


def read_pcd(path: str):
    """ASCII PCD reader; returns (points, colors-or-None)."""
    pts, rgb = [], []
    has_rgb = False
    with open(path) as f:
        in_data = False
        for line in f:
            if in_data:
                tok = line.split()
                pts.append([float(tok[0]), float(tok[1]), float(tok[2])])
                if has_rgb and len(tok) > 3:
                    v = int(float(tok[3]))
                    rgb.append([(v >> 16) & 255, (v >> 8) & 255, v & 255])
            elif line.startswith("FIELDS"):
                has_rgb = "rgb" in line
            elif line.startswith("DATA"):
                in_data = True
    pts = np.asarray(pts)
    return pts, (np.asarray(rgb, np.uint8) if rgb else None)


def map_from_frames(traj: Trajectory, frames, K: CameraIntrinsics,
                    out_path: str, fmt: str = "pcd",
                    u2c: se3.Pose | None = None, stride: int = 1,
                    skip: int = 2, voxel: float | None = None, *,
                    device=None):
    """mapping_PCD / mapping_PLY main: accumulate, optionally voxel-filter,
    write."""
    pts, cols = accumulate_cloud(traj, frames, K, u2c=u2c, stride=stride,
                                 skip=skip, device=device)
    if voxel:
        pts, cols = voxel_filter(pts, cols, voxel)
    if fmt == "pcd":
        write_pcd(out_path, pts, cols)
    else:
        write_ply_points(out_path, pts, cols)
    return pts, cols
