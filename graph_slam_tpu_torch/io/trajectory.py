"""Trajectory / PLY / g2o writers and readers — a copy of
``graph_slam_tpu/io/trajectory.py`` (numpy only).

Copied rather than imported: importing ``graph_slam_tpu.io`` runs
``graph_slam_tpu/__init__.py``, which imports jax. ``read_trajectory`` and
``write_ply_points`` go through the native runtime (``native.parse_table``,
``native.write_cloud_ascii``) when it is built, with the reference's
pure-Python loops as the fallback.

- trajectory log lines: ``id x y z qx qy qz qw sid`` — written by
  ``CGraphGT::writeTrajectory`` and re-read by every mapping tool. The
  quaternion is printed x y z w (Eigen order) while it is stored w x y z.
- colored ASCII PLY point/trajectory files (``trajectoryPLY`` +
  ``headerPLY``).
- g2o text format (``writeG2O``): VERTEX_SE3:QUAT and EDGE_SE3:QUAT lines.
- per-pose marginal covariances and a human-readable graph summary.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Trajectory",
    "TrajEntry",
    "write_trajectory",
    "read_trajectory",
    "write_ply_points",
    "write_trajectory_ply",
    "write_g2o",
    "read_g2o",
    "write_marginals",
    "read_marginals",
    "write_graph_summary",
]


@dataclasses.dataclass
class Trajectory:
    ids: np.ndarray   # (N,) int graph ids
    t: np.ndarray     # (N, 3) positions
    quat: np.ndarray  # (N, 4) (w, x, y, z)
    seq: np.ndarray   # (N,) int sequence ids


TrajEntry = Trajectory  # alias


def write_trajectory(path: str, ids, t, quat_wxyz, seq) -> None:
    """``id x y z qx qy qz qw sid`` lines (quat stored wxyz, printed xyzw)."""
    t = np.asarray(t)
    q = np.asarray(quat_wxyz)
    with open(path, "w") as f:
        for k in range(len(ids)):
            f.write(
                f"{int(ids[k])} {float(t[k,0])!r} {float(t[k,1])!r} "
                f"{float(t[k,2])!r} {float(q[k,1])!r} {float(q[k,2])!r} "
                f"{float(q[k,3])!r} {float(q[k,0])!r} {int(seq[k])}\n"
            )


def read_trajectory(path: str) -> Trajectory:
    """``id x y z qx qy qz qw sid`` lines (readTraj); lines with fewer
    than nine numbers are skipped."""
    from .. import native

    data = native.parse_table(path, 9)
    if data is not None:
        q = data[:, 4:8]
        return Trajectory(data[:, 0].astype(int), data[:, 1:4],
                          q[:, [3, 0, 1, 2]], data[:, 8].astype(int))
    ids, ts, qs, seqs = [], [], [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if len(tok) < 9:
                continue
            ids.append(int(float(tok[0])))
            ts.append([float(x) for x in tok[1:4]])
            qx, qy, qz, qw = (float(x) for x in tok[4:8])
            qs.append([qw, qx, qy, qz])
            seqs.append(int(float(tok[8])))
    return Trajectory(np.asarray(ids), np.asarray(ts), np.asarray(qs),
                      np.asarray(seqs))


def _ply_header(n: int) -> str:
    return (
        "ply\nformat ascii 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )


def write_ply_points(path: str, points, colors) -> None:
    """Colored ASCII PLY; ``colors`` is (N, 3) uint8 or a single RGB
    triple."""
    points = np.asarray(points)
    colors = np.asarray(colors)
    if colors.ndim == 1:
        colors = np.broadcast_to(colors, (len(points), 3))
    from .. import native

    if native.write_cloud_ascii(path, _ply_header(len(points)), points,
                                colors, mode=2):
        return
    with open(path, "w") as f:
        f.write(_ply_header(len(points)))
        for p, c in zip(points, colors):
            f.write(f"{float(p[0])!r} {float(p[1])!r} {float(p[2])!r} "
                    f"{int(c[0])} {int(c[1])} {int(c[2])}\n")


def write_trajectory_ply(path: str, t, color=(255, 0, 0)) -> None:
    write_ply_points(path, t, np.asarray(color))


def write_g2o(path: str, t, quat_wxyz, edges) -> None:
    """g2o text graph: vertices + EDGE_SE3:QUAT with upper-triangular info.

    ``edges`` is an iterable of (i, j, t_ij (3,), q_ij (wxyz 4,), info (6,6)).
    """
    t = np.asarray(t)
    q = np.asarray(quat_wxyz)
    iu = np.triu_indices(6)
    with open(path, "w") as f:
        for k in range(len(t)):
            f.write(
                f"VERTEX_SE3:QUAT {k} {float(t[k,0])!r} {float(t[k,1])!r} "
                f"{float(t[k,2])!r} {float(q[k,1])!r} {float(q[k,2])!r} "
                f"{float(q[k,3])!r} {float(q[k,0])!r}\n"
            )
        for (i, j, tij, qij, info) in edges:
            info = np.asarray(info)
            vals = " ".join(repr(float(v)) for v in info[iu])
            f.write(
                f"EDGE_SE3:QUAT {int(i)} {int(j)} "
                f"{float(tij[0])!r} {float(tij[1])!r} {float(tij[2])!r} "
                f"{float(qij[1])!r} {float(qij[2])!r} {float(qij[3])!r} "
                f"{float(qij[0])!r} {vals}\n"
            )


def read_g2o(path: str):
    """Parse VERTEX_SE3:QUAT / EDGE_SE3:QUAT lines.

    Returns (vertices, edges): vertices dict id -> (t (3,), q (wxyz)),
    edges list of (i, j, t, q_wxyz, info6x6).
    """
    vertices = {}
    edges = []
    iu = np.triu_indices(6)
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "VERTEX_SE3:QUAT":
                vid = int(tok[1])
                t = np.array([float(x) for x in tok[2:5]])
                qx, qy, qz, qw = (float(x) for x in tok[5:9])
                vertices[vid] = (t, np.array([qw, qx, qy, qz]))
            elif tok[0] == "EDGE_SE3:QUAT":
                i, j = int(tok[1]), int(tok[2])
                t = np.array([float(x) for x in tok[3:6]])
                qx, qy, qz, qw = (float(x) for x in tok[6:10])
                vals = np.array([float(x) for x in tok[10:31]])
                info = np.zeros((6, 6))
                info[iu] = vals
                info = info + info.T - np.diag(np.diag(info))
                edges.append((i, j, t, np.array([qw, qx, qy, qz]), info))
    return vertices, edges


def write_marginals(path: str, ids, covs) -> None:
    """Per-pose marginal covariances: ``id`` + the 21 upper-triangular
    entries of the 6x6 covariance per line (the same upper-tri packing as
    the VRO log's information rows, gtsam_graph.cpp:1574-1590)."""
    covs = np.asarray(covs)
    iu = np.triu_indices(6)
    with open(path, "w") as f:
        for k in range(len(ids)):
            vals = " ".join(repr(float(x)) for x in covs[k][iu])
            f.write(f"{int(ids[k])} {vals}\n")


def read_marginals(path: str):
    """Inverse of ``write_marginals`` -> (ids (N,), covs (N, 6, 6))."""
    ids, covs = [], []
    iu = np.triu_indices(6)
    with open(path) as f:
        for line in f:
            tok = line.split()
            if len(tok) < 22:
                continue
            ids.append(int(float(tok[0])))
            C = np.zeros((6, 6))
            C[iu] = [float(x) for x in tok[1:22]]
            covs.append(C + C.T - np.diag(np.diag(C)))
    return np.asarray(ids), np.asarray(covs)


def write_graph_summary(path: str, graph, values) -> None:
    """Human-readable factor-graph dump (``CGraphGT::writeGTSAM`` role,
    gtsam_graph.cpp:160-171): per-table active counts and rows."""
    def host(tab):
        return type(tab)(*(np.asarray(x.detach().cpu() if hasattr(
            x, "detach") else x) for x in tab))

    def rows(name, tab, fmt):
        act = np.asarray(tab.active)
        lines = [f"# {name}: {int(act.sum())} active / {act.shape[0]} "
                 "capacity"]
        for k in np.nonzero(act)[0]:
            lines.append(fmt(int(k)))
        return lines

    out = []
    g = type(graph)(*(host(tab) for tab in graph))
    if g.prior_pose.idx.shape[0]:
        out += rows("PriorFactor<Pose3>", g.prior_pose,
                    lambda k: f"prior_pose X({int(g.prior_pose.idx[k])})")
    if g.between.i.shape[0]:
        out += rows("BetweenFactor<Pose3>", g.between,
                    lambda k: f"between X({int(g.between.i[k])}) "
                              f"-> X({int(g.between.j[k])})")
    if g.prior_vel.idx.shape[0]:
        out += rows("PriorFactor<Vector3>", g.prior_vel,
                    lambda k: f"prior_vel V({int(g.prior_vel.idx[k])})")
    if g.prior_bias.idx.shape[0]:
        out += rows("PriorFactor<Bias>", g.prior_bias,
                    lambda k: f"prior_bias B({int(g.prior_bias.idx[k])})")
    if g.plane.pose_idx.shape[0]:
        out += rows("OrientedPlane3Factor", g.plane,
                    lambda k: f"plane X({int(g.plane.pose_idx[k])}) "
                              f"-> L({int(g.plane.plane_idx[k])})")
    if g.imu.i.shape[0]:
        out += rows("CombinedImuFactor", g.imu,
                    lambda k: f"imu (X,V,B)({int(g.imu.i[k])}) -> "
                              f"(X,V,B)({int(g.imu.j[k])})")
    if g.projection.pose_idx.shape[0]:
        out += rows("GenericProjectionFactor", g.projection,
                    lambda k: f"proj X({int(g.projection.pose_idx[k])}) "
                              f"-> Q({int(g.projection.point_idx[k])})")
    if g.prior_point.idx.shape[0]:
        out += rows("PriorFactor<Point3>", g.prior_point,
                    lambda k: f"prior_point Q({int(g.prior_point.idx[k])})")
    out.append(f"# variables: poses={int(values.num_poses)} "
               f"vels={int(values.num_vels)} biases={int(values.num_biases)} "
               f"planes={int(values.num_planes)} "
               f"points={int(values.num_points)}")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
