"""Offline pipelines of the port (``graph_slam_tpu/pipelines`` counterpart)."""

from .posegraph import (PoseGraphResult, build_pose_graph, run_pose_graph,
                        trajectory_arrays)

__all__ = ["PoseGraphResult", "build_pose_graph", "run_pose_graph",
           "trajectory_arrays"]
