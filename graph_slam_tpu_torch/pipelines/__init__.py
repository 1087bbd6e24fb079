"""Offline pipelines of the port (``graph_slam_tpu/pipelines`` counterpart)."""

from .ba_imu import (BaImuConfig, BaImuResult, features_from_store,
                     run_ba_imu)
from .online_slam import FrameStatus, OnlineSlam
from .posegraph import (PoseGraphResult, build_graph_from_g2o,
                        build_pose_graph, run_g2o_file, run_pose_graph,
                        trajectory_arrays)
from .vio import VioConfig, VioResult, run_vio

__all__ = ["PoseGraphResult", "build_pose_graph", "run_pose_graph",
           "build_graph_from_g2o", "run_g2o_file", "trajectory_arrays",
           "VioConfig", "VioResult", "run_vio",
           "BaImuConfig", "BaImuResult", "run_ba_imu",
           "features_from_store", "OnlineSlam", "FrameStatus"]
