"""Lie-group cores of the port (``graph_slam_tpu/core`` counterpart)."""

from . import extrinsics, se3, so3
from .se3 import Pose

__all__ = ["extrinsics", "se3", "so3", "Pose"]
