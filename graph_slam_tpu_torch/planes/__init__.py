"""Plane stack of the port (``graph_slam_tpu/planes`` counterpart): the
OrientedPlane3 manifold, plane fitting and RANSAC extraction, landmark
association, the PSD repair, the rescue propagation with its region-grow
kernel, and the node-level plane prediction."""

from . import oriented_plane
from .association import (PlaneLandmarkBook, match_plane, plane_to_world,
                          transform_plane_cov)
from .extraction import (PlaneDetection, extract_planes, fit_plane_lsq,
                         hypothesis_uniforms, plane_tangent_cov,
                         point_plane_dist)
from .plane_node import (PlaneNodeDetection, extract_plane_node,
                         extract_plane_nodes_batch, predict_plane_node,
                         predict_plane_node_finish, predict_plane_node_start)
from .propagation import (PropagationResult, propagate_plane,
                          propagate_planes, propagated_distance_variance)
from .psd import inflate_if_uncertain, repair_plane_cov
from .region_grow import region_grow, region_grow_torch

__all__ = ["oriented_plane", "PlaneLandmarkBook", "match_plane",
           "plane_to_world", "transform_plane_cov", "PlaneDetection",
           "extract_planes", "fit_plane_lsq", "hypothesis_uniforms",
           "plane_tangent_cov", "point_plane_dist", "PlaneNodeDetection",
           "extract_plane_node", "extract_plane_nodes_batch",
           "predict_plane_node", "predict_plane_node_finish",
           "predict_plane_node_start",
           "PropagationResult", "propagate_plane", "propagate_planes",
           "propagated_distance_variance", "inflate_if_uncertain",
           "repair_plane_cov", "region_grow", "region_grow_torch"]
