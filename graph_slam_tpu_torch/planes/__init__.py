"""Plane stack of the port (``graph_slam_tpu/planes`` counterpart): the
OrientedPlane3 manifold, LS plane fitting, the rescue propagation and its
region-grow kernel."""

from . import oriented_plane
from .extraction import fit_plane_lsq, plane_tangent_cov, point_plane_dist
from .propagation import (PropagationResult, propagate_plane,
                          propagate_planes, propagated_distance_variance)
from .region_grow import region_grow, region_grow_torch

__all__ = ["oriented_plane", "fit_plane_lsq", "plane_tangent_cov",
           "point_plane_dist", "PropagationResult", "propagate_plane",
           "propagate_planes", "propagated_distance_variance", "region_grow",
           "region_grow_torch"]
