"""Synthetic data of the port (``graph_slam_tpu/datasets`` counterpart)."""

from .synthetic import (make_ba_graph, make_sphere_graph,
                        make_vio_plane_scenario, sphere_ground_truth)

__all__ = ["make_sphere_graph", "sphere_ground_truth", "make_ba_graph",
           "make_vio_plane_scenario"]
