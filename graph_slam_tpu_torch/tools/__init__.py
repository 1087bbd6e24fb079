"""VRO-log tools of the port (``graph_slam_tpu/tools`` counterpart)."""

from .vro_tools import (
    add_vo_at_sparse_area,
    make_frame_matcher,
    compute_trans_difference,
    convert_vo2ba,
    delete_vo_by_plane_check,
    merge_vro,
    propose_sparse_area_edges,
    void_edge,
)

__all__ = [
    "add_vo_at_sparse_area", "compute_trans_difference", "convert_vo2ba",
    "delete_vo_by_plane_check", "make_frame_matcher", "merge_vro",
    "propose_sparse_area_edges", "void_edge",
]
