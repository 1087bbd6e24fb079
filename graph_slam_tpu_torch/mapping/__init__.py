"""Mapping of the port (``graph_slam_tpu/mapping`` counterpart): global
point clouds and their filters, PCD/PLY writers, grid meshes, TSDF fusion
with marching tetrahedra, map-video snapshots, headless viewers and the
PointCloud2-layout publisher."""

from .mesh import grid_triangulate, pcd_to_mesh, write_ply_mesh
from .pointcloud import (
    accumulate_cloud,
    map_from_frames,
    occupancy_denoise,
    passthrough,
    read_pcd,
    voxel_filter,
    write_pcd,
)
from .publish import (
    decode_pointcloud2,
    encode_pointcloud2,
    publish_pcd,
    read_published,
    serve_pointcloud,
)
from .tsdf import (
    TsdfVolume,
    extract_mesh,
    fuse_trajectory,
    integrate,
    make_volume,
)
from .video import follow_camera_pose, incremental_map_video
from .viewers import write_image_grid, write_registration_ply

__all__ = [
    "grid_triangulate", "pcd_to_mesh", "write_ply_mesh",
    "accumulate_cloud", "map_from_frames", "occupancy_denoise",
    "passthrough", "read_pcd", "voxel_filter", "write_pcd",
    "decode_pointcloud2", "encode_pointcloud2", "publish_pcd",
    "read_published", "serve_pointcloud",
    "TsdfVolume", "extract_mesh", "fuse_trajectory", "integrate",
    "make_volume",
    "follow_camera_pose", "incremental_map_video",
    "write_image_grid", "write_registration_ply",
]
