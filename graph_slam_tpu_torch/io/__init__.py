"""Log IO of the port (``graph_slam_tpu/io`` counterpart): VRO logs,
trajectory, PLY, g2o and marginals files, and RGB-D frame sources (``.gsf``
stores, PNG pairs, SR4000 ``.bdat`` dumps, TUM sequences)."""

from .frames import (FrameStore, decode_frame, encode_frame, load_frame,
                     save_frame)
from .rgbd_png import PngFrameStore, open_frame_source
from .sr4000 import convert_bdat_dir, read_bdat
from .trajectory import (Trajectory, read_g2o, read_marginals,
                         read_trajectory, write_g2o, write_graph_summary,
                         write_marginals, write_ply_points, write_trajectory,
                         write_trajectory_ply)
from .tum import (TumDataset, associate_timestamps, groundtruth_at,
                  is_tum_dir, read_tum_groundtruth)
from .vro_log import (FAILED_INFO_SENTINEL, VROLog, failed_edge, read_vro_log,
                      write_vro_log)

__all__ = [
    "encode_frame", "decode_frame", "save_frame", "load_frame", "FrameStore",
    "read_bdat", "convert_bdat_dir", "PngFrameStore", "open_frame_source",
    "TumDataset", "associate_timestamps", "groundtruth_at", "is_tum_dir",
    "read_tum_groundtruth",
    "VROLog", "read_vro_log", "write_vro_log", "failed_edge",
    "FAILED_INFO_SENTINEL",
    "Trajectory", "read_trajectory", "write_trajectory", "write_ply_points",
    "write_trajectory_ply", "write_g2o", "read_g2o", "write_graph_summary",
    "write_marginals", "read_marginals",
]
