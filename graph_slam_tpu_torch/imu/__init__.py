"""IMU preintegration, presets and streams of the port
(``graph_slam_tpu/imu`` counterpart).

``integrate_segment`` is the log-depth form (``parallel_preint``), as in
the JAX package; the sequential form stays available as the parity oracle
``integrate_segment_scan``.
"""

from .preintegration import (
    ImuParams,
    PreintState,
    corrected_deltas,
    init_preint,
    predict_navstate,
)
from .preintegration import integrate_segment as integrate_segment_scan
from .parallel_preint import (
    integrate_segment_parallel,
    integrate_segment_parallel as integrate_segment,
)
from .presets import MEMS_DT, VN100_DT, mems_params, vn100_params
from .streams import (
    ImuStream,
    find_index_at,
    gravity_aligning_rotation,
    mems_frame_times,
    read_mems_log,
    read_vn100_log,
    static_bias_estimate,
)

__all__ = [
    "ImuParams", "PreintState", "init_preint", "integrate_segment",
    "integrate_segment_scan", "integrate_segment_parallel",
    "predict_navstate", "corrected_deltas",
    "vn100_params", "mems_params", "VN100_DT", "MEMS_DT",
    "ImuStream", "read_vn100_log", "read_mems_log", "find_index_at",
    "mems_frame_times",
    "static_bias_estimate", "gravity_aligning_rotation",
]
