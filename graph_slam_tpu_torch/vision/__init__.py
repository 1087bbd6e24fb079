"""Vision of the port (``graph_slam_tpu/vision`` counterpart): the Cal3DS2
camera model, depth backprojection, two-frame BA and the shared-landmark
track book. The feature frontend (SIFT, matching, PnP) is not ported yet
(ROADMAP item F2)."""

from .ba import TrackBook, two_frame_ba
from .cal3ds2 import (Cal3DS2, project_point, project_point_jacobian,
                      uncalibrate)
from .camera import backproject, cloud_from_images, depth_to_cloud

__all__ = ["Cal3DS2", "uncalibrate", "project_point",
           "project_point_jacobian", "backproject", "depth_to_cloud",
           "cloud_from_images", "two_frame_ba", "TrackBook"]
