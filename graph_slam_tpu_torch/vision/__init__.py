"""Vision of the port (``graph_slam_tpu/vision`` counterpart): the
Cal3DS2 camera model, depth backprojection, the Harris and SIFT feature
extractors, descriptor matching, RANSAC and PnP, the VRO frontend, place
recognition, two-frame BA and the shared-landmark track book."""

from .ba import TrackBook, two_frame_ba
from .cal3ds2 import (Cal3DS2, project_point, project_point_jacobian,
                      uncalibrate)
from .camera import backproject, cloud_from_images, depth_to_cloud
from .features import FeatureFrame, extract_features, harris_corners
from .frontend import (get_extractor, make_ba_fn, make_feature_cache,
                       match_frames_device, match_node_pair,
                       match_one_to_many, match_under_prior, refine_edge_ba)
from .matching import (MatchingResult, match_descriptors, pnp_ransac,
                       ransac_rigid, umeyama, vo_information)
from .place import PlaceIndex, global_descriptor
from .sift import SiftKeypoints, dog_keypoints, sift_features

__all__ = ["Cal3DS2", "uncalibrate", "project_point",
           "project_point_jacobian", "backproject", "depth_to_cloud",
           "cloud_from_images", "FeatureFrame", "extract_features",
           "harris_corners", "SiftKeypoints", "dog_keypoints",
           "sift_features", "get_extractor", "make_feature_cache",
           "make_ba_fn", "match_node_pair", "match_one_to_many",
           "match_frames_device", "match_under_prior", "refine_edge_ba",
           "MatchingResult", "match_descriptors", "ransac_rigid",
           "pnp_ransac", "umeyama", "vo_information", "PlaceIndex",
           "global_descriptor", "two_frame_ba", "TrackBook"]
