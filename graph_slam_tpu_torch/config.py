"""Configuration dataclasses and launch-file presets — a copy of
``graph_slam_tpu/config.py``.

Copied rather than imported: importing ``graph_slam_tpu.config`` runs
``graph_slam_tpu/__init__.py``, which imports jax. ``SlamParams`` (every
``robust`` choice, GNC included, is ported), ``CameraIntrinsics``, the
camera presets and the preset loaders are here. The presets are the
port's own copy of the 26 JSON files, ``graph_slam_tpu_torch/configs/``:
the same contents as the JAX package's but for ``source``, which names
the reference's launch file by its path in the reference repository.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

__all__ = ["SlamParams", "CameraIntrinsics", "SR4000", "RS435", "RS200",
           "TUM_FR1", "TUM_FR2", "TUM_FR3", "load_params", "save_params",
           "load_config_dict", "preset_names", "preset_path"]


@dataclasses.dataclass
class SlamParams:
    """CGTParams / CG2OParams equivalent (gt_parameter.h:17-40)."""

    lookback_nodes: int = 7          # loop-closure candidate window
    small_translation: float = 0.05  # m  — below both: drop keyframe
    small_rotation: float = 3.0      # deg
    large_translation: float = 2.0   # m  — above either: reject as outlier
    large_rotation: float = 20.0     # deg
    optimize_step: int = 10          # batch optimize cadence (keyframes)
    output_dir: str = "./out"
    record_vro_results: bool = False
    vro_result_path: str = "vro_results.log"
    initial_pitch_degree: float = 0.0
    optimizer: str = "lm"            # "lm" | "gn"
    incremental: bool = True         # ISAM2-equivalent incremental updates
    # robust handling of corrupted edges: None, "huber" (per-row Huber(k)),
    # or "gnc-tls" / "gnc-gm" (graduated non-convexity over loop closures)
    robust: Optional[str] = None
    robust_k: float = 1.345


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole (+ radial distortion) camera model parameters."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    width: int = 0
    height: int = 0
    depth_scale: float = 0.001

    def as_tuple(self):
        return (self.fx, self.fy, self.cx, self.cy, self.k1, self.k2,
                self.p1, self.p2)


# SR4000 ToF camera (test_gt_graph.cpp:50): 176x144
SR4000 = CameraIntrinsics(fx=250.5773, fy=250.5773, cx=90.0, cy=70.0,
                          k1=-0.8466, k2=0.5370, width=176, height=144,
                          depth_scale=0.001)

# RealSense R200 / RS435 (main_rgbdslam_offline.cpp:61): 640x480
RS435 = CameraIntrinsics(fx=617.306, fy=617.714, cx=326.245, cy=239.974,
                         width=640, height=480, depth_scale=0.001)
RS200 = RS435

# TUM RGB-D benchmark Kinects (Sturm et al., IROS 2012)
TUM_FR1 = CameraIntrinsics(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                           k1=0.2624, k2=-0.9531, p1=-0.0054, p2=0.0026,
                           width=640, height=480, depth_scale=0.0002)
TUM_FR2 = CameraIntrinsics(fx=520.9, fy=521.0, cx=325.1, cy=249.7,
                           k1=0.2312, k2=-0.7849, p1=-0.0033, p2=-0.0001,
                           width=640, height=480, depth_scale=0.0002)
TUM_FR3 = CameraIntrinsics(fx=535.4, fy=539.2, cx=320.1, cy=247.6,
                           width=640, height=480, depth_scale=0.0002)


# Launch-file presets (the reference's 25 launch/**/*.launch files): JSON
# files shipped under configs/, addressable by bare name everywhere a
# --config path is accepted. Reserved top-level sections that are NOT
# SlamParams fields:
#   description / source  — provenance (the launch file they mirror)
#   camera                — intrinsics preset name ("sr4000" | "rs435")
#   extrinsic             — camera-IMU extrinsic preset
#   backend               — "gtsam" | "g2o" fake-odo weighting
#   imu_type              — "vn100" | "mems"
#   vio                   — pipelines.vio.VioConfig field overrides
#   tool                  — the CLI subcommand this preset parameterizes
#   args                  — CLI-flag defaults for that subcommand (the
#                           launch file's <param> tags; cli.main applies
#                           them as parser defaults, flags still win)
_RESERVED_KEYS = ("description", "source", "camera", "extrinsic", "backend",
                  "imu_type", "vio", "tool", "args")
_CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs")


def preset_names() -> list:
    """Names of the shipped launch-file-equivalent presets."""
    return sorted(os.path.splitext(f)[0] for f in os.listdir(_CONFIG_DIR)
                  if f.endswith(".json"))


def preset_path(name: str) -> str:
    return os.path.join(_CONFIG_DIR, name + ".json")


def load_config_dict(path_or_name: str) -> dict:
    """Full config dict from a JSON file path or a shipped preset name."""
    path = path_or_name
    if not os.path.exists(path):
        cand = preset_path(path_or_name)
        if os.path.exists(cand):
            path = cand
        else:
            raise FileNotFoundError(
                f"no config file {path_or_name!r} and no preset named "
                f"{path_or_name!r} (available: {', '.join(preset_names())})")
    with open(path) as f:
        return json.load(f)


def load_params(path_or_name: str) -> SlamParams:
    """Launch-file replacement: JSON dict of overrides over defaults.

    Accepts a file path or a shipped preset name (``preset_names()``).
    Reserved non-SlamParams sections (camera/vio/...) are ignored here —
    the CLI applies them at the driver level.
    """
    data = load_config_dict(path_or_name)
    fields = {f.name for f in dataclasses.fields(SlamParams)}
    unknown = set(data) - fields - set(_RESERVED_KEYS)
    if unknown:
        raise ValueError(f"unknown SlamParams keys: {sorted(unknown)}")
    return SlamParams(**{k: v for k, v in data.items() if k in fields})


def save_params(path: str, params: SlamParams) -> None:
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(params), f, indent=2)
