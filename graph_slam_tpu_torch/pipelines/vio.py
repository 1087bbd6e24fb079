"""Offline visual-inertial odometry from a VRO log and an IMU stream (port
of ``pipelines/vio.py``).

Per VRO record, in file order: a new frame gets an IMU window
preintegration, a NavState prediction, a VO between-factor when its edge
is valid (camera->IMU conjugation by ``u2c``), a CombinedImuFactor from the
previous frame, and a pose estimate from VO composition (else from the IMU
prediction); loop-closure edges are added when both endpoints exist; every
``optimize_step`` frames a fixed-lag optimization feeds the bias and state
back into the next preintegration.

With ``plane_mode="rescue"`` and a plane source, a record whose VO edge
failed is rescued by planes: with ``frames`` the previous frame's planes
are propagated into the new one (the CUDA region grow on the card) and
fresh planes extracted where they do not cover it; with
``plane_obs_provider`` the provider's observations are inserted. The
planes become landmarks and OrientedPlane3 factors.
``plane_mode="rescue"`` with neither source is inert, as in the reference.

Ported: ``engine="scan"`` (``pipelines.vio_scan``). Not ported yet (the
online engine, ROADMAP queue 1): ``engine="online"``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import CameraIntrinsics, SlamParams
from ..core import se3
from ..device import resolve
from ..graph import LMParams
from ..imu import ImuParams, ImuStream
from ..io.vro_log import VROLog
from .vio_scan import _run_vio_scan
from .vio_types import VioConfig, VioResult

__all__ = ["VioConfig", "VioResult", "run_vio"]


def run_vio(log: VROLog, img_times, imu: ImuStream,
            imu_params: ImuParams, u2c: Optional[se3.Pose] = None,
            plane_obs_provider: Optional[Callable] = None,
            frames: Optional[Callable] = None,
            intrinsics: Optional[CameraIntrinsics] = None,
            params: SlamParams = SlamParams(),
            cfg: VioConfig = VioConfig(),
            lm_params: LMParams = LMParams(), *, device=None,
            dtype=torch.float64) -> VioResult:
    """Replay a VRO log with IMU on ``device`` (``None``: the CUDA card)
    in ``dtype``.

    Args:
      img_times: mapping seq_id -> timestamp (dict or callable).
      u2c: camera->IMU extrinsic (``core.extrinsics.camera_to_imu``);
        ``None`` is the identity.
      plane_obs_provider: optional ``seq_id -> [(plane_cam4, cov3x3),
        ...]``, per-frame plane observations in the camera frame.
      frames: optional ``seq_id -> (intensity, depth) | None`` (numpy,
        depth in meters) with ``intrinsics``: the rescue runs the plane
        stack from the frames (node 0's planes become landmarks).
      params: ``lookback_nodes`` sets the landmark association window.
    """
    device = resolve(device)
    t_of = img_times.__getitem__ if hasattr(img_times, "__getitem__") \
        else img_times
    if frames is not None and intrinsics is None:
        raise ValueError("frames mode requires camera intrinsics")
    if cfg.engine == "online":
        raise NotImplementedError(
            "engine='online' is not ported yet (ROADMAP queue 1: the "
            "online engine)")
    if cfg.engine != "scan":
        raise ValueError(f"unknown engine {cfg.engine!r} (online|scan)")
    if cfg.plane_mode == "always":
        raise ValueError(
            "engine='scan' supports plane_mode 'off' or 'rescue' "
            "(failures are host-known from the log, every frame is "
            "not); use engine='online' for 'always'")
    if not cfg.feedback:
        raise ValueError("engine='scan' requires feedback=True")
    return _run_vio_scan(log, t_of, imu, imu_params, u2c, params, cfg,
                         lm_params, device=device, dtype=dtype, frames=frames,
                         intrinsics=intrinsics,
                         plane_obs_provider=plane_obs_provider)
