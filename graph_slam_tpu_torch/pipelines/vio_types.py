"""VIO pipeline configuration and result records (port of
``pipelines/vio_types.py``).

Shared by the per-frame online engine (``pipelines.vio``) and the
whole-replay scan engine (``pipelines.vio_scan``). The fields are the
reference's but ``scan_chunk``: the port's scan engine is a host loop over
records and compiles no chunks, so nothing would read it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["VioConfig", "VioResult"]


@dataclasses.dataclass
class VioConfig:
    plane_mode: str = "rescue"        # "rescue" | "always" | "off"
    optimize_step: int = 10            # incremental optimize cadence (frames)
    incremental_iters: int = 2         # GN iters per incremental update
    max_imu_window: int = 512          # padded preintegration window
    final_batch: bool = True           # LM at the end (reference outputs)
    feedback: bool = True              # bias/state re-seeding
    bucket: int = 256                  # online arenas' capacity step
    # "online" (the per-frame loop over preallocated OnlineGraph arenas,
    # the ISAM2-role engine) | "scan" (the replay of host-precomputed
    # records with fixed-lag optimization on schedule)
    engine: str = "online"
    # the online engine's full-arena update (window None): "dense" | "pcg"
    incremental_solver: str = "dense"
    incremental_pcg_iters: int = 100
    window: Optional[int] = None       # fixed-lag window (None = full arena)
    plane_var_cap: int = 32            # initial plane landmark capacity
    # chi2 IMU-vs-VRO rotation consistency gate: implemented but default-off,
    # matching the reference (threshold 40000, flag default false)
    chi2_vro_gate: bool = False
    chi2_threshold: float = 4e4
    # robust kernel on VO between-factors ("huber": Huber(k=robust_k))
    robust: Optional[str] = None
    robust_k: float = 1.345
    # frames-driven plane extraction (CPlaneNode::extractPlanes params);
    # ``seed`` keys the RANSAC draws
    max_planes: int = 4
    min_plane_support: int = 300
    seed: int = 0
    # startup gravity/bias initialization (initFromImu + static bias):
    # align the first pose's rotation to the measured gravity direction and
    # seed the bias from the pre-sync static window
    gravity_init: bool = False
    # static-window length for gravity/bias init; 0 = all pre-sync samples
    # (falling back to the first 200 when the log starts at the sync point)
    static_init_samples: int = 0
    # torch.profiler trace directory (utils.profiling.trace_context)
    trace_dir: Optional[str] = None


@dataclasses.dataclass
class VioResult:
    values: object
    graph: object
    seq_ids: np.ndarray
    error0: float
    error: float
    n_imu_factors: int
    n_vo_edges: int
    n_plane_factors: int
    plane_book: object            # planes.PlaneLandmarkBook, or None
    chi2_log: object = None       # utils.profiling.Chi2Log
    timers: Optional[dict] = None  # PhaseTimer.summary()
    plane_stack: object = None    # vio_planes._PlaneStack, or None
