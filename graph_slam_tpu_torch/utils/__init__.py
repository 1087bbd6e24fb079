"""Observability helpers and the chi-square quantile of the port
(``graph_slam_tpu/utils`` counterpart)."""

from .chi2 import chi2_quantile
from .colors import COLORS, color
from .metrics import (align_umeyama, ate_rmse, ate_rot_mean_deg, ate_stats,
                      rpe, rpe_stats)
from .profiling import Chi2Log, PhaseTimer, trace_context

__all__ = ["chi2_quantile", "COLORS", "color", "align_umeyama", "ate_rmse", "ate_stats",
           "ate_rot_mean_deg", "rpe", "rpe_stats", "Chi2Log", "PhaseTimer",
           "trace_context"]
