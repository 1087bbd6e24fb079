"""Observability helpers and the chi-square quantile of the port
(``graph_slam_tpu/utils`` counterpart)."""

from .chi2 import chi2_quantile
from .profiling import Chi2Log, PhaseTimer, trace_context

__all__ = ["chi2_quantile", "Chi2Log", "PhaseTimer", "trace_context"]
