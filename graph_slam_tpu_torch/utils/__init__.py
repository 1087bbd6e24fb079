"""Observability helpers of the port (``graph_slam_tpu/utils`` counterpart)."""

from .profiling import Chi2Log, PhaseTimer, trace_context

__all__ = ["Chi2Log", "PhaseTimer", "trace_context"]
