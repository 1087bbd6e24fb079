"""Tracing / profiling hooks (port of ``utils/profiling.py``).

- ``trace_context(dir)``: a ``torch.profiler`` trace of the wrapped block,
  written as a Chrome trace ``trace.json`` under ``dir`` (a no-op when
  ``dir`` is empty or the profiler cannot start);
- ``PhaseTimer``: per-phase wall-clock accumulation for host-driven
  pipelines;
- ``Chi2Log``: structured per-update chi2 records (the error-before/after
  pattern, machine-readable).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Optional

__all__ = ["trace_context", "PhaseTimer", "Chi2Log"]


@contextlib.contextmanager
def trace_context(trace_dir: Optional[str]):
    """``torch.profiler`` over the block when ``trace_dir`` is set; CUDA
    activity is traced when a card is present."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # only profiler startup is guarded; an exception from the block
    # propagates unchanged
    try:
        prof = profile(activities=activities)
        prof.__enter__()
    except RuntimeError:   # profiler unavailable in this build
        yield
        return
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class PhaseTimer:
    """Accumulating wall-clock phase timers.

    >>> pt = PhaseTimer()
    >>> with pt("optimize"): ...
    >>> pt.summary()   # {"optimize": {"calls": 1, "total_s": ...}}
    """

    def __init__(self):
        self._acc: dict[str, list] = {}

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            ent = self._acc.setdefault(phase, [0, 0.0])
            ent[0] += 1
            ent[1] += dt

    def summary(self) -> dict:
        return {k: {"calls": v[0], "total_s": round(v[1], 6),
                    "mean_ms": round(v[1] / max(v[0], 1) * 1e3, 3)}
                for k, v in self._acc.items()}


@dataclasses.dataclass
class Chi2Log:
    """Per-update chi2 records: (step, n_nodes, chi2_before, chi2_after)."""

    rows: list = dataclasses.field(default_factory=list)

    def add(self, step: int, n_nodes: int, before: Optional[float],
            after: float) -> None:
        self.rows.append((int(step), int(n_nodes),
                          None if before is None else float(before),
                          float(after)))

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            for r in self.rows:
                f.write(json.dumps({"step": r[0], "nodes": r[1],
                                    "chi2_before": r[2],
                                    "chi2_after": r[3]}) + "\n")
