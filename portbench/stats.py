"""The readers that metrics of several cells share (each metric's file
names its reader)."""

from __future__ import annotations


def ms_per_solve(ctx):
    """The window from its start to the end of the last completed solve,
    over the number of solves completed (host clock), in ms."""
    n = len(ctx["solves"])
    if not n:
        return None
    return ctx["window_s"] / n * 1e3


def device_idle_pct(ctx):
    """The share of the traced stretch of whole solves in which no kernel,
    copy or fill runs on the card (torch.profiler's device events)."""
    tr = ctx["trace"]
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def device_ms_per_iter(ctx):
    """Device time (kernels, copies and fills, summed) of the traced
    stretch over the Gauss-Newton iterations its solves ran (for LM, its
    outer iterations)."""
    tr = ctx["trace"]
    iters = sum(s["gn_iterations"] for s in ctx["solves"])
    if not tr or tr["device_s"] <= 0 or not iters:
        return None
    return tr["device_s"] / iters * 1e3


def launches_per_iter(ctx):
    """Kernels launched in the traced stretch over the Gauss-Newton
    iterations its solves ran."""
    tr = ctx["trace"]
    iters = sum(s["gn_iterations"] for s in ctx["solves"])
    if not tr or not tr["launches"] or not iters:
        return None
    return tr["launches"] / iters
