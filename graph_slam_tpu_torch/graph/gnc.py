"""Graduated non-convexity (GNC) for outlier-robust pose-graph optimization
(port of ``graph/gnc.py``).

GTSAM's ``GncOptimizer`` (Yang, Antonante, Tzoumas, Carlone, RA-L 2020):
alternate a weighted Gauss-Newton solve and a closed-form per-edge weight
update, annealing a convexity parameter mu so the robust cost starts
convex and sharpens into truncated least squares (TLS) or Geman-McClure
(GM). Weights scale the between rows' sqrt-information, so no new factor
machinery is needed and the padded shapes never change.

The reference's ``fori_loop`` over the mu schedule is a host loop of
``outer_iters`` here, each step the port's ``gn_optimize`` on the
weight-scaled graph; mu and the weights stay on the device, and nothing
is read back inside the anneal.

Rejected edges finish at w ~ 0, inliers at w ~ 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.chi2 import chi2_quantile
from .factors import FactorGraph, _between_parts, _mv, total_error
from .lm import gn_optimize
from .variables import VariableArena

__all__ = ["GncResult", "gnc_optimize"]


class GncResult(NamedTuple):
    values: VariableArena
    error: torch.Tensor       # chi2 with the converged weights applied
    #                           (rejected edges contribute 0 — the robust
    #                           cost; equals plain chi2 when all-inlier)
    error_raw: torch.Tensor   # chi2 of the UNWEIGHTED graph at the solution
    weights: torch.Tensor     # (F,) final per-between-edge weights in [0, 1]
    inliers: torch.Tensor     # (F,) bool, weights > 0.5 on candidate rows
    mu: torch.Tensor          # final convexity parameter


def _between_r2(graph: FactorGraph, values: VariableArena):
    """Squared whitened residual norm per between row (0 when inactive)."""
    bt = graph.between
    r = _mv(bt.sqrt_info, _between_parts(values, bt)[1])
    r2 = torch.sum(r * r, dim=-1)
    return torch.where(bt.active, r2, torch.zeros_like(r2))


def _tls_weights(r2, mu, barc2):
    hi = (mu + 1.0) / mu * barc2
    lo = mu / (mu + 1.0) * barc2
    mid = torch.sqrt(barc2 * mu * (mu + 1.0)
                     / torch.clamp(r2, min=1e-30)) - mu
    return torch.where(r2 >= hi, torch.zeros_like(r2),
                       torch.where(r2 <= lo, torch.ones_like(r2),
                                   torch.clamp(mid, 0.0, 1.0)))


def _gm_weights(r2, mu, barc2):
    w = (mu * barc2 / (r2 + mu * barc2)) ** 2
    return torch.clamp(w, 0.0, 1.0)


def _scaled(graph: FactorGraph, w):
    bt = graph.between
    sw = torch.sqrt(w).to(bt.sqrt_info.dtype)
    return graph._replace(
        between=bt._replace(sqrt_info=bt.sqrt_info * sw[:, None, None]))


def gnc_optimize(graph: FactorGraph, values: VariableArena,
                 candidates=None, kind: str = "tls",
                 barc2: float | None = None, outer_iters: int = 25,
                 gn_iters: int = 3, solver: str = "dense",
                 pcg_iters: int = 50, damping: float = 1e-6,
                 mu_factor: float = 1.4) -> GncResult:
    """Outlier-robust optimization of the between edges by GNC.

    ``candidates``: (F,) bool over between rows, the edges that may be
    down-weighted (default: every active row); pass a loop-closure-only
    mask to keep the odometry chain trusted. ``barc2``: the largest
    squared whitened residual of an inlier, by default the chi2(6) 0.99
    quantile. ``kind``: "tls" (truncated least squares, hard rejection) or
    "gm" (Geman-McClure, smooth down-weighting).
    """
    if kind not in ("tls", "gm"):
        raise ValueError(f"unknown GNC kind {kind!r} (tls|gm)")
    bt = graph.between
    dt, dev = values.pose_t.dtype, values.pose_t.device
    if candidates is None:
        candidates = torch.ones_like(bt.active)
    cand = torch.as_tensor(candidates, dtype=torch.bool, device=dev) \
        & bt.active
    if barc2 is None:
        barc2 = chi2_quantile(6, 0.01)
    barc2 = torch.as_tensor(barc2, dtype=dt, device=dev)
    tls = kind == "tls"
    weight_fn = _tls_weights if tls else _gm_weights

    def weights(vals, mu):
        r2 = _between_r2(graph, vals)
        return torch.where(cand, weight_fn(r2, mu, barc2),
                           torch.ones_like(r2))

    r2_0 = _between_r2(graph, values)
    r2_max = torch.max(torch.where(cand, r2_0, torch.zeros_like(r2_0)))
    # convex-start mu (Yang et al. §III-B), clamped: with wild outliers
    # the exact formula starts so small (r2_max ~ 1e6 => mu0 ~ 1e-6) that
    # no practical number of x1.4 steps reaches the TLS threshold regime
    if tls:
        mu = torch.clamp(barc2 / (2.0 * r2_max - barc2), 1e-2, 1e2)
    else:
        mu = torch.clamp(2.0 * r2_max / barc2, 1.0, 1e6)
    for _ in range(outer_iters):
        res = gn_optimize(_scaled(graph, weights(values, mu)), values,
                          iterations=gn_iters, solver=solver,
                          damping=damping, pcg_iters=pcg_iters)
        values = res.values
        mu = mu * mu_factor if tls else torch.clamp(mu / mu_factor, min=1.0)

    w = weights(values, mu)
    return GncResult(values, total_error(_scaled(graph, w), values),
                     total_error(graph, values), w, (w > 0.5) | ~cand, mu)
