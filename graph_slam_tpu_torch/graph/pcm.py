"""Pairwise-consistent loop-closure gating (PCM) for pose graphs (port of
``graph/pcm.py``).

PCM (Mangelson, Dominic, Eustice, Vasudevan, ICRA 2018) accepts the largest
subset of loop closures that are *jointly* consistent with each other and
the odometry: two loops ``a`` and ``b`` are pairwise consistent when the
cycle

    e_ab = Log( Z_a · O(j_a→j_b) · Z_b^{-1} · O(i_b→i_a) )

(``Z`` the measured relative pose, ``O`` the odometry-composed relative
pose between the loops' endpoints) has a small Mahalanobis norm, and the
accepted set is a maximum clique of the pairwise-consistency graph. Each
loop must also pass a unary odometry-consistency test (the same statistic
with ``b`` replaced by the odometry chain itself): pairwise consistency
alone cannot break a tie between two disagreeing loops.

Split: the per-loop odometry distances and the L x L cycle errors run on
the arena's device, from per-loop half-transforms built once; the pairs go
in row chunks bounded in bytes (a materialised (L, L, 6, 6) float64 Σ is
1.8 GB at L = 2,500), each pair's 6x6 system solved by ``cholesky_ex`` +
``cholesky_solve`` (no status read), and m2 comes to the host once. The
maximum clique (greedy conflict peeling, then Bron-Kerbosch with pivoting
and an expansion budget) and the mask logic are host numpy, copied from
the reference (``max_clique``'s pivot scan stops early, which picks the
same pivot).
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from ..core import se3
from ..utils.chi2 import chi2_quantile
from .factors import FactorGraph
from .variables import VariableArena

__all__ = ["PcmResult", "pcm_mask", "pairwise_consistency",
           "odometry_consistency", "max_clique"]

# bytes of device memory a chunk of loop pairs may take: a pair holds ~25
# (3, 3)-sized and 6-sized intermediates of the composes and the log, and
# two 6x6 matrices (Σ and its factor), ~1.2 KB in float64
_PAIR_CHUNK_BYTES = 1 << 29
_PAIR_FLOATS = 160


class PcmResult(NamedTuple):
    accepted: np.ndarray        # (F,) bool over between rows: keep active
    candidate_rows: np.ndarray  # (L,) int row indices that were gated
    clique_rows: np.ndarray     # (K,) int row indices the clique accepted
    m2_odo: np.ndarray          # (L,) odometry-consistency distances
    m2: np.ndarray              # (L, L) squared Mahalanobis cycle errors
    threshold: float            # chi2 acceptance threshold (both tests)


def _mahalanobis2(eps, sigma):
    """eps^T sigma^-1 eps over leading axes, by Cholesky."""
    L, _ = torch.linalg.cholesky_ex(sigma)
    return (eps * torch.cholesky_solve(eps[..., None], L)[..., 0]).sum(-1)


class _Loops(NamedTuple):
    """Per-loop device inputs shared by both consistency tests."""

    Xi: se3.Pose
    Xj: se3.Pose
    Z: se3.Pose
    cov: torch.Tensor     # (L, 6, 6)
    i: torch.Tensor       # (L,) int64
    j: torch.Tensor


def _loop_arrays(graph: FactorGraph, values: VariableArena, rows) -> _Loops:
    bt = graph.between
    dt, dev = values.pose_t.dtype, values.pose_t.device
    r = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
    i, j = bt.i[r], bt.j[r]
    # info = S^T S, its inverse on the host in float64 as the reference's
    S = bt.sqrt_info[r].detach().cpu().numpy()
    cov = np.linalg.inv(np.einsum("lki,lkj->lij", S, S))
    return _Loops(se3.Pose(values.pose_R[i], values.pose_t[i]),
                  se3.Pose(values.pose_R[j], values.pose_t[j]),
                  se3.Pose(bt.meas_R[r], bt.meas_t[r]),
                  torch.as_tensor(cov, device=dev).to(dt), i, j)


def _unary_m2(lp: _Loops, odo_cov):
    """(L,) Mahalanobis norms of ``Log(Z_a^{-1} · X_{i_a}^{-1} X_{j_a})``
    under the loop covariance plus the drift allowance for the
    ``|j_a - i_a|``-step odometry path."""
    eps = se3.local(lp.Z, se3.between(lp.Xi, lp.Xj))
    sep = (lp.j - lp.i).abs().to(lp.cov.dtype)
    eye6 = torch.eye(6, dtype=lp.cov.dtype, device=lp.cov.device)
    return _mahalanobis2(eps, lp.cov + (odo_cov * sep)[:, None, None] * eye6)


def _pairwise_m2(lp: _Loops, odo_cov):
    """(L, L) squared Mahalanobis norms of the loop-pair cycle errors.

    With ``P_a = Z_a · X_{j_a}^{-1}``, ``Q_b = X_{j_b} · Z_b^{-1} ·
    X_{i_b}^{-1}`` and ``W_a = X_{i_a}``, ``e_ab = Log(P_a · Q_b · W_a)``
    equals the cycle error in the module docstring. The cycle covariance is
    ``cov_a + cov_b`` plus an isotropic ``odo_cov`` per node step
    separating the two loops' endpoints.
    """
    P = se3.compose(lp.Z, se3.inverse(lp.Xj))
    Q = se3.compose(lp.Xj, se3.compose(se3.inverse(lp.Z),
                                       se3.inverse(lp.Xi)))
    L = lp.i.shape[0]
    eye6 = torch.eye(6, dtype=lp.cov.dtype, device=lp.cov.device)
    itemsize = lp.cov.element_size()
    rows = max(1, _PAIR_CHUNK_BYTES // (L * _PAIR_FLOATS * itemsize))
    out = []
    for lo in range(0, L, rows):
        a = slice(lo, min(L, lo + rows))
        Pa = se3.Pose(P.R[a, None], P.t[a, None])
        Wa = se3.Pose(lp.Xi.R[a, None], lp.Xi.t[a, None])
        eps = se3.logmap(se3.compose(Pa, se3.compose(Q, Wa)))   # (c, L, 6)
        sep = ((lp.i[a, None] - lp.i[None]).abs()
               + (lp.j[a, None] - lp.j[None]).abs()).to(lp.cov.dtype)
        sigma = (lp.cov[a, None] + lp.cov[None]
                 + (odo_cov * sep)[..., None, None] * eye6)
        out.append(_mahalanobis2(eps, sigma))
    return torch.cat(out)


def pairwise_consistency(graph: FactorGraph, values: VariableArena,
                         rows: np.ndarray,
                         odo_cov_per_step: float = 0.0) -> np.ndarray:
    """(L, L) squared Mahalanobis cycle errors for the between rows ``rows``.

    ``values`` must hold the odometry-composed estimate (the arena as the
    builder produced it): PCM measures loops against the *odometry*, not
    against an already-loop-corrected solution.
    """
    m2 = _pairwise_m2(_loop_arrays(graph, values, rows), odo_cov_per_step)
    return m2.cpu().numpy()


def odometry_consistency(graph: FactorGraph, values: VariableArena,
                         rows: np.ndarray,
                         odo_cov_per_step: float = 0.0) -> np.ndarray:
    """(L,) squared Mahalanobis distances of each loop vs the odometry."""
    m2 = _unary_m2(_loop_arrays(graph, values, rows), odo_cov_per_step)
    return m2.cpu().numpy()


def _greedy_clique(adj: np.ndarray) -> list[int]:
    """Large clique fast: peel the vertex with the most conflicts until
    none remain.

    PCM consistency graphs are near-complete (inliers agree with almost
    everything), so the COMPLEMENT is sparse and clique-finding is really
    conflict-cover removal, the regime where Bron–Kerbosch alone struggles.
    """
    n = adj.shape[0]
    conflicts = ~adj
    np.fill_diagonal(conflicts, False)
    alive = np.ones(n, bool)
    while True:
        deg = (conflicts & alive[None, :]).sum(1)
        deg[~alive] = 0
        worst = int(deg.argmax())
        if deg[worst] == 0:
            break
        alive[worst] = False
    return np.flatnonzero(alive).tolist()


def max_clique(adj: np.ndarray, budget: int = 200_000) -> list[int]:
    """Maximum clique of a symmetric boolean adjacency matrix.

    A greedy conflict-peeling warm start (near-optimal on the
    near-complete graphs PCM produces) seeds Bron–Kerbosch with pivoting;
    ``budget`` caps the number of branch expansions — past it the best
    clique found so far is returned (still a valid consistent set,
    possibly sub-maximum).
    """
    n = adj.shape[0]
    if n == 0:
        return []
    nbrs = [set(np.flatnonzero(adj[k]).tolist()) - {k} for k in range(n)]
    best: list[int] = _greedy_clique(adj)
    spent = 0
    # recursion depth is bounded by the deepest descent (<= n on
    # near-complete graphs); keep headroom beyond Python's default 1000
    limit = sys.getrecursionlimit()
    if n + 100 > limit:
        sys.setrecursionlimit(n + 1000)

    def pivot_of(P: set, X: set) -> int:
        """``max(P | X, key=lambda u: len(P & nbrs[u]))``, the reference's
        pivot, with the scan stopped at the first vertex whose count
        reaches the largest possible (|P| - 1 for a vertex of P, |P| for
        one of X): no later vertex can beat it, and ``max`` keeps the
        first of equals. On a near-complete PCM graph that vertex comes
        within a few, where the full scan costs O(n^2) a level (L = 2,500
        in ``chip_smoke.py``, on the host of an H100 machine: 163 s ->
        9-12 s, the same clique)."""
        bound = len(P) if X else len(P) - 1
        pivot, count = None, -1
        for u in P | X:
            k = len(P & nbrs[u])
            if k > count:
                pivot, count = u, k
                if k == bound:
                    break
        return pivot

    def bk(R: list[int], P: set, X: set) -> None:
        nonlocal best, spent
        if spent > budget:
            return
        if not P and not X:
            if len(R) > len(best):
                best = R[:]
            return
        if len(R) + len(P) <= len(best):
            return
        pivot = pivot_of(P, X)
        for v in list(P - nbrs[pivot]):
            spent += 1
            bk(R + [v], P & nbrs[v], X & nbrs[v])
            P.remove(v)
            X.add(v)

    bk([], set(range(n)), set())
    return sorted(best)


def pcm_mask(graph: FactorGraph, values: VariableArena,
             candidates=None, alpha: float = 1e-4,
             odo_cov_per_step: float | None = None,
             budget: int = 200_000) -> PcmResult:
    """Gate loop closures by pairwise consistency maximization.

    ``candidates``: (F,) bool over between rows, the loop closures subject
    to gating (default: every active row whose endpoints are not
    consecutive graph ids). ``alpha``: upper-tail probability of the
    chi2(6) acceptance test; the default is far out in the tail because the
    test runs on all L² loop pairs, so a 1% per-pair tail would falsely
    conflict every inlier with ~1% of the others. ``odo_cov_per_step``:
    isotropic covariance added per node step separating two loops'
    endpoints; None derives it from the odometry rows (mean diagonal
    covariance of the non-candidate active rows), 0.0 trusts the odometry
    exactly.

    Returns a full-length ``accepted`` mask: non-candidate rows stay True;
    candidate rows are True iff they belong to the maximum clique. Apply
    with ``graph._replace(between=bt._replace(active=bt.active &
    accepted))`` (as a tensor on the graph's device).
    """
    bt = graph.between
    active = bt.active.cpu().numpy()
    if candidates is None:
        candidates = (bt.j - bt.i).cpu().numpy() != 1
    elif isinstance(candidates, torch.Tensor):
        candidates = candidates.cpu().numpy()
    candidates = np.asarray(candidates, bool)
    cand = candidates & active
    if odo_cov_per_step is None:
        odo = active & ~candidates
        if odo.any():
            S = bt.sqrt_info.cpu().numpy()[odo]
            info = np.einsum("lki,lkj->lij", S, S)
            diag_cov = np.diagonal(np.linalg.inv(info), axis1=1, axis2=2)
            odo_cov_per_step = float(diag_cov.mean())
        else:
            odo_cov_per_step = 0.0
    rows = np.flatnonzero(cand)
    accepted = np.ones(active.shape, bool)
    thresh = chi2_quantile(6, alpha)
    if len(rows) == 0:
        z = np.zeros(0)
        return PcmResult(accepted, rows, rows, z, z.reshape(0, 0), thresh)
    # unary odometry-consistency check first (the Kimera-RPGO ordering):
    # with one true and one wild loop both singleton cliques have size 1
    # and the outlier could win
    lp = _loop_arrays(graph, values, rows)
    m2_odo = _unary_m2(lp, odo_cov_per_step).cpu().numpy()
    ok = m2_odo <= thresh
    accepted[rows[~ok]] = False
    if ok.sum() <= 1:
        m2 = np.zeros((len(rows), len(rows)))
        return PcmResult(accepted, rows, rows[ok], m2_odo, m2, thresh)
    m2 = _pairwise_m2(lp, odo_cov_per_step).cpu().numpy()
    m2 = np.maximum(m2, m2.T)      # symmetrize: consistency is mutual
    adj = (m2 <= thresh) & ok[None, :] & ok[:, None]
    sub = np.flatnonzero(ok)
    clique = max_clique(adj[np.ix_(sub, sub)], budget=budget)
    keep = np.zeros(len(rows), bool)
    keep[sub[clique]] = True
    accepted[rows[~keep]] = False
    return PcmResult(accepted, rows, rows[keep], m2_odo, m2, thresh)
