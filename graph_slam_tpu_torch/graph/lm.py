"""Batch optimizers: Levenberg–Marquardt (GTSAM-matching) and Gauss–Newton
(port of ``graph/lm.py``).

``lm_optimize`` reproduces the reference's GTSAM 4.0
``LevenbergMarquardtOptimizer`` schedule: damping ``H + lam I``, lambda
from 1e-5 by a fixed factor 10 up to 1e5, acceptance by model fidelity
> 1e-3, convergence on relative or absolute decrease <= 1e-5, at most 100
outer iterations. The reference's two nested ``lax.while_loop``s are host
loops here; each lambda trial reads its acceptance flag on the host (one
device sync per trial).

Solvers: ``"dense"`` assembles H and g by scatter-add and solves by
Cholesky; ``"pcg"`` is the fused path (per-factor JᵀJ blocks once per
linearization, 3x3 block-Jacobi preconditioner, fixed-trip CG). On CUDA the
scatter-adds are atomics, so float sums are taken in a run-dependent order.
The ``Incidence`` gather path and ``lm_optimize_g2o`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import solve
from .factors import FactorGraph, linearize_blocks, total_error
from .variables import VariableArena, retract_all, used_slot_mask

__all__ = ["LMParams", "LMResult", "lm_optimize", "gn_optimize"]


@dataclasses.dataclass(frozen=True)
class LMParams:
    lambda_initial: float = 1e-5
    lambda_factor: float = 10.0
    lambda_upper: float = 1e5
    lambda_lower: float = 0.0
    min_model_fidelity: float = 1e-3
    max_iterations: int = 100
    relative_error_tol: float = 1e-5
    absolute_error_tol: float = 1e-5
    error_tol: float = 0.0
    max_trials: int = 12          # lambda spans 1e-5..1e5 in 10 x10 steps
    solver: str = "dense"          # "dense" | "pcg"
    pcg_iters: int = 250


class LMResult(NamedTuple):
    values: VariableArena
    error: torch.Tensor
    iterations: int
    lam: float
    converged: bool


def _gradient(blocks, mask):
    g = torch.zeros_like(mask)
    for r, J, cols in blocks:
        g.index_add_(0, cols.reshape(-1),
                     torch.einsum("fei,fe->fi", J, r).reshape(-1))
    return g


def _dense_hg(blocks, mask):
    """Dense GN normal equations (H, g) from linearized blocks.

    Unused tangent slots are pinned with an identity diagonal so H stays
    nonsingular under arena padding. Never forms (P, P, 6, 6) blocks: each
    factor's (td, td) JᵀJ is scattered straight into the flat (D, D) H.
    """
    H = torch.diag(1.0 - mask)
    for r, J, cols in blocks:
        td = cols.shape[1]
        rows_idx = cols[:, :, None].expand(-1, td, td)
        cols_idx = cols[:, None, :].expand(-1, td, td)
        H.index_put_((rows_idx.reshape(-1), cols_idx.reshape(-1)),
                     torch.einsum("fei,fej->fij", J, J).reshape(-1),
                     accumulate=True)
    return H, _gradient(blocks, mask)


def _solvers(blocks, mask, params: LMParams):
    """Return (solve(lam) -> delta, hmul(delta) -> H delta, g)."""
    if params.solver == "dense":
        H, g = _dense_hg(blocks, mask)

        def solve_fn(lam):
            return solve.solve_dense(H, g, lam)

        def hmul(v):
            return H @ v

        return solve_fn, hmul, g

    if params.solver != "pcg":
        raise ValueError(f"unknown solver {params.solver!r}")

    g = _gradient(blocks, mask)
    # per-factor JᵀJ blocks once per linearization; each CG iteration is
    # then one batched (td, td) matvec and a scatter-add
    pre = [(torch.einsum("fei,fej->fij", J, J), cols) for r, J, cols in blocks]
    # 3x3-aligned block-Jacobi preconditioner: every variable tangent is a
    # multiple of 3 wide at a 3-aligned offset
    D = mask.shape[0]
    nblk = D // 3
    eye3 = torch.eye(3, dtype=mask.dtype, device=mask.device)

    def blkdiag_with(lam):
        base = lam * torch.ones_like(mask) + (1.0 - mask)
        Bd = base.reshape(nblk, 3)[:, :, None] * eye3
        for JtJ, cols in pre:
            for p0 in range(0, cols.shape[1], 3):
                Bd.index_add_(0, cols[:, p0] // 3, JtJ[:, p0:p0 + 3, p0:p0 + 3])
        return Bd

    def hvp_with(lam):
        def hvp(v):
            out = lam * v + (1.0 - mask) * v
            for JtJ, cols in pre:
                out.index_add_(0, cols.reshape(-1),
                               torch.einsum("fij,fj->fi", JtJ,
                                            v[cols]).reshape(-1))
            return out

        return hvp

    def solve_fn(lam):
        Minv = solve.inv33(blkdiag_with(lam))

        def apply_precond(r):
            return torch.einsum("bij,bj->bi", Minv,
                                r.reshape(nblk, 3)).reshape(-1)

        return solve.solve_pcg_precond(hvp_with(lam), g, apply_precond,
                                       params.pcg_iters)

    return solve_fn, hvp_with(0.0), g


def lm_optimize(graph: FactorGraph, values: VariableArena,
                params: LMParams = LMParams()) -> LMResult:
    """GTSAM LM: relinearize once per outer iteration, then lambda trials."""
    error = total_error(graph, values)
    lam = params.lambda_initial
    it = 0
    done = bool(error <= params.error_tol)
    while not done and it < params.max_iterations:
        blocks = linearize_blocks(graph, values)
        mask = used_slot_mask(values)
        solve_fn, hmul, g = _solvers(blocks, mask, params)

        trials, accepted, stuck = 0, False, False
        new_vals, new_err = values, error
        while not accepted and not stuck and trials < params.max_trials:
            delta = solve_fn(lam)
            cand = retract_all(values, delta)
            cand_err = total_error(graph, cand)
            # linearized cost decrease: -(g . d) - 0.5 d . (H d)
            lin_dec = -torch.dot(g, delta) - 0.5 * torch.dot(delta, hmul(delta))
            fidelity = (error - cand_err) / torch.where(
                lin_dec != 0, lin_dec, torch.ones_like(lin_dec))
            ok = bool((lin_dec > 0) & (fidelity > params.min_model_fidelity)
                      & torch.isfinite(cand_err))
            if ok:
                new_vals, new_err = cand, cand_err
            else:
                lam = lam * params.lambda_factor
                stuck = lam > params.lambda_upper
            trials += 1
            accepted = ok

        if accepted:
            lam = max(lam / params.lambda_factor, params.lambda_lower)
        abs_dec = error - new_err
        rel_dec = abs_dec / torch.where(error > 0, error,
                                        torch.ones_like(error))
        converged = accepted and bool(
            (new_err <= params.error_tol)
            | (rel_dec <= params.relative_error_tol)
            | (abs_dec <= params.absolute_error_tol))
        done = converged or not accepted or stuck
        values, error = new_vals, new_err
        it += 1
    return LMResult(values, error, it, lam, done)


def gn_optimize(graph: FactorGraph, values: VariableArena,
                iterations: int = 10, solver: str = "dense",
                damping: float = 0.0, pcg_iters: int = 250) -> LMResult:
    """Plain Gauss–Newton with a fixed trip count (the throughput unit).

    The reference's ``update_mask``, ``Incidence`` and ``return_history``
    options are not ported yet.
    """
    params = LMParams(solver=solver, pcg_iters=pcg_iters)
    for _ in range(iterations):
        blocks = linearize_blocks(graph, values)
        solve_fn, _, _ = _solvers(blocks, used_slot_mask(values), params)
        values = retract_all(values, solve_fn(damping))
    return LMResult(values, total_error(graph, values), iterations, damping,
                    True)
