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
linearization, 3x3 block-Jacobi preconditioner, fixed-trip CG); with an
``Incidence`` (``graph.sparsity``) the PCG path accumulates by gather only,
with a Jacobi preconditioner, as the reference's. On CUDA the scatter-adds
are atomics, so float sums are taken in a run-dependent order.

``lm_optimize_g2o`` is g2o's schedule: LM iterations in chunks, the damping
re-initialised at the start of each chunk, Nielsen's accept/reject rule;
its nested loops are host loops too, one host read per trial.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import solve
from .assemble import dense_hg, gradient_of
from .factors import FactorGraph, linearize_blocks, total_error
from .sparsity import Incidence, diag_gather, gradient_gather, hvp_fn_gather
from .variables import VariableArena, layout_of, retract_all, used_slot_mask

__all__ = ["LMParams", "LMResult", "lm_optimize", "lm_optimize_g2o",
           "gn_optimize"]


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
    history: torch.Tensor | None = None   # chi2 after each GN step / chunk


def _anchored_slot_mask(graph: FactorGraph, values: VariableArena):
    """Boolean (dim,) mask of tangent slots held by a near-rigid pose prior.

    g2o marks its gauge with ``setFixed`` (vertex rows never enter H);
    the builder pins the gauge with a tight prior instead. Any pose
    carrying sqrt-information above ~1e4 (sigma below ~1e-4) plays the
    fixed-vertex role, wherever it sits in the arena, so that
    ``lambda0 = tau * max_i H_ii`` stays sane for graphs anchored
    elsewhere than pose 0.
    """
    lay = layout_of(values)
    anchored = torch.zeros(lay.dim, dtype=values.pose_t.dtype,
                           device=values.pose_t.device)
    pp = graph.prior_pose
    if pp.idx.shape[0]:
        tight = pp.active & (torch.diagonal(
            pp.sqrt_info, dim1=-2, dim2=-1).amax(dim=1) > 1e4)
        cols = lay.pose_cols(pp.idx)
        anchored.index_put_((cols.reshape(-1),),
                            tight.repeat_interleave(6).to(anchored.dtype),
                            accumulate=True)
    return anchored > 0


def _solvers(blocks, mask, params: LMParams, inc: Incidence | None = None):
    """Return (solve(lam) -> delta, hmul(delta) -> H delta, g).

    With an ``Incidence`` the PCG path accumulates by gather only
    (Jacobi preconditioner); otherwise scatter-add is used.
    """
    if inc is not None and params.solver == "pcg":
        g = gradient_gather(blocks, inc, mask.dtype)

        def solve_fn(lam):
            return solve.solve_pcg(hvp_fn_gather(blocks, inc, mask, lam), g,
                                   diag_gather(blocks, inc, mask, lam),
                                   params.pcg_iters)

        return solve_fn, hvp_fn_gather(blocks, inc, mask, 0.0), g

    if params.solver == "dense":
        H, g = dense_hg(blocks, mask)

        def solve_fn(lam):
            return solve.solve_dense(H, g, lam)

        def hmul(v):
            return H @ v

        return solve_fn, hmul, g

    if params.solver != "pcg":
        raise ValueError(f"unknown solver {params.solver!r}")

    g = gradient_of(blocks, mask)
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
                params: LMParams = LMParams(),
                inc: Incidence | None = None) -> LMResult:
    """GTSAM LM: relinearize once per outer iteration, then lambda trials.

    With an ``Incidence`` and ``params.solver == "pcg"`` each trial solves
    with the gather PCG (Jacobi preconditioner)."""
    error = total_error(graph, values)
    lam = params.lambda_initial
    it = 0
    done = bool(error <= params.error_tol)
    while not done and it < params.max_iterations:
        blocks = linearize_blocks(graph, values)
        mask = used_slot_mask(values)
        solve_fn, hmul, g = _solvers(blocks, mask, params, inc)

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


def lm_optimize_g2o(graph: FactorGraph, values: VariableArena,
                    total_iters: int = 20, chunks: int = 10,
                    tau: float = 1e-5, max_trials: int = 10) -> LMResult:
    """g2o ``CGraphG2O::optimizeGraph`` semantics: ``total_iters`` LM
    iterations executed as ``chunks`` calls of ``optimize(ceil(total /
    chunks))``.

    The chunking is semantic: g2o's ``OptimizationAlgorithmLevenberg``
    re-initialises its damping at the start of every ``optimize()`` call
    (``lambda0 = tau * max_i H_ii`` over the free variables, tau = 1e-5)
    and adapts it with the Marquardt-Nielsen schedule inside the call
    (accept: ``lam *= max(1/3, 1 - (2 rho - 1)^3)``, ni = 2; reject:
    ``lam *= ni``, ``ni *= 2``). So the chi2 trajectory differs from
    ``lm_optimize``'s though both reach the same optimum. ``history``
    holds the chi2 after each chunk, (chunks,). Each trial's acceptance is
    read on the host once; lambda and ni stay on the device.
    """
    err = total_error(graph, values)
    iters_per_chunk = -(-total_iters // chunks)
    mask = used_slot_mask(values)
    # slots pinned by a near-rigid prior play g2o's fixed-vertex role:
    # their ~1e12 H_ii would inflate lambda0 and stall the schedule
    anchored = _anchored_slot_mask(graph, values)
    hist = []
    for _ in range(chunks):
        ni = torch.full_like(err, 2.0)
        for k in range(iters_per_chunk):
            H, g = dense_hg(linearize_blocks(graph, values), mask)
            if k == 0:
                diag_free = torch.where(anchored, torch.zeros_like(mask),
                                        torch.diagonal(H))
                lam = tau * torch.max(diag_free)
            for _ in range(max_trials):
                delta = solve.solve_dense(H, g, lam)
                cand = retract_all(values, delta)
                cand_err = total_error(graph, cand)
                # g2o's gain ratio: rho = (F(x) - F(x+d)) / (d^T(lam d - g))
                denom = torch.dot(delta, lam * delta - g)
                rho = (err - cand_err) / torch.where(
                    denom != 0, denom, torch.ones_like(denom))
                ok = (rho > 0) & torch.isfinite(cand_err)
                scale = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                    min=1.0 / 3.0)
                lam = torch.where(ok, lam * scale, lam * ni)
                ni = torch.where(ok, torch.full_like(ni, 2.0), ni * 2.0)
                if bool(ok):
                    values, err = cand, cand_err
                    break
        hist.append(err)
    return LMResult(values, err, total_iters, 0.0, True, torch.stack(hist))


def gn_optimize(graph: FactorGraph, values: VariableArena,
                iterations: int = 10, solver: str = "dense",
                damping: float = 0.0, pcg_iters: int = 250,
                inc: Incidence | None = None, update_mask=None,
                return_history: bool = False) -> LMResult:
    """Plain Gauss–Newton with a fixed trip count (the throughput unit).

    ``update_mask`` (optional, (tangent_dim,)) freezes variables: the
    Jacobian columns of masked-out slots are zeroed before assembly, so
    their step solves to exactly 0 and the step is Gauss-Newton on the
    free subset with the frozen variables as constants. ``inc`` routes the
    PCG solver through the gather path. ``return_history`` puts the chi2
    after each step in ``history``, (iterations,).
    """
    params = LMParams(solver=solver, pcg_iters=pcg_iters)
    hist = []
    for _ in range(iterations):
        blocks = linearize_blocks(graph, values)
        mask = used_slot_mask(values)
        if update_mask is not None:
            um = update_mask.to(mask.dtype)
            mask = mask * um
            blocks = [(r, J * um[cols][:, None, :], cols)
                      for r, J, cols in blocks]
        solve_fn, _, _ = _solvers(blocks, mask, params, inc)
        values = retract_all(values, solve_fn(damping))
        if return_history:
            hist.append(total_error(graph, values))
    if return_history:
        return LMResult(values, hist[-1], iterations, damping, True,
                        torch.stack(hist))
    return LMResult(values, total_error(graph, values), iterations, damping,
                    True)
