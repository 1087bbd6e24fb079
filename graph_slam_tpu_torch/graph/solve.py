"""Linear solvers for the damped normal equations (port of
``graph/solve.py``).

- ``solve_dense``: Cholesky of the dense (H + lam I) and two triangular
  solves (cuSOLVER/cuBLAS on the card, LAPACK on the CPU).
- ``solve_pcg`` / ``solve_pcg_precond``: preconditioned conjugate
  gradients with a fixed trip count and no convergence test, so results
  match the reference's ``fori_loop`` iteration for iteration.
"""

from __future__ import annotations

import torch

__all__ = ["solve_dense", "solve_pcg", "solve_pcg_precond", "inv33"]


def solve_dense(H, g, lam):
    """delta = -(H + lam I)^-1 g via Cholesky.

    Where (H + lam I) is not positive definite the step is NaN, as the
    reference's Cholesky gives, so the LM trial rejects it; no host sync.
    """
    Hd = H.clone()
    Hd.diagonal().add_(lam)   # H + lam I without a (D, D) identity
    L, info = torch.linalg.cholesky_ex(Hd)
    y = torch.linalg.solve_triangular(L, -g[:, None], upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def solve_pcg(hvp, g, precond_diag, max_iters: int = 250):
    """delta = -(H + lam I)^-1 g by Jacobi-preconditioned CG, fixed trips."""
    Minv = 1.0 / precond_diag
    return solve_pcg_precond(hvp, g, lambda r: Minv * r, max_iters)


def solve_pcg_precond(hvp, g, apply_precond, max_iters: int = 250):
    """PCG with a general preconditioner application (block-Jacobi etc.)."""
    b = -g
    x = torch.zeros_like(b)
    r = b
    z = apply_precond(b)
    p = z
    rz = torch.sum(b * z)
    for _ in range(max_iters):
        Ap = hvp(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-300)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_precond(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-300)
        p = z + beta * p
        rz = rz_new
    return x


def inv33(A):
    """Closed-form batched 3x3 inverse (adjugate / determinant).

    The reference wrote it to avoid a slow batched-inverse call on its
    accelerator; the port keeps it because it is cheap and keeps parity.
    """
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / det
    return torch.stack([
        torch.stack([A11, A12, A13], -1),
        torch.stack([A21, A22, A23], -1),
        torch.stack([A31, A32, A33], -1),
    ], -2) * inv_det[..., None, None]
