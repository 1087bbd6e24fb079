"""Normal-equation assembly from linearized factor blocks (port of
``graph/assemble.py``).

Per-factor outer products ``J^T J`` are computed batched and scatter-added
(``index_put_``/``index_add_``; atomics on the card) into a dense Hessian,
or used matrix-free as Hessian-vector products for PCG. ``graph.lm``
builds its solvers on ``dense_hg`` and ``gradient_of``.
"""

from __future__ import annotations

import torch

from .factors import FactorGraph, linearize_blocks
from .variables import VariableArena, used_slot_mask

__all__ = ["assemble_dense", "gradient", "hvp_fn", "diag_precond"]


def gradient_of(blocks, mask):
    """g = J^T r over the global tangent layout from linearized blocks."""
    g = torch.zeros_like(mask)
    for r, J, cols in blocks:
        g.index_add_(0, cols.reshape(-1),
                     torch.einsum("fei,fe->fi", J, r).reshape(-1))
    return g


def dense_hg(blocks, mask):
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
    return H, gradient_of(blocks, mask)


def assemble_dense(graph: FactorGraph, values: VariableArena):
    """Dense (H, g) = (J^T J, J^T r) over the global tangent layout.

    Unused (padded) variable slots get a unit diagonal so Cholesky stays
    positive definite; their gradient entries are exactly zero, so their
    update is exactly zero.
    """
    return dense_hg(linearize_blocks(graph, values), used_slot_mask(values))


def gradient(graph: FactorGraph, values: VariableArena):
    """g = J^T r without forming H."""
    return gradient_of(linearize_blocks(graph, values),
                       used_slot_mask(values))


def hvp_fn(blocks, mask, lam):
    """Matrix-free v -> (H + lam I) v from linearized blocks: gather each
    factor's tangent slice, apply J then J^T, scatter-add."""

    def hvp(v):
        out = lam * v + (1.0 - mask) * v
        for r, J, cols in blocks:
            Jv = torch.einsum("fei,fi->fe", J, v[cols])
            out.index_add_(0, cols.reshape(-1),
                           torch.einsum("fei,fe->fi", J, Jv).reshape(-1))
        return out

    return hvp


def diag_precond(blocks, mask, lam):
    """Jacobi preconditioner diagonal of (H + lam I)."""
    d = lam * torch.ones_like(mask) + (1.0 - mask)
    for r, J, cols in blocks:
        d.index_add_(0, cols.reshape(-1),
                     torch.einsum("fei,fei->fi", J, J).reshape(-1))
    return d
