"""Block-banded Hessian solvers for local pose graphs (port of
``graph/banded.py``).

SLAM pose graphs are band-limited: odometry links neighbours and loop
closures span at most the lookback window (sphere2500's synthetic loops
span < 50 poses). Within a half-bandwidth ``W`` blocks the Hessian is
block-banded, stored as ``Hband (P, 2W+1, 6, 6)`` with ``H[p, p + w - W] =
Hband[p, w]``, and its product with a vector is

    out[p] = sum_w  Hband[p, w] @ v[p + w - W]

one batched matvec over sliding windows of the padded block vector; the
scatter happens once per linearization (band assembly), never in the CG
loop. ``banded_gn_optimize`` runs PCG on it with a 6x6 block-Jacobi
preconditioner.

``banded_direct_gn_optimize`` groups S >= W consecutive poses into
superblocks of dimension 6S: the banded Hessian is then block-tridiagonal
in superblocks, and one GN step is an exact solve by the block Thomas
algorithm. The reference's two ``lax.scan``s are host loops here over
K = ceil(P / S) superblocks of dense (6S, 6S) ``cholesky_ex`` /
``cholesky_solve`` and matmuls (S = 64 at sphere2500: 40 superblocks of
384 x 384).

Scope: pose-only graphs (between + prior_pose factors); any other factor
table raises ``NotImplementedError``. A graph whose span exceeds ``band_w``
raises ``ValueError``, checked on the host once per call (the reference
leaves that check to its callers; blocks beyond the band would drop).
"""

from __future__ import annotations

import numpy as np
import torch

from .factors import FactorGraph, linearize_blocks, total_error
from .solve import solve_pcg_precond
from .variables import VariableArena, layout_of, retract_all, used_slot_mask

__all__ = ["band_halfwidth", "banded_gn_optimize",
           "banded_direct_gn_optimize"]


def band_halfwidth(graph: FactorGraph) -> int:
    """Max |j - i| over active between factors (read on the host)."""
    bt = graph.between
    act = bt.active.cpu().numpy()
    if not act.any():
        return 0
    i = bt.i.cpu().numpy()[act]
    j = bt.j.cpu().numpy()[act]
    return int(np.abs(j - i).max())


def _check_span(graph: FactorGraph, W: int):
    span = band_halfwidth(graph)
    if span > W:
        raise ValueError(f"band_w={W} is narrower than the graph's span "
                         f"{span} (band_halfwidth)")


def _assemble_band(graph: FactorGraph, values: VariableArena, W: int):
    """(Hband (P, 2W+1, 6, 6), g (D,)) from one linearization.

    Only between and prior_pose rows contribute; the band index of a
    factor (i, j) block H_ij is ``j - i + W``.
    """
    lay = layout_of(values)
    P = lay.pose_cap
    dt, dev = values.pose_t.dtype, values.pose_t.device
    Hband = torch.zeros(P, 2 * W + 1, 6, 6, dtype=dt, device=dev)
    g = torch.zeros(lay.dim, dtype=dt, device=dev)
    for r, J, cols in linearize_blocks(graph, values):
        g.index_add_(0, cols.reshape(-1),
                     torch.einsum("fei,fe->fi", J, r).reshape(-1))
        JtJ = torch.einsum("fei,fej->fij", J, J)
        bi = cols[:, 0] // 6
        if cols.shape[1] == 6:            # prior: diagonal block only
            Hband.index_put_((bi, torch.full_like(bi, W)), JtJ,
                             accumulate=True)
        elif cols.shape[1] == 12:         # between: (i,i) (i,j) (j,i) (j,j)
            bj = cols[:, 6] // 6
            off = bj - bi
            rows = torch.cat([bi, bj, bi, bj])
            band = torch.cat([torch.full_like(bi, W), torch.full_like(bj, W),
                              W + off, W - off])
            Hband.index_put_((rows, band), torch.cat([
                JtJ[:, :6, :6], JtJ[:, 6:, 6:], JtJ[:, :6, 6:],
                JtJ[:, 6:, :6]]), accumulate=True)
        else:                              # non-pose factor: out of scope
            raise NotImplementedError(
                "banded solver supports pose-only graphs")
    return Hband, g


def _band_matvec_fn(Hband, mask, lam, W: int):
    """v -> (H + lam I) v with no scatter: the 2W+1 windows of the padded
    block vector are an ``unfold`` view, the product one batched matvec."""
    P = Hband.shape[0]

    def matvec(v):
        vp = torch.nn.functional.pad(v.reshape(P, 6), (0, 0, W, W))
        V = vp.unfold(0, 2 * W + 1, 1)                 # (P, 6, 2W+1)
        out = torch.einsum("pwij,pjw->pi", Hband, V).reshape(-1)
        return out + lam * v + (1.0 - mask) * v

    return matvec


def _superblock_tridiag(Hband, g, W: int, S: int):
    """Regroup the block band into superblock tridiagonal form.

    ``Hband`` (P, 2W+1, 6, 6) with W <= S -> ``A`` (K, 6S, 6S) diagonal
    superblocks, ``B`` (K-1, 6S, 6S) upper off-diagonals, ``gs`` (K, 6S),
    where K = P / S (the caller pads P to a multiple of S). Entry (a, b) of
    superblock (k, k+d) is block H[kS+a, (k+d)S+b] = Hband[kS+a,
    W + dS + b - a], which exists iff |dS + b - a| <= W.
    """
    P = Hband.shape[0]
    K = P // S
    dev = Hband.device
    a = torch.arange(S, device=dev)[:, None]
    b = torch.arange(S, device=dev)[None, :]

    def gather(d):
        off = d * S + b - a                       # (S, S) band offsets
        ok = off.abs() <= W
        w = torch.clamp(off + W, 0, 2 * W)
        p = torch.arange(K, device=dev)[:, None, None] * S + a[None]
        blocks = Hband[p, w[None]]                # (K, S, S, 6, 6)
        blocks = blocks * ok[None, :, :, None, None].to(Hband.dtype)
        return blocks.permute(0, 1, 3, 2, 4).reshape(K, 6 * S, 6 * S)

    return gather(0), gather(1)[:-1], g.reshape(K, 6 * S)


def _solve_block_tridiag(A, B, gs):
    """Exact solve of the superblock-tridiagonal system (block Thomas):

        C_0 = A_0,  y_0 = g_0
        C_k = A_k - B_{k-1}^T C_{k-1}^{-1} B_{k-1}
        y_k = g_k - B_{k-1}^T C_{k-1}^{-1} y_{k-1}
        x_{K-1} = C_{K-1}^{-1} y_{K-1};  x_k = C_k^{-1} (y_k - B_k x_{k+1})
    """
    K = A.shape[0]
    Ls, ys = [], []
    for k in range(K):
        C, y = A[k], gs[k][:, None]
        if k:
            CinvB = torch.cholesky_solve(B[k - 1], Ls[-1])
            Cinvy = torch.cholesky_solve(ys[-1], Ls[-1])
            C = C - B[k - 1].T @ CinvB
            y = y - B[k - 1].T @ Cinvy
        Ls.append(torch.linalg.cholesky_ex(C)[0])
        ys.append(y)
    xs = [None] * K
    x = torch.cholesky_solve(ys[-1], Ls[-1])
    xs[-1] = x
    for k in range(K - 2, -1, -1):
        x = torch.cholesky_solve(ys[k] - B[k] @ x, Ls[k])
        xs[k] = x
    return torch.cat(xs).reshape(-1)


def banded_direct_gn_optimize(graph: FactorGraph, values: VariableArena,
                              iterations: int = 10, band_w: int = 64,
                              super_s: int = 0, damping: float = 0.0):
    """Gauss-Newton with an EXACT banded direct solve per iteration.

    The band is regrouped into superblocks of ``super_s`` poses (default
    max(band_w, 32), at least ``band_w`` so the coupling stays
    tridiagonal) and solved by the block Thomas algorithm. A trailing
    partial superblock is padded with identity blocks. Returns ``(values,
    chi2)``.
    """
    S = super_s if super_s else max(band_w, 32)
    if S < band_w:
        raise ValueError("super_s must be >= band_w")
    _check_span(graph, band_w)
    dt, dev = values.pose_t.dtype, values.pose_t.device
    P = layout_of(values).pose_cap
    pad_p = (-P) % S
    eye6 = torch.eye(6, dtype=dt, device=dev)
    for _ in range(iterations):
        mask = used_slot_mask(values)
        Hband, g = _assemble_band(graph, values, band_w)
        # damping and unused-slot anchoring on the block diagonal
        diag = (damping * mask + (1.0 - mask)).reshape(-1, 6)
        Hband[:, band_w] += diag[:, :, None] * eye6
        rhs = -g            # GN step: (H + lam I) delta = -g
        if pad_p:
            pad = torch.zeros(pad_p, *Hband.shape[1:], dtype=dt, device=dev)
            pad[:, band_w] = eye6       # identity keeps the Cholesky PD
            Hband = torch.cat([Hband, pad])
            rhs = torch.cat([rhs, torch.zeros(6 * pad_p, dtype=dt,
                                              device=dev)])
        A, B, gs = _superblock_tridiag(Hband, rhs, band_w, S)
        delta = _solve_block_tridiag(A, B, gs)[:6 * P]
        values = retract_all(values, delta)
    return values, total_error(graph, values)


def banded_gn_optimize(graph: FactorGraph, values: VariableArena,
                       iterations: int = 10, band_w: int = 64,
                       damping: float = 0.0, pcg_iters: int = 10):
    """Gauss-Newton with the block-banded scatter-free CG inner loop and a
    6x6 block-Jacobi preconditioner (``inv_ex``, no status read). Returns
    ``(values, chi2)``."""
    _check_span(graph, band_w)
    dt, dev = values.pose_t.dtype, values.pose_t.device
    eye6 = torch.eye(6, dtype=dt, device=dev)
    for _ in range(iterations):
        mask = used_slot_mask(values)
        Hband, g = _assemble_band(graph, values, band_w)
        Bd = Hband[:, band_w] + (damping * mask + (1.0 - mask)).reshape(
            -1, 6)[:, :, None] * eye6
        Minv = torch.linalg.inv_ex(Bd)[0]

        def precond(r):
            return torch.einsum("pij,pj->pi", Minv,
                                r.reshape(-1, 6)).reshape(-1)

        delta = solve_pcg_precond(_band_matvec_fn(Hband, mask, damping,
                                                  band_w),
                                  g, precond, pcg_iters)
        values = retract_all(values, delta)
    return values, total_error(graph, values)
