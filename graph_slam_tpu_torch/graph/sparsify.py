"""Pose marginalization with Chow-Liu sparsification (port of
``graph/sparsify.py``).

The reference bounds long-trajectory cost by *never creating* nodes
(keyframe gates, gtsam_graph.cpp:1790-1812) — once a pose is in the graph
it stays forever. Lifelong operation needs the other direction too:
removing poses already in the graph without throwing their information
away. Exact marginalization (Schur complement) densifies — the eliminated
pose's neighbors become an all-to-all clique — so the standard answer
(Kretzschmar & Stachniss; GLC, Carlevaris-Bianco & Eustice, ICRA 2013) is
to approximate the elimination clique's Gaussian by a **Chow-Liu tree**:
the best tree-factored approximation in KL divergence, realized here as
ordinary between factors so the arena never needs an n-ary factor type.

Because our between residual ``Log(Z^{-1} X_p^{-1} X_q)`` has identity
Jacobian in the child's tangent at zero residual, each directed tree edge
``p -> q`` is exactly a between factor with measurement
``X_p^{-1} X_q`` (current estimate) and information
``inv(cov(q | p))`` — the conditional covariance from the eliminated
clique's joint. No projection machinery needed.

Split, as the reference's: the local linearization is the port's
``_between_lin`` on the arena's device; the Schur complement, the Chow-Liu
tree (maximum-mutual-information spanning tree) and the graph surgery are
host numpy over small matrices, copied from the reference.

Scope: SE(3) pose graphs (prior + between factors). Dropping a pose that
carries a prior, or that any IMU/plane/projection factor touches, raises
— re-anchor (or marginalize the full VIO state) first.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import se3
from .builder import GraphBuilder
from .factors import FactorGraph, _between_lin
from .variables import VariableArena

__all__ = ["marginalize_poses", "chow_liu_tree"]


def chow_liu_tree(cov: np.ndarray, m: int,
                  root: int = 0) -> list[tuple[int, int]]:
    """Directed maximum-mutual-information spanning tree over ``m`` poses.

    ``cov`` is the (6m, 6m) joint covariance of the clique. Returns
    ``(parent, child)`` local-index pairs rooted at ``root`` (Prim's
    algorithm — the clique is complete, m is small). Gaussian mutual
    information:
    ``I(p;q) = 0.5 (logdet S_pp + logdet S_qq - logdet S_pq,pq)``.
    """
    if m < 2:
        return []

    def blk(a, b):
        return cov[6 * a:6 * a + 6, 6 * b:6 * b + 6]

    eps = 1e-12 * max(float(np.trace(cov)) / max(6 * m, 1), 1.0)

    def ld(M):
        return float(np.linalg.slogdet(M + eps * np.eye(len(M)))[1])

    w = np.full((m, m), -np.inf)
    for p in range(m):
        for q in range(p + 1, m):
            joint = np.block([[blk(p, p), blk(p, q)],
                              [blk(q, p), blk(q, q)]])
            mi = 0.5 * (ld(blk(p, p)) + ld(blk(q, q)) - ld(joint))
            w[p, q] = w[q, p] = mi
    in_tree = [root]
    edges: list[tuple[int, int]] = []
    while len(in_tree) < m:
        best, bp, bq = -np.inf, -1, -1
        for p in in_tree:
            for q in range(m):
                if q not in in_tree and w[p, q] > best:
                    best, bp, bq = w[p, q], p, q
        edges.append((bp, bq))
        in_tree.append(bq)
    return edges


def _clique_tree_factors(Hm: np.ndarray, m: int):
    """Tree-factored between-factor approximation of a (possibly
    gauge-singular) clique information matrix ``Hm`` over ``m`` poses.

    The eliminated clique carries RELATIVE information only (priors on
    dropped poses are forbidden), so ``Hm`` has the 6-dim gauge in its
    nullspace and a pinv-based covariance degenerates (conditioning in
    the gauge-orthogonal subspace collapses to zero — verified on the
    1-dof analog H=[[1,-1],[-1,1]]). Condition on a ROOT pose instead:
    the non-root submatrix of ``Hm`` is the full-rank precision of the
    others GIVEN the root, its inverse a proper covariance. The Chow-Liu
    tree is built there and attached to the root through the node with
    the tightest conditional marginal.

    Returns ``[(parent, child, info_6x6), ...]`` in local clique indices
    (root = 0). Exact for ``m == 2`` (single composed edge).
    """
    sub = np.linalg.inv(Hm[6:, 6:] + 1e-12 * np.eye(6 * (m - 1)))
    sub = 0.5 * (sub + sub.T)

    def blk(S, a, b):
        return S[6 * a:6 * a + 6, 6 * b:6 * b + 6]

    def info_of(S):
        return np.linalg.inv(0.5 * (S + S.T)
                             + 1e-12 * np.trace(S) / 6 * np.eye(6))

    if m == 2:
        return [(0, 1, info_of(sub))]
    # attach the root to the node it constrains most tightly
    lds = [float(np.linalg.slogdet(blk(sub, k, k))[1]) for k in range(m - 1)]
    attach = int(np.argmin(lds))
    out = [(0, attach + 1, info_of(blk(sub, attach, attach)))]
    for p, q in chow_liu_tree(sub, m - 1, root=attach):
        Spp = blk(sub, p, p)
        Sqq = blk(sub, q, q)
        Spq = blk(sub, p, q)
        Sc = Sqq - Spq.T @ np.linalg.solve(
            Spp + 1e-12 * np.trace(Spp) / 6 * np.eye(6), Spq)
        out.append((p + 1, q + 1, info_of(Sc)))
    return out


def _local_information(graph: FactorGraph, values: VariableArena,
                       rows: np.ndarray, order: dict[int, int]):
    """Assemble the information matrix of the between rows ``rows`` over
    the local variable ``order`` (pose id -> local slot), whitened and
    robust-weighted at the current estimate."""
    bt = graph.between
    _, J = _between_lin(values, bt)   # (F, 6, 12) whitened + masked
    J = J.cpu().numpy()[rows]
    i = bt.i.cpu().numpy()[rows]
    j = bt.j.cpu().numpy()[rows]
    n = len(order)
    H = np.zeros((6 * n, 6 * n))
    for k in range(len(rows)):
        si, sj = order[int(i[k])] * 6, order[int(j[k])] * 6
        Ji, Jj = J[k, :, :6], J[k, :, 6:]
        H[si:si + 6, si:si + 6] += Ji.T @ Ji
        H[sj:sj + 6, sj:sj + 6] += Jj.T @ Jj
        H[si:si + 6, sj:sj + 6] += Ji.T @ Jj
        H[sj:sj + 6, si:si + 6] += Jj.T @ Ji
    return H


def _to_host(tree):
    """A NamedTuple tree of tensors -> the same tree of numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return type(tree)(*(_to_host(x) for x in tree))


def marginalize_poses(graph: FactorGraph, values: VariableArena,
                      drop, bucket: int = 64):
    """Remove poses ``drop`` from an SE(3) pose graph, replacing their
    factors with a Chow-Liu tree of between factors over the blanket.

    ``values`` should be the optimized estimate (the linearization point
    of the approximation). Returns ``(graph, values, old2new)`` on the
    arena's device and dtype, where ``old2new`` maps surviving original
    pose ids to their new ids.
    """
    host_graph, host_values = _to_host(graph), _to_host(values)
    bt = host_graph.between
    active = bt.active
    bi, bj = bt.i, bt.j
    n_pose = int(values.num_poses)
    drop = np.unique(np.asarray(drop, int))
    if drop.size and (drop.min() < 0 or drop.max() >= n_pose):
        raise ValueError(f"drop ids out of range [0, {n_pose})")
    dropped = np.zeros(n_pose, bool)
    dropped[drop] = True

    # scope guards: pose-graph factors only
    pp = host_graph.prior_pose
    pp_idx, pp_active = pp.idx, pp.active
    if dropped[pp_idx[pp_active]].any():
        raise ValueError("cannot drop a pose carrying a prior factor — "
                         "re-anchor the graph first")
    # the rebuild copies pose priors and between rows only — reject any
    # graph carrying other factor types instead of silently dropping them
    for name in ("imu", "plane", "projection", "prior_point", "prior_vel",
                 "prior_bias"):
        if getattr(host_graph, name).active.any():
            raise ValueError(f"marginalize_poses supports pose graphs only "
                             f"(active {name} factors present)")

    touches = active & (dropped[bi] | dropped[bj])
    rows = np.flatnonzero(touches)

    # the blanket: kept poses adjacent to any dropped pose through F_d
    blanket = np.unique(np.concatenate([
        bi[rows][~dropped[bi[rows]]], bj[rows][~dropped[bj[rows]]]]))
    local = list(drop) + list(blanket)
    order = {int(p): k for k, p in enumerate(local)}
    nd, m = len(drop), len(blanket)

    new_edges = []   # (p, q, Z_R, Z_t, info) over ORIGINAL pose ids
    if rows.size and m >= 2:
        H = _local_information(graph, values, rows, order)
        Hdd = H[:6 * nd, :6 * nd]
        Hdb = H[:6 * nd, 6 * nd:]
        Hbb = H[6 * nd:, 6 * nd:]
        # eliminated info over the blanket (dense clique)
        Hm = Hbb - Hdb.T @ np.linalg.solve(
            Hdd + 1e-12 * np.eye(6 * nd), Hdb)
        Hm = 0.5 * (Hm + Hm.T)
        for p, q, info in _clique_tree_factors(Hm, m):
            if float(np.trace(info)) < 1e-8:
                # disconnected-drop artifact: the clique carries no real
                # coupling between these blanket poses — don't invent an
                # (information ~ jitter) edge between unrelated poses
                continue
            gp, gq = int(blanket[p]), int(blanket[q])
            # the between residual has identity child Jacobian at zero
            # residual, so the conditional information IS the factor
            # information and the measurement is the current relative pose
            Z = se3.between(
                se3.Pose(values.pose_R[gp], values.pose_t[gp]),
                se3.Pose(values.pose_R[gq], values.pose_t[gq]))
            new_edges.append((gp, gq, Z.R.cpu().numpy(), Z.t.cpu().numpy(),
                              info))

    # rebuild: kept poses at the current estimate, surviving factors
    # remapped, Chow-Liu edges appended
    keep = np.flatnonzero(~dropped)
    old2new = {int(p): k for k, p in enumerate(keep)}
    b = GraphBuilder()
    R, t = host_values.pose_R, host_values.pose_t
    for p in keep:
        b.add_pose((R[p], t[p]))
    for k in np.flatnonzero(pp_active):
        b.add_prior_pose(old2new[int(pp_idx[k])], (pp.mean_R[k], pp.mean_t[k]),
                         sqrt_info=pp.sqrt_info[k],
                         robust=(float(pp.robust_k[k]) if pp.robust_kind[k]
                                 else None))
    for k in np.flatnonzero(active & ~touches):
        b.add_between(old2new[int(bi[k])], old2new[int(bj[k])],
                      (bt.meas_R[k], bt.meas_t[k]), sqrt_info=bt.sqrt_info[k],
                      robust=(float(bt.robust_k[k]) if bt.robust_kind[k]
                              else None))
    for gp, gq, ZR, Zt, info in new_edges:
        b.add_between(old2new[gp], old2new[gq], (ZR, Zt), information=info)
    graph2, values2 = b.build(bucket=bucket, device=values.pose_t.device,
                              dtype=values.pose_t.dtype)
    return graph2, values2, old2new
