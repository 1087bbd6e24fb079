"""Multi-device execution: factor-sharded Gauss-Newton over a process group
(port of ``parallel/sharding.py``).

The JAX package shards every factor table along its leading axis over a
1-D device mesh with ``shard_map``; values stay replicated and each device
computes its shard's contribution to the normal equations, summed by
``psum``. The port runs the same SPMD program over a ``torch.distributed``
group, one process a rank (``launch.launch``): every rank calls the same
function with the whole graph, keeps its own slice of the sharded tables
(``shard_graph``), and every ``psum`` is one ``all_reduce(SUM)``
(``Mesh.all_reduce``, the only collective used). Results are replicated
on every rank, as JAX's ``out_specs=P()`` are.

Two solver paths, as the reference's:

- ``sharded_gn_pcg_step`` (the scalable default): matrix-free PCG. Nothing
  of size D^2 exists. Per GN step the ranks reduce the gradient (D) and the
  3x3 block-Jacobi diagonal (3D); each CG iteration then reduces ONE
  (D,) Hessian-vector product assembled from the local per-factor J^T J
  blocks.
- ``sharded_gn_step``: dense H reduced whole, then a replicated Cholesky.
  Exact GN in one collective pair; only for small graphs.

``sharded_ba_sqrt`` shards bundle adjustment over landmarks: each rank
eliminates its landmarks by the square-root Schur, and per GN step the
reduced camera system (Dp, Dp) and the landmark updates (Pq, 3) are
reduced once each.

Damping and the unused-slot identity are added after each reduction, once,
so the global system is the single-device solver's; its sums are taken in
another order, so results agree with ``gn_optimize`` to rounding, not
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.assemble import dense_hg, gradient_of
from ..graph.ba_solve import (_add_nonpoint_and_base, _backsub_points,
                              _landmark_qr_reduce, build_point_obs)
from ..graph.factors import FactorGraph, linearize_blocks, total_error
from ..graph.solve import inv33, solve_dense, solve_pcg_precond
from ..graph.variables import (VariableArena, layout_of, retract_all,
                               used_slot_mask)

__all__ = ["Mesh", "make_mesh", "shard_graph", "sharded_gn_step",
           "sharded_gn_pcg_step", "sharded_gn", "pad_graph_for_mesh",
           "sharded_ba_sqrt"]


class Mesh:
    """One rank's view of the process group: its ``rank`` of ``size``, the
    ``device`` its tensors live on and the group's ``backend``.
    ``all_reduce`` sums a tensor over the ranks in place (JAX's ``psum``)
    and counts the calls and bytes reduced (``calls``, ``bytes``)."""

    def __init__(self, rank: int, size: int, device, backend: str):
        self.rank, self.size = rank, size
        self.device, self.backend = torch.device(device), backend
        self.calls = 0
        self.bytes = 0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        dist.all_reduce(t)
        self.calls += 1
        self.bytes += t.numel() * t.element_size()
        return t


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """This rank's ``Mesh`` over the initialized process group.

    ``n_devices`` must be the group's size (or None). ``device`` defaults
    to the current card under NCCL and to the CPU under gloo; ``launch``
    passes each rank's own. Outside a process group it raises: start the
    ranks with ``launch(n, fn, ...)``, which calls ``fn(mesh, ...)`` on
    each.
    """
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh: this process is not in a torch.distributed process "
            "group; start the ranks with graph_slam_tpu_torch.parallel."
            "launch(n, fn, ...), which calls fn(mesh, ...) on each")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{size} ranks")
    backend = dist.get_backend()
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if backend == "nccl" else torch.device("cpu")
    return Mesh(dist.get_rank(), size, device, backend)


def pad_graph_for_mesh(graph: FactorGraph, n: int) -> FactorGraph:
    """Pad every factor table to a multiple of the mesh size: every leaf,
    ``active`` included, with zero rows (inactive)."""

    def pad_table(tab):
        cap = tab.active.shape[0]
        extra = -cap % n
        if extra == 0:
            return tab
        return type(tab)(*(torch.cat([x, x.new_zeros((extra, *x.shape[1:]))])
                           for x in tab))

    return FactorGraph(*(pad_table(t) for t in graph))


def _rows(x, mesh: Mesh):
    """This rank's contiguous block of ``x``'s rows (JAX's ``P(AXIS)``)."""
    cap = x.shape[0]
    if cap % mesh.size:
        raise ValueError(f"a table of {cap} rows does not divide over "
                         f"{mesh.size} ranks; pad_graph_for_mesh first")
    c = cap // mesh.size
    return x[mesh.rank * c:(mesh.rank + 1) * c]


def shard_graph(graph: FactorGraph, mesh: Mesh) -> FactorGraph:
    """This rank's slice of every factor table (capacities must divide the
    mesh size: see ``pad_graph_for_mesh``)."""
    return FactorGraph(*(type(t)(*(_rows(x, mesh) for x in t))
                         for t in graph))


def _gn_local(mesh: Mesh, graph: FactorGraph, values: VariableArena,
              damping):
    """This rank's shard of dense H and g, reduced; the unused-slot
    identity added once; the replicated solve."""
    mask = used_slot_mask(values)
    # an all-ones mask: dense_hg adds no identity; it is added after the sum
    H, g = dense_hg(linearize_blocks(graph, values), torch.ones_like(mask))
    mesh.all_reduce(H)
    mesh.all_reduce(g)
    H.diagonal().add_(1.0 - mask)
    return retract_all(values, solve_dense(H, g, damping))


def _gn_pcg_local(mesh: Mesh, graph: FactorGraph, values: VariableArena,
                  damping, pcg_iters: int):
    """Matrix-free sharded GN step on this rank's factor shard.

    Per-factor J^T J blocks once per linearization; each CG iteration's
    Hessian-vector product is one batched (td, td) matvec and scatter per
    factor type, then one (D,) reduction. Damping and the unused-slot
    identity are added after each reduction.
    """
    blocks = linearize_blocks(graph, values)
    mask = used_slot_mask(values)
    D = mask.shape[0]
    nblk = D // 3
    g = mesh.all_reduce(gradient_of(blocks, mask))
    pre = [(torch.einsum("fei,fej->fij", J, J), cols) for r, J, cols in blocks]

    # 3x3-aligned block-Jacobi preconditioner (every variable tangent is a
    # multiple of 3 wide at a 3-aligned offset): one (D/3, 3, 3) reduction
    Bd = torch.zeros(nblk, 3, 3, dtype=mask.dtype, device=mask.device)
    for JtJ, cols in pre:
        for p0 in range(0, cols.shape[1], 3):
            Bd.index_add_(0, cols[:, p0] // 3, JtJ[:, p0:p0 + 3, p0:p0 + 3])
    mesh.all_reduce(Bd)
    base = damping * torch.ones_like(mask) + (1.0 - mask)
    Minv = inv33(Bd + base.reshape(nblk, 3)[:, :, None]
                 * torch.eye(3, dtype=mask.dtype, device=mask.device))

    def hvp(v):
        out = torch.zeros_like(v)
        for JtJ, cols in pre:
            Hv = torch.einsum("fij,fj->fi", JtJ, v[cols])
            out.index_add_(0, cols.reshape(-1), Hv.reshape(-1))
        mesh.all_reduce(out)          # ONE (D,) reduction per CG iteration
        return out + damping * v + (1.0 - mask) * v

    def apply_precond(r):
        return torch.einsum("bij,bj->bi", Minv, r.reshape(nblk, 3)).reshape(-1)

    return retract_all(values, solve_pcg_precond(hvp, g, apply_precond,
                                                 pcg_iters))


def sharded_gn_step(mesh: Mesh):
    """A one-iteration dense-H GN step over the mesh: ``step(graph, values,
    damping) -> values``, ``graph`` the whole graph with capacities that
    divide the mesh size (``pad_graph_for_mesh``). The reduction moves the
    full (D, D) Hessian: for small graphs only; ``sharded_gn_pcg_step`` at
    scale."""

    def step(graph, values, damping):
        return _gn_local(mesh, shard_graph(graph, mesh), values, damping)

    return step


def sharded_gn_pcg_step(mesh: Mesh, pcg_iters: int = 100):
    """A matrix-free sharded GN step (O(D) collectives): ``step(graph,
    values, damping) -> values``, as ``sharded_gn_step``'s."""

    def step(graph, values, damping):
        return _gn_pcg_local(mesh, shard_graph(graph, mesh), values, damping,
                             pcg_iters)

    return step


def sharded_gn(mesh: Mesh, graph: FactorGraph, values: VariableArena,
               iterations: int = 8, damping: float = 0.0,
               solver: str = "pcg", pcg_iters: int = 100):
    """Run ``iterations`` sharded GN steps; returns ``(values,
    final_error)``, the error of the graph padded to the mesh size (the
    same sum: padded rows are inactive)."""
    if solver not in ("pcg", "dense"):
        raise ValueError(f"unknown solver {solver!r}")
    graph = pad_graph_for_mesh(graph, mesh.size)
    local = shard_graph(graph, mesh)
    for _ in range(iterations):
        if solver == "pcg":
            values = _gn_pcg_local(mesh, local, values, damping, pcg_iters)
        else:
            values = _gn_local(mesh, local, values, damping)
    return values, total_error(graph, values)


# ---------------------------------------------------------------------------
# Sharded bundle adjustment: square-root Schur with landmarks over the mesh


def sharded_ba_sqrt(mesh: Mesh, graph: FactorGraph, values: VariableArena,
                    iterations: int = 8, damping: float = 1e-6,
                    chunk: int = 2048):
    """Multi-device BA: the square-root Schur (``graph.ba_solve``) with the
    landmark eliminations split over the ranks. Graph and values are
    replicated (each rank gathers any projection rows of its landmarks);
    the landmark tables are split. Per GN step: one (Dp, Dp) and one (Dp,)
    reduction of the reduced camera system (float64, as
    ``_landmark_qr_reduce`` sums it), the non-point terms added once, the
    replicated solve, and one (Pq, 3) reduction of the back-substituted
    landmark updates. Returns ``(values, final_error)``.

    Landmarks pad to a multiple of the mesh size. A padded row's landmark
    index is past the last landmark, so it is dead (zero update); its
    update is written into a buffer of the padded length and cut off
    before the reduction (JAX clips such an index to the last row, where
    ``index_add_`` would raise).
    """
    lay = layout_of(values)
    dev = values.pose_t.device
    Pq = lay.point_cap
    tabs = list(build_point_obs(graph, Pq))
    Pq_pad = Pq + (-Pq % mesh.size)
    tabs = [np.pad(t, ((0, Pq_pad - Pq), (0, 0))) for t in tabs]
    q_ids = torch.arange(Pq_pad, device=dev)
    obs_idx, obs_valid, prior_row, prior_valid = (
        _rows(torch.as_tensor(t, device=dev), mesh) for t in tabs)
    q_loc = _rows(q_ids, mesh)
    for _ in range(iterations):
        (S, g), back = _landmark_qr_reduce(
            graph, values, lay, obs_idx, obs_valid, prior_row, prior_valid,
            q_loc, damping, chunk)
        mesh.all_reduce(S)
        mesh.all_reduce(g)
        S, g = _add_nonpoint_and_base(graph, values, lay, S, g, damping)
        dp = solve_dense(S, g, 0.0).to(values.pose_t.dtype)
        dq = torch.zeros(Pq_pad, 3, dtype=dp.dtype, device=dev)
        dq.index_add_(0, q_loc, _backsub_points(*back, dp))
        dq = mesh.all_reduce(dq[:Pq])
        values = retract_all(values, torch.cat([dp, dq.reshape(-1)]))
    return values, total_error(graph, values)
