"""Batched multi-graph solving: one call optimizes a fleet (port of
``graph/batch.py``).

The arenas are struct-of-arrays with static padded shapes, so K
same-capacity graphs are a leading batch axis. ``gn_optimize_many`` maps
``gn_optimize`` over that axis with ``torch.func.vmap``: every operation of
the Gauss-Newton loop (linearization, the scatter-adds, the solve, the
retraction) runs once for the whole fleet, with each graph's indices
kept to its own slice. The fleet is deliberately NOT folded into one
block-diagonal graph: PCG's step sizes alpha and beta are reductions, and
one shared pair would make each graph's iterates differ from its own
``gn_optimize``; under the map every dot product is per graph.

``sharded_gn_many`` adds the batch axis over the ranks of a process group
(``parallel``): each rank solves its slice of the fleet with
``gn_optimize_many``, and the whole batch's result is assembled on every
rank by one sum of zero-filled buffers per leaf (graphs are independent,
so no collective runs inside the solve).
"""

from __future__ import annotations

import torch

from .factors import FactorGraph
from .lm import LMResult, gn_optimize
from .variables import VariableArena

__all__ = ["stack_pytrees", "unstack_pytree", "gn_optimize_many",
           "solve_many", "sharded_gn_many"]


def _map(fn, *trees):
    """Apply ``fn`` leaf-wise over NamedTuples, tuples and lists of tensors
    of the same structure."""
    first = trees[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_pytrees(items):
    """Stack a list of identically-shaped trees along a new axis 0."""
    return _map(lambda *xs: torch.stack(xs), *items)


def unstack_pytree(tree, n: int):
    """Inverse of :func:`stack_pytrees`: a list of ``n`` unbatched trees."""
    return [_map(lambda x: x[k], tree) for k in range(n)]


def gn_optimize_many(graphs: FactorGraph, values: VariableArena,
                     iterations: int = 10, solver: str = "pcg",
                     damping: float = 0.0,
                     pcg_iters: int = 250) -> LMResult:
    """Fixed-trip GN over a BATCH of graphs (leading axis on every leaf).

    All graphs must share arena capacities and factor-table buckets (pad
    with :func:`graph.round_up` buckets as usual; masking keeps the math
    exact). Returns an :class:`LMResult` whose ``values`` and ``error``
    carry the batch axis.
    """

    def one(graph, vals):
        res = gn_optimize(graph, vals, iterations=iterations, solver=solver,
                          damping=damping, pcg_iters=pcg_iters)
        return res.values, res.error

    vals, err = torch.func.vmap(one)(graphs, values)
    return LMResult(vals, err, iterations, damping, True)


def _shapes(tree):
    return _map(lambda x: tuple(x.shape), tree)


def solve_many(pairs, iterations: int = 10, solver: str = "pcg",
               damping: float = 0.0, pcg_iters: int = 250):
    """``[(graph, values), ...]`` -> ``[LMResult, ...]``: stacks, runs
    :func:`gn_optimize_many`, unstacks. Raises if the graphs do not share
    their padded shapes."""
    graphs = [g for g, _ in pairs]
    arenas = [v for _, v in pairs]
    first = _shapes(graphs[0])
    if any(_shapes(g) != first for g in graphs[1:]):
        raise ValueError(
            "solve_many requires identical bucket/capacity shapes "
            "across graphs; rebuild with a common bucket")
    res = gn_optimize_many(stack_pytrees(graphs), stack_pytrees(arenas),
                           iterations=iterations, solver=solver,
                           damping=damping, pcg_iters=pcg_iters)
    return [LMResult(v, e, res.iterations, res.lam, res.converged)
            for v, e in zip(unstack_pytree(res.values, len(pairs)),
                            res.error)]


def sharded_gn_many(mesh, graphs: FactorGraph, values: VariableArena,
                    iterations: int = 10, solver: str = "pcg",
                    damping: float = 0.0, pcg_iters: int = 250) -> LMResult:
    """Batch-of-graphs GN with the BATCH axis split over the ranks of
    ``mesh`` (``parallel.make_mesh``): pure data parallelism over
    independent problems. Every rank passes the whole batch and gets the
    whole batch's :class:`LMResult`. The batch size must be divisible by the
    mesh size. (Contrast ``parallel.sharded_gn``, which splits the FACTORS
    of one large graph and reduces once per CG iteration.)
    """
    b = values.pose_t.shape[0]
    if b % mesh.size:
        raise ValueError(f"batch {b} not divisible by mesh size {mesh.size}")
    c = b // mesh.size
    mine = slice(mesh.rank * c, (mesh.rank + 1) * c)
    res = gn_optimize_many(_map(lambda x: x[mine], graphs),
                           _map(lambda x: x[mine], values),
                           iterations=iterations, solver=solver,
                           damping=damping, pcg_iters=pcg_iters)

    def whole(x):
        out = x.new_zeros((b, *x.shape[1:]))
        out[mine] = x
        return mesh.all_reduce(out)

    return LMResult(_map(whole, res.values), whole(res.error), iterations,
                    damping, True)
