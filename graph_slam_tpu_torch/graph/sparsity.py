"""Static sparsity structure: degree-padded incidence gathers (port of
``graph/sparsity.py``).

For every global tangent slot a padded list of the per-(factor, column)
contributions that accumulate into it is built once on the host, so the
matrix-free products of the CG loop become a gather and a row sum with no
scatter:

    J^T x : contrib[f, c] computed batched -> y[d] = sum_k contrib_flat[inc[d, k]]

The same incidence serves the gradient, the Hessian-vector product and the
Jacobi preconditioner diagonal. One extra zero row at the end of the flat
contribution buffer absorbs the padding. A gather sums each slot's
contributions in a fixed order, where the card's scatter-add atomics do
not.

The host-side index build (``_np_cols``) is a numpy copy of the
reference's, every factor table included.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .factors import FactorGraph
from .variables import VariableArena, layout_of

__all__ = ["Incidence", "build_incidence", "gather_sum", "hvp_fn_gather",
           "gradient_gather", "diag_gather"]


class Incidence(NamedTuple):
    """(D, K) gather indices into the flat per-(factor, column) buffer."""

    idx: torch.Tensor     # int64 (D, K); pad entries point at the zero row
    n_flat: int           # total flat contributions (pad row = n_flat)

    @property
    def dim(self) -> int:
        return self.idx.shape[0]


def _host(x):
    return x.detach().cpu().numpy()


def _np_cols(graph: FactorGraph, values: VariableArena):
    """Host-side replica of ``linearize_blocks``' column layout (numpy)."""
    lay = layout_of(values)

    def cols_of(off, width, idx):
        return off + width * _host(idx)[:, None] + np.arange(width)

    def pose_cols(idx):
        return cols_of(lay.pose_off, 6, idx)

    def vel_cols(idx):
        return cols_of(lay.vel_off, 3, idx)

    def bias_cols(idx):
        return cols_of(lay.bias_off, 6, idx)

    def plane_cols(idx):
        return cols_of(lay.plane_off, 3, idx)

    def point_cols(idx):
        return cols_of(lay.point_off, 3, idx)

    cols = []     # (F, td) global column ids per table
    actives = []  # (F,) bool per table
    g = graph
    if g.prior_pose.idx.shape[0]:
        cols.append(pose_cols(g.prior_pose.idx))
        actives.append(_host(g.prior_pose.active))
    if g.between.i.shape[0]:
        cols.append(np.concatenate(
            [pose_cols(g.between.i), pose_cols(g.between.j)], axis=1))
        actives.append(_host(g.between.active))
    if g.prior_vel.idx.shape[0]:
        cols.append(vel_cols(g.prior_vel.idx))
        actives.append(_host(g.prior_vel.active))
    if g.prior_bias.idx.shape[0]:
        cols.append(bias_cols(g.prior_bias.idx))
        actives.append(_host(g.prior_bias.active))
    if g.plane.pose_idx.shape[0]:
        cols.append(np.concatenate(
            [pose_cols(g.plane.pose_idx), plane_cols(g.plane.plane_idx)],
            axis=1))
        actives.append(_host(g.plane.active))
    if g.imu.i.shape[0]:
        cols.append(np.concatenate(
            [pose_cols(g.imu.i), vel_cols(g.imu.i), bias_cols(g.imu.i),
             pose_cols(g.imu.j), vel_cols(g.imu.j), bias_cols(g.imu.j)],
            axis=1))
        actives.append(_host(g.imu.active))
    if g.projection.pose_idx.shape[0]:
        cols.append(np.concatenate(
            [pose_cols(g.projection.pose_idx),
             point_cols(g.projection.point_idx)], axis=1))
        actives.append(_host(g.projection.active))
    if g.prior_point.idx.shape[0]:
        cols.append(point_cols(g.prior_point.idx))
        actives.append(_host(g.prior_point.active))
    return cols, actives, lay.dim


def build_incidence(graph: FactorGraph, values: VariableArena,
                    pad_to_multiple: int = 1) -> Incidence:
    """Host-side construction of the slot -> contributions gather table,
    uploaded to the arena's device.

    Must be called with the same (padded) graph the optimizer will see.
    Only *active* rows enter the gather lists (padded rows contribute exact
    zeros and would otherwise pile useless entries onto variable slot 0,
    widening K). Rebuild after activating new rows.
    """
    cols_list, active_list, dim = _np_cols(graph, values)
    flats = []
    offset = 0
    for c, a in zip(cols_list, active_list):
        F, td = c.shape
        flat_idx = offset + np.arange(F * td)
        slots = c.reshape(-1)
        live = np.repeat(a, td)
        flats.append(np.stack([slots[live], flat_idx[live]]))
        offset += F * td
    if flats:
        slots_live = np.concatenate([f[0] for f in flats])
        flatidx_live = np.concatenate([f[1] for f in flats])
    else:
        slots_live = np.zeros(0, np.int64)
        flatidx_live = np.zeros(0, np.int64)
    n_flat = offset

    order = np.argsort(slots_live, kind="stable")
    sorted_slots = slots_live[order]
    order = flatidx_live[order]
    counts = np.bincount(sorted_slots, minlength=dim)
    K = int(counts.max()) if n_flat else 1
    K = max(K, 1)
    if pad_to_multiple > 1:
        K = ((K + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple

    idx = np.full((dim, K), n_flat, dtype=np.int64)  # pad -> zero row
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    # position of each sorted element within its slot's run
    pos_in_run = np.arange(sorted_slots.shape[0]) - np.repeat(starts, counts)
    idx[sorted_slots, pos_in_run] = order
    return Incidence(idx=torch.as_tensor(idx, device=values.pose_t.device),
                     n_flat=n_flat)


def gather_sum(inc: Incidence, contrib_flat):
    """Accumulate flat contributions into the global tangent vector."""
    padded = torch.cat([contrib_flat, contrib_flat.new_zeros(1)])
    return torch.sum(padded[inc.idx], dim=1)


def _cat(parts, dtype, device):
    if parts:
        return torch.cat(parts)
    return torch.zeros(0, dtype=dtype, device=device)


def hvp_fn_gather(blocks, inc: Incidence, mask, lam):
    """v -> (H + lam I) v with gather-only accumulation (no scatter)."""

    def hvp(v):
        parts = []
        for r, J, cols in blocks:
            Jv = torch.einsum("fei,fi->fe", J, v[cols])
            parts.append(torch.einsum("fei,fe->fi", J, Jv).reshape(-1))
        contrib = _cat(parts, v.dtype, v.device)
        return gather_sum(inc, contrib) + lam * v + (1.0 - mask) * v

    return hvp


def gradient_gather(blocks, inc: Incidence, dtype):
    """g = J^T r via the incidence gather."""
    parts = [torch.einsum("fei,fe->fi", J, r).reshape(-1)
             for r, J, cols in blocks]
    return gather_sum(inc, _cat(parts, dtype, inc.idx.device))


def diag_gather(blocks, inc: Incidence, mask, lam):
    """Jacobi preconditioner diagonal via the incidence gather."""
    parts = [torch.einsum("fei,fei->fi", J, J).reshape(-1)
             for r, J, cols in blocks]
    contrib = _cat(parts, mask.dtype, mask.device)
    return (gather_sum(inc, contrib) + lam * torch.ones_like(mask)
            + (1.0 - mask))
