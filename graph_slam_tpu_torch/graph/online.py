"""Online graph engine: preallocated arenas + in-place row writes (port of
``graph/online.py``).

The arenas are allocated at capacity once; every "add" writes rows of
the preallocated tensors in place and bumps a host-side slot counter, so
nothing changes shape while the trajectory grows. Row writes take Python
ints or slices for slots, and Python scalars (filled on the device, as
kernel arguments) or device tensors for values, so writing rows on the
card issues no host sync.

``windowed_gn`` is the compact fixed-lag Gauss–Newton step: the whitened
Jacobian rows of a suffix window are scattered through a column map into a
stacked matrix of the window's width and the damped least squares is
solved by QR (cuSOLVER on the card). ``IncrementalOptimizer`` is the
ISAM2-role estimator of the online engine: warm-started GN steps over the
whole arena, or the fixed-lag step over the last ``window`` frames.

``grow`` re-homes the arenas at larger capacities; ``save_state`` and
``load_state`` checkpoint the whole engine state in the reference's
``.npz`` layout, so a checkpoint of the JAX package loads here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import se3
from ..device import resolve, upload
from .factors import (TABLE_TYPES, FactorGraph, empty_table,
                      linearize_blocks, total_error)
from .lm import LMParams, LMResult, gn_optimize, lm_optimize
from .variables import (VariableArena, empty_arena, layout_of, retract_all,
                        used_slot_mask)

__all__ = ["OnlineGraph", "IncrementalOptimizer", "window_graph",
           "windowed_gn", "between_row", "imu_row"]

# factor-table field order used for window starts/caps
_TABLES = FactorGraph._fields


def _window_caps(graph, window):
    """Per-table row caps of the fixed-lag window (``_TABLES`` order; the
    reference's ``IncrementalOptimizer._window_caps``), from the live
    graph's tables: the last ``8 W`` between, ``W`` IMU, ``4 W`` plane and
    ``16 W`` projection rows, every row of the other tables; ``window``
    None is the whole graph."""
    want = {"between": 8 * window, "imu": window, "plane": 4 * window,
            "projection": 16 * window} if window else {}
    return tuple(min(tb[0].shape[0], want.get(nm, tb[0].shape[0]))
                 for nm, tb in zip(_TABLES, graph))


def _window_starts(counts, caps):
    """Each table's window start: its last ``caps`` rows of the ``counts``
    rows used (a dict by table name; absent tables hold none)."""
    return [max(0, counts.get(nm, 0) - caps[t])
            for t, nm in enumerate(_TABLES)]


def _put(col, slot, value):
    """``col[slot] = value`` in place. A Python scalar is filled on the
    device: assigning one stages it through a host-to-device copy, which
    waits for the card."""
    if isinstance(value, torch.Tensor):
        col[slot] = value
    else:
        col[slot].fill_(value)


def between_row(tb, slot, i, j, R, t, sqrt_info, robust_kind, robust_k,
                active=True):
    """Write between rows in place: ``slot`` an int (one row) or a slice
    (rows from batched values); returns the table."""
    for col, value in ((tb.i, i), (tb.j, j), (tb.meas_R, R), (tb.meas_t, t),
                       (tb.sqrt_info, sqrt_info),
                       (tb.robust_kind, robust_kind),
                       (tb.robust_k, robust_k), (tb.active, active)):
        _put(col, slot, value)
    return tb


def imu_row(tb, slot, i, j, dR, dp, dv, H_R_bg, H_p_ba, H_p_bg, H_v_ba,
            H_v_bg, bias_hat, dt, gravity, cov, active=True):
    """Write IMU rows in place (``slot`` an int or a slice, as in
    ``between_row``), whitened on the device by the inverse Cholesky factor
    of each 15x15 covariance; returns the table.

    ``cholesky_ex`` leaves its status flag on the device (``cholesky``
    would read it back); a covariance that is not positive definite gives
    a NaN factor, as the reference's Cholesky does.
    """
    C = 0.5 * (cov + cov.transpose(-1, -2))
    L, _ = torch.linalg.cholesky_ex(C)
    S = torch.linalg.solve_triangular(
        L, torch.eye(15, dtype=cov.dtype, device=cov.device), upper=False)
    for col, value in ((tb.i, i), (tb.j, j), (tb.dR, dR), (tb.dp, dp),
                       (tb.dv, dv), (tb.H_R_bg, H_R_bg),
                       (tb.H_p_ba, H_p_ba), (tb.H_p_bg, H_p_bg),
                       (tb.H_v_ba, H_v_ba), (tb.H_v_bg, H_v_bg),
                       (tb.bias_hat, bias_hat), (tb.dt, dt),
                       (tb.gravity, gravity), (tb.sqrt_info, S),
                       (tb.active, active)):
        _put(col, slot, value)
    return tb


class OnlineGraph:
    """Mutable facade over the arenas with host-side slot counters.

    Every method writes rows of the preallocated tensors in place; the
    graph's and the values' shapes never change.
    """

    def __init__(self, graph: FactorGraph, values: VariableArena):
        self.graph = graph
        self.values = values
        self._n = {"prior_pose": 0, "between": 0, "prior_vel": 0,
                   "prior_bias": 0, "plane": 0, "imu": 0}
        self.num_poses = int(values.num_poses)
        self.num_vels = int(values.num_vels)
        self.num_biases = int(values.num_biases)
        self.num_planes = int(values.num_planes)

    def _t(self, x, dtype=None):
        """A value on the arena's device, in its dtype unless ``dtype`` is
        given; a host array is copied without a host sync
        (``device.upload``)."""
        v = self.values.pose_t
        dtype = v.dtype if dtype is None else dtype
        if isinstance(x, torch.Tensor):
            return x.to(v.device, dtype)
        return upload(x, v.device, dtype)

    # -- variables ------------------------------------------------------
    def set_pose(self, idx: int, pose: se3.Pose, new: bool = True):
        self.values.pose_R[idx] = self._t(pose.R)
        self.values.pose_t[idx] = self._t(pose.t)
        self.values.num_poses.clamp_(min=idx + int(new))
        if new:
            self.num_poses = max(self.num_poses, idx + 1)

    def set_vel(self, idx: int, v, new: bool = True):
        self.values.vel[idx] = self._t(v)
        self.values.num_vels.clamp_(min=idx + int(new))
        if new:
            self.num_vels = max(self.num_vels, idx + 1)

    def set_bias(self, idx: int, b, new: bool = True):
        self.values.bias[idx] = self._t(b)
        self.values.num_biases.clamp_(min=idx + int(new))
        if new:
            self.num_biases = max(self.num_biases, idx + 1)

    def set_planes(self, idxs, ps, new: bool = True):
        """Landmark rows ``idxs`` set to the planes ``ps`` (K, 4) in one
        write, each normal scaled to unit length exactly: an almost-unit
        normal puts a floor under the sphere chart's residual that no
        optimizer removes."""
        idxs = np.asarray(idxs, np.int64).reshape(-1)
        if len(idxs) == 0:
            return
        cap = self.values.plane.shape[0]
        if int(idxs.max()) >= cap:
            raise RuntimeError(
                f"plane variable arena full ({cap}); grow(plane_var_cap=...)"
                " or raise VioConfig.plane_var_cap")
        ps = np.asarray(ps, np.float64).reshape(-1, 4)
        ps = ps / np.linalg.norm(ps[:, :3], axis=1, keepdims=True)
        lo, hi = int(idxs.min()), int(idxs.max()) + 1
        if hi - lo == len(idxs) and (np.diff(idxs) == 1).all():
            self.values.plane[lo:hi] = self._t(ps)
        else:
            self.values.plane[self._t(idxs, torch.int64)] = self._t(ps)
        if new:
            self.values.num_planes.clamp_(min=hi)
            self.num_planes = max(self.num_planes, hi)

    def set_plane(self, idx: int, p, new: bool = True):
        """One landmark row: ``set_planes`` of one plane."""
        self.set_planes([idx], np.asarray(p, np.float64)[None], new)

    # -- factors ----------------------------------------------------------
    def _slot(self, key: str, cap: int) -> int:
        s = self._n[key]
        if s >= cap:
            raise RuntimeError(
                f"factor arena '{key}' full ({cap}); rebuild with larger "
                "capacity")
        self._n[key] = s + 1
        return s

    def _add_prior(self, key, idx, mean, sqrt_info):
        tb = getattr(self.graph, key)
        s = self._slot(key, tb.idx.shape[0])
        _put(tb.idx, s, idx)
        tb.mean[s] = self._t(mean)
        tb.sqrt_info[s] = self._t(sqrt_info)
        _put(tb.active, s, True)

    def add_prior_pose(self, idx, pose: se3.Pose, sqrt_info):
        tb = self.graph.prior_pose
        s = self._slot("prior_pose", tb.idx.shape[0])
        _put(tb.idx, s, idx)
        tb.mean_R[s] = self._t(pose.R)
        tb.mean_t[s] = self._t(pose.t)
        tb.sqrt_info[s] = self._t(sqrt_info)
        _put(tb.active, s, True)

    def add_prior_vel(self, idx, mean, sqrt_info):
        self._add_prior("prior_vel", idx, mean, sqrt_info)

    def add_prior_bias(self, idx, mean, sqrt_info):
        self._add_prior("prior_bias", idx, mean, sqrt_info)

    def add_between(self, i, j, meas: se3.Pose, sqrt_info, robust=None):
        s = self._slot("between", self.graph.between.i.shape[0])
        between_row(self.graph.between, s, i, j, self._t(meas.R),
                    self._t(meas.t), self._t(sqrt_info),
                    0 if robust is None else 1,
                    1.0 if robust is None else float(robust))

    def add_plane_factors(self, pose_idx, plane_idx, meas, sqrt_info):
        """Append K plane-factor rows in one write; each measured normal is
        scaled to unit length exactly (see ``set_planes``)."""
        k = len(pose_idx)
        if k == 0:
            return
        cap = self.graph.plane.pose_idx.shape[0]
        s0 = self._n["plane"]
        if s0 + k > cap:
            raise RuntimeError(
                f"factor arena 'plane' full ({cap}); rebuild with larger "
                "capacity")
        self._n["plane"] = s0 + k
        m = np.asarray(meas, np.float64).reshape(k, 4)
        m = m / np.linalg.norm(m[:, :3], axis=1, keepdims=True)
        tb = self.graph.plane
        rows = slice(s0, s0 + k)
        tb.pose_idx[rows] = self._t(np.asarray(pose_idx), torch.int64)
        tb.plane_idx[rows] = self._t(np.asarray(plane_idx), torch.int64)
        tb.meas[rows] = self._t(m)
        tb.sqrt_info[rows] = self._t(np.asarray(sqrt_info).reshape(k, 3, 3))
        tb.active[rows].fill_(True)

    def add_plane_factor(self, pose_idx, plane_idx, meas, sqrt_info):
        """One plane-factor row: ``add_plane_factors`` of one row."""
        self.add_plane_factors([pose_idx], [plane_idx],
                               np.asarray(meas, np.float64)[None],
                               np.asarray(sqrt_info)[None])

    def add_imu_factor(self, i, j, preint, gravity):
        s = self._slot("imu", self.graph.imu.i.shape[0])
        p = preint
        imu_row(self.graph.imu, s, i, j, *(self._t(x) for x in (
            p.dR, p.dp, p.dv, p.H_R_bg, p.H_p_ba, p.H_p_bg, p.H_v_ba,
            p.H_v_bg, p.bias_hat, p.dt, gravity, p.cov)))

    # -- queries ----------------------------------------------------------
    def pose(self, idx: int) -> se3.Pose:
        return se3.Pose(self.values.pose_R[idx], self.values.pose_t[idx])

    def error(self) -> float:
        return float(total_error(self.graph, self.values))

    # -- checkpoint / resume ----------------------------------------------
    def save_state(self, path: str) -> None:
        """Checkpoint the whole engine state (arenas, factor tables, slot
        counters) to one ``.npz`` in the reference's layout:
        ``g.<table>.<field>``, ``v.<field>``, ``n.keys`` and ``n.slots``.
        Integer fields are saved as int64 (the reference's are int32)."""
        flat = {f"g.{name}.{field}": leaf.detach().cpu().numpy()
                for name, tb in zip(_TABLES, self.graph)
                for field, leaf in zip(tb._fields, tb)}
        flat.update({f"v.{field}": leaf.detach().cpu().numpy()
                     for field, leaf in zip(self.values._fields,
                                            self.values)})
        keys = sorted(self._n)
        flat["n.slots"] = np.asarray([self._n[k] for k in keys], np.int64)
        flat["n.keys"] = np.asarray(keys)
        np.savez_compressed(path, **flat)

    @classmethod
    def load_state(cls, path: str, *, device=None,
                   dtype=None) -> "OnlineGraph":
        """Resume a ``save_state`` checkpoint (the port's or the JAX
        package's) on ``device`` (``None``: the card). Integer fields load
        as int64, bools as bool, floating fields in ``dtype`` (default: the
        file's)."""
        device = resolve(device)

        def t(a):
            if a.dtype == np.bool_:
                dt = torch.bool
            elif np.issubdtype(a.dtype, np.integer):
                dt = torch.int64
            else:
                dt = dtype
            return torch.from_numpy(a).to(device=device, dtype=dt)

        with np.load(path, allow_pickle=False) as z:
            graph = FactorGraph(*(
                typ(*(t(z[f"g.{name}.{f}"]) for f in typ._fields))
                for name, typ in TABLE_TYPES.items()))
            values = VariableArena(*(t(z[f"v.{f}"])
                                     for f in VariableArena._fields))
            og = cls(graph, values)
            for k, n in zip(z["n.keys"], z["n.slots"]):
                og._n[str(k)] = int(n)
        return og

    # -- growth -----------------------------------------------------------
    def grow(self, pose_cap=None, vel_cap=None, bias_cap=None,
             plane_var_cap=None, point_cap=None, factor_caps=None):
        """Re-home the arenas at larger capacities (``factor_caps`` by
        table name; the only operation that changes shapes). Fresh empty
        arenas at the new capacities keep the padded rows' benign defaults
        (identity rotations, unit sqrt-information); the live prefix is
        copied in."""
        lay = layout_of(self.values)
        v = self.values
        dtype, dev = v.pose_t.dtype, v.pose_t.device
        new_vals = empty_arena(
            pose_cap=pose_cap or lay.pose_cap,
            vel_cap=vel_cap or lay.vel_cap,
            bias_cap=bias_cap or lay.bias_cap,
            plane_cap=plane_var_cap or lay.plane_cap,
            point_cap=point_cap or lay.point_cap, dtype=dtype, device=dev)

        def copy_into(new, old):
            if new.dim() == 0:
                return old
            n = min(new.shape[0], old.shape[0])
            new[:n] = old[:n]
            return new

        self.values = VariableArena(*map(copy_into, new_vals, v))
        fc = dict(factor_caps or {})
        tables = []
        for name, typ in TABLE_TYPES.items():
            old = getattr(self.graph, name)
            cap = max(fc.get(name, 0), old[0].shape[0])
            new = empty_table(typ, cap, dtype=dtype, device=dev)
            tables.append(typ(*map(copy_into, new, old)))
        self.graph = FactorGraph(*tables)


def window_graph(graph: FactorGraph, starts, caps) -> FactorGraph:
    """Suffix-window view of a factor graph.

    Factors are appended in time order, so the factors touching the most
    recent poses are a suffix of each table. ``starts`` holds per-table
    slice starts and ``caps`` window capacities (``_TABLES`` order, host
    ints); each table is sliced to ``min(cap, table capacity)`` rows from
    its start clipped into range, exactly as the reference's
    ``dynamic_slice``. The result is views.
    """
    out = []
    for k, tb in enumerate(graph):
        cap = tb[0].shape[0]
        size = min(caps[k], cap)
        s = min(max(int(starts[k]), 0), cap - size)
        out.append(type(tb)(*(x[s:s + size] for x in tb)))
    return FactorGraph(*out)


def _free_mask(values: VariableArena, free_from):
    """Tangent-dim update mask: variable index >= free_from[kind] is free.

    ``free_from`` holds five host ints (pose, vel, bias, plane, point);
    frozen variables act as constants in the fixed-lag step.
    """
    lay = layout_of(values)
    dev = values.pose_t.device

    def block(cap, lo, width):
        return torch.repeat_interleave(torch.arange(cap, device=dev) >= lo,
                                       width)

    return torch.cat([
        block(lay.pose_cap, free_from[0], 6),
        block(lay.vel_cap, free_from[1], 3),
        block(lay.bias_cap, free_from[2], 6),
        block(lay.plane_cap, free_from[3], 3),
        block(lay.point_cap, free_from[4], 3),
    ])


def windowed_gn(win: FactorGraph, values: VariableArena, free_from, wcaps,
                damping, iterations: int = 1):
    """Compact fixed-lag GN: solve only the free window's tangent dims.

    Absolute tangent columns inside the window map to compact columns of a
    width ``Dw = 6 Wp + 3 Wv + 6 Wb + 3 plane_cap + 3 point_cap``;
    frozen/out-of-window columns map to one trash column that is sliced off
    before the solve, which is exactly "treat that variable as a constant".
    The damped least squares is solved in square-root form (QR of the
    stacked whitened rows, damping and unused-dim anchoring as extra rows),
    never by forming JᵀJ.

    ``wcaps = (Wp, Wv, Wb)`` are the pose/vel/bias window capacities;
    ``free_from`` the first free variable index per kind (host ints; planes
    and points are always fully free). Returns ``(values, window chi2)``,
    the chi2 a 0-d tensor on the device.
    """
    lay = layout_of(values)
    dtype, dev = values.pose_t.dtype, values.pose_t.device
    Wp = min(wcaps[0], lay.pose_cap)
    Wv = min(wcaps[1], lay.vel_cap)
    Wb = min(wcaps[2], lay.bias_cap)
    Dw = 6 * Wp + 3 * Wv + 6 * Wb + 3 * lay.plane_cap + 3 * lay.point_cap
    trash = Dw

    def kind_cmap(cap, width, lo, Wk, base):
        rel = torch.arange(cap, device=dev) - int(lo)
        ok = (rel >= 0) & (rel < Wk)
        cols = base + rel[:, None] * width + torch.arange(width, device=dev)
        return torch.where(ok[:, None], cols, trash).reshape(-1)

    cmap = torch.cat([
        kind_cmap(lay.pose_cap, 6, free_from[0], Wp, 0),
        kind_cmap(lay.vel_cap, 3, free_from[1], Wv, 6 * Wp),
        kind_cmap(lay.bias_cap, 6, free_from[2], Wb, 6 * Wp + 3 * Wv),
        kind_cmap(lay.plane_cap, 3, 0, lay.plane_cap,
                  6 * Wp + 3 * Wv + 6 * Wb),
        kind_cmap(lay.point_cap, 3, 0, lay.point_cap,
                  6 * Wp + 3 * Wv + 6 * Wb + 3 * lay.plane_cap),
    ])
    zero1 = torch.zeros(1, dtype=dtype, device=dev)

    for _ in range(iterations):
        # compact used mask (live variables only, from the current arena)
        uw = torch.zeros(Dw + 1, dtype=dtype, device=dev).scatter_reduce_(
            0, cmap, used_slot_mask(values), "amax")[:Dw]
        blocks = linearize_blocks(win, values)
        # every block's rows stacked: one (F*e, Dw+1) matrix, filled by one
        # accumulating scatter (only the trash column can take duplicates)
        rows, cols, vals, rhs = [], [], [], []
        base = 0
        for r, J, bcols in blocks:
            F, e, td = J.shape
            ridx = base + torch.arange(F * e, device=dev).reshape(F, e)
            rows.append(ridx[:, :, None].expand(F, e, td).reshape(-1))
            cols.append(cmap[bcols][:, None, :].expand(F, e, td).reshape(-1))
            vals.append(J.reshape(-1))
            rhs.append(r.reshape(-1))
            base += F * e
        A = torch.zeros(base, Dw + 1, dtype=dtype, device=dev)
        A.index_put_((torch.cat(rows), torch.cat(cols)), torch.cat(vals),
                     accumulate=True)
        # damping + unused-dim anchoring as extra rows:
        # (J^T J + diag(lam + (1 - uw))) delta = -J^T r
        A = torch.cat([A[:, :Dw] * uw, torch.diag(torch.sqrt(
            damping + (1.0 - uw)))], dim=0)
        b = torch.cat(rhs + [torch.zeros(Dw, dtype=dtype, device=dev)])
        Q, R = torch.linalg.qr(A, mode="reduced")
        delta_w = torch.linalg.solve_triangular(
            R, -(Q.transpose(0, 1) @ b)[:, None], upper=True)[:, 0]
        values = retract_all(values, torch.cat([delta_w, zero1])[cmap])
    return values, total_error(win, values)


class IncrementalOptimizer:
    """ISAM2-role incremental estimation: every ``update`` runs
    ``iters_per_update`` damped GN steps warm-started from the live
    estimate; ``full_batch`` runs the LM over the whole graph.

    ``window=None`` relinearizes the whole (masked) arena each update with
    ``gn_optimize`` (``solver`` "dense" or "pcg", ``pcg_iters``): the same
    cost at every update, O(capacity). ``window=W`` is the fixed-lag step:
    the last ``W`` poses, velocities and biases are free over the suffix
    window of each table (``window_graph`` with ``_window_caps``), older
    ones are constants, and ``windowed_gn`` solves the window's compact
    system (``solver`` does not apply).
    """

    def __init__(self, iters_per_update: int = 1, damping: float = 1e-6,
                 solver: str = "dense", pcg_iters: int = 100,
                 window: Optional[int] = None):
        if window is not None and window <= 0:
            raise ValueError("window must be positive or None")
        self.iters = iters_per_update
        self.damping = damping
        self.solver = solver
        self.pcg_iters = pcg_iters
        self.window = window

    def update(self, og: OnlineGraph) -> LMResult:
        """One update of ``og.values`` in place of the old; returns the
        ``LMResult`` (its ``error`` a 0-d device tensor: the whole graph's
        chi2, or the window's)."""
        if self.window is None:
            res = gn_optimize(og.graph, og.values, iterations=self.iters,
                              solver=self.solver, damping=self.damping,
                              pcg_iters=self.pcg_iters)
            og.values = res.values
            return res
        W = self.window
        caps = _window_caps(og.graph, W)
        win = window_graph(og.graph, _window_starts(og._n, caps), caps)
        free = [max(0, n - W) for n in (og.num_poses, og.num_vels,
                                        og.num_biases)]
        og.values, err = windowed_gn(win, og.values, free + [0, 0],
                                     (W, W, W), self.damping, self.iters)
        return LMResult(og.values, err, self.iters, self.damping, True)

    def full_batch(self, og: OnlineGraph,
                   params: LMParams = LMParams()) -> LMResult:
        res = lm_optimize(og.graph, og.values, params)
        og.values = res.values
        return res
