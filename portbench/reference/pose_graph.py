"""Plain-torch reference for a g2o pose graph solved by Levenberg-Marquardt.

It reads the ``.g2o`` text itself, pins the first vertex with a pose prior
of sigma ``anchor_sigma`` (the g2o convention of a fixed first vertex,
which the configuration states), and minimises

    0.5 sum_e |S_e Log(Z_e^-1 X_i^-1 X_j)|^2 + 0.5 |S_0 Log(M_0^-1 X_0)|^2

with ``S_e`` the upper Cholesky factor of the edge's information matrix,
by the LM schedule the configuration's ``lm`` block states: a dense damped
system ``(H + lam I) d = -g`` solved by Cholesky, lambda from
``lambda_initial`` up by ``lambda_factor`` on every rejected trial (at most
``max_trials`` a linearisation, never above ``lambda_upper``) and down by it
after an accepted one, a trial accepted when the linearised decrease is
positive and the model fidelity exceeds ``min_model_fidelity``, and a stop
when the relative or absolute decrease falls to its tolerance. Jacobians
are forward derivatives of the residuals (``torch.func.jvp``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import lie


def read_g2o(path):
    """(vertex ids (N,), t (N, 3), q_wxyz (N, 4), edges i (E,), j (E,),
    t (E, 3), q_wxyz (E, 4), info (E, 6, 6)) from VERTEX_SE3:QUAT and
    EDGE_SE3:QUAT lines, vertices sorted by id."""
    verts, edges = [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "VERTEX_SE3:QUAT":
                verts.append([float(x) for x in tok[1:9]])
            elif tok[0] == "EDGE_SE3:QUAT":
                edges.append([float(x) for x in tok[1:31]])
    V = np.asarray(verts, np.float64).reshape(-1, 8)
    V = V[np.argsort(V[:, 0], kind="stable")]
    E = np.asarray(edges, np.float64).reshape(-1, 30)
    info = np.zeros((E.shape[0], 6, 6))
    iu = np.triu_indices(6)
    info[:, iu[0], iu[1]] = E[:, 9:30]
    info[:, iu[1], iu[0]] = E[:, 9:30]
    return (V[:, 0].astype(np.int64), V[:, 1:4], V[:, [7, 4, 5, 6]],
            E[:, 0].astype(np.int64), E[:, 1].astype(np.int64), E[:, 2:5],
            E[:, [8, 5, 6, 7]], info)


def quat_to_matrix(q):
    """(N, 4) quaternions (w, x, y, z), normalised first -> (N, 3, 3)."""
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def _edge_residual(xi, Ri, ti, Rj, tj, ZR, Zt, S):
    """Whitened residual S Log(Z^-1 (Xi Exp xi_i)^-1 (Xj Exp xi_j))."""
    Ri, ti = lie.retract(Ri, ti, xi[..., :6])
    Rj, tj = lie.retract(Rj, tj, xi[..., 6:])
    hR, ht = lie.compose(*lie.inverse(Ri, ti), Rj, tj)
    eR, et = lie.compose(*lie.inverse(ZR, Zt), hR, ht)
    return lie.mv(S, lie.se3_log(eR, et))


def _anchor_residual(xi, R, t, MR, Mt, S):
    """Whitened residual S Log(M^-1 X Exp xi)."""
    R, t = lie.retract(R, t, xi)
    eR, et = lie.compose(*lie.inverse(MR, Mt), R, t)
    return lie.mv(S, lie.se3_log(eR, et))


class PoseGraph:
    """A g2o file's graph as tensors on ``device`` in ``dtype``."""

    def __init__(self, path, anchor_sigma, *, device, dtype):
        ids, vt, vq, ei, ej, et, eq, info = read_g2o(path)
        slot = {int(v): k for k, v in enumerate(ids)}

        def T(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=device,
                                   dtype=dtype)

        self.ids = ids
        self.R0, self.t0 = T(quat_to_matrix(vq)), T(vt)
        self.i = torch.as_tensor([slot[int(a)] for a in ei], device=device)
        self.j = torch.as_tensor([slot[int(b)] for b in ej], device=device)
        self.ZR, self.Zt = T(quat_to_matrix(eq)), T(et)
        self.S = T(np.linalg.cholesky(info).transpose(0, 2, 1))
        self.S0 = T(np.eye(6) / anchor_sigma)
        self.MR, self.Mt = self.R0[0].clone(), self.t0[0].clone()
        self.n = len(ids)

    def _edge_rows(self, R, t):
        return (R[self.i], t[self.i], R[self.j], t[self.j], self.ZR, self.Zt,
                self.S)

    def _anchor_rows(self, R, t):
        return R[:1], t[:1], self.MR[None], self.Mt[None], self.S0[None]

    def error(self, R, t):
        re = _edge_residual(torch.zeros_like(t[:1, :1]).expand(
            self.i.shape[0], 12), *self._edge_rows(R, t))
        r0 = _anchor_residual(torch.zeros_like(t[:1, :1]).expand(1, 6),
                              *self._anchor_rows(R, t))
        return 0.5 * (torch.sum(re * re) + torch.sum(r0 * r0))

    def normal_equations(self, R, t):
        """Dense (H, g) over the 6N tangent, by forward derivatives."""
        dt, dev = t.dtype, t.device
        D = 6 * self.n
        H = torch.zeros(D, D, dtype=dt, device=dev)
        g = torch.zeros(D, dtype=dt, device=dev)
        a6 = torch.arange(6, device=dev)
        for fn, width, rows, cols in (
                (_edge_residual, 12, self._edge_rows(R, t),
                 torch.cat([6 * self.i[:, None] + a6,
                            6 * self.j[:, None] + a6], 1)),
                (_anchor_residual, 6, self._anchor_rows(R, t), a6[None])):
            r, J = lie.linearize(fn, width, *rows)
            H.index_put_((cols[:, :, None].expand(-1, width, width)
                          .reshape(-1),
                          cols[:, None, :].expand(-1, width, width)
                          .reshape(-1)),
                         (J.transpose(1, 2) @ J).reshape(-1), accumulate=True)
            g.index_add_(0, cols.reshape(-1),
                         (J.transpose(1, 2) @ r[:, :, None]).reshape(-1))
        return H, g

    def retract(self, R, t, delta):
        return lie.retract(R, t, delta.reshape(-1, 6))


def solve_lm(graph: PoseGraph, lm: dict):
    """LM from the file's estimate. Returns (R, t, chi2 tensor, iterations,
    trials)."""
    R, t = graph.R0, graph.t0
    err = graph.error(R, t)
    lam = float(lm["lambda_initial"])
    it = trials_total = 0
    done = bool(err <= lm["error_tol"])
    while not done and it < lm["max_iterations"]:
        H, g = graph.normal_equations(R, t)
        trials, accepted, stuck = 0, False, False
        new = (R, t, err)
        while not accepted and not stuck and trials < lm["max_trials"]:
            Hd = H.clone()
            Hd.diagonal().add_(lam)
            L, bad = torch.linalg.cholesky_ex(Hd)
            delta = torch.cholesky_solve(-g[:, None], L)[:, 0]
            if bool(bad != 0):
                delta = torch.full_like(delta, float("nan"))
            cR, ct = graph.retract(R, t, delta)
            cerr = graph.error(cR, ct)
            lin = -torch.dot(g, delta) - 0.5 * torch.dot(delta, H @ delta)
            fid = (err - cerr) / (lin if bool(lin != 0) else 1.0)
            ok = bool(lin > 0) and bool(fid > lm["min_model_fidelity"]) \
                and bool(torch.isfinite(cerr))
            if ok:
                new = (cR, ct, cerr)
            else:
                lam *= lm["lambda_factor"]
                stuck = lam > lm["lambda_upper"]
            trials += 1
            accepted = ok
        trials_total += trials
        if accepted:
            lam = max(lam / lm["lambda_factor"], lm["lambda_lower"])
        abs_dec = float(err - new[2])
        rel_dec = abs_dec / float(err) if float(err) > 0 else abs_dec
        converged = accepted and (float(new[2]) <= lm["error_tol"]
                                  or rel_dec <= lm["relative_error_tol"]
                                  or abs_dec <= lm["absolute_error_tol"])
        done = converged or not accepted or stuck
        R, t, err = new
        it += 1
    return R, t, err, it, trials_total
