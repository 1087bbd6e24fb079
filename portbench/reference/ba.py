"""Plain-torch reference for damped Gauss-Newton bundle adjustment.

The cost is

    0.5 sum_o |uv(R_c^T (q - t_c)) - uv_o|^2 / sigma_px^2
      + 0.5 sum_q |q - m_q|^2 / sigma_q^2 + 0.5 |S_0 Log(M_0^-1 X_0)|^2

with ``uv`` GTSAM's Cal3DS2 projection (radial k1, k2 and tangential p1,
p2), its depth clamped at 1e-6 and its normalised radius at 100 (both
stated by the configuration). Each step solves ``(H + lam I) d = -g`` by
eliminating the landmarks (a Schur complement on 3x3 blocks), solving the
reduced camera system by Cholesky and substituting back, then clips each
camera's 6-vector and each landmark's 3-vector to ``step_clip`` where one
is given, and retracts cameras by ``X * Exp(xi)`` and landmarks by
addition. Jacobians are forward derivatives of the residuals
(``torch.func.jvp``). ``dtype`` is the precision of everything but the
reduced system, which is formed, factored and solved in ``reduce_dtype``;
a control may round each step's projection rows to a ``rows_dtype``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lie


def project(cal, p):
    """Cal3DS2 pixel of camera-frame points ``p`` (F, 3); ``cal`` is
    (fx, fy, s, cx, cy, k1, k2, p1, p2)."""
    fx, fy, s, cx, cy, k1, k2, p1, p2 = cal
    z = p[..., 2]
    zs = torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    n = p[..., :2] / zs[..., None]
    r2 = torch.sum(n * n, -1)
    far = r2 > 1e4
    scale = torch.where(far, 100.0 / torch.sqrt(torch.where(
        far, r2, torch.ones_like(r2))), torch.ones_like(r2))
    x, y = n[..., 0] * scale, n[..., 1] * scale
    r2 = x * x + y * y
    g = 1.0 + k1 * r2 + k2 * r2 * r2
    px = g * x + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    py = g * y + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return torch.stack([fx * px + s * py + cx, fy * py + cy], -1)


class BundleProblem:
    """The benchmark's BA arrays as tensors on ``device`` in ``dtype``."""

    def __init__(self, prob, pixel_sigma, anchor_sigma, *, device, dtype,
                 rows_dtype=None):
        def T(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=device,
                                   dtype=dtype)

        # rows_dtype: each step's whitened residuals and Jacobians rounded
        # to it (a stack of rows stored in a lower precision)
        self.rows_dtype = rows_dtype
        self.cal = [float(c) for c in prob["cal"]]
        self.cam = torch.as_tensor(prob["pose_idx"], device=device)
        self.pt = torch.as_tensor(prob["point_idx"], device=device)
        self.uv = T(prob["uv"])
        self.w_px = 1.0 / pixel_sigma
        self.mean = T(prob["points"])
        self.w_pt = 1.0 / float(prob["point_sigma"])
        self.MR, self.Mt = T(prob["gt_R"][0]), T(prob["gt_t"][0])
        self.w0 = 1.0 / anchor_sigma
        self.n, self.m = prob["gt_t"].shape[0], prob["points"].shape[0]
        # every ordered pair (a, b) of observations of one landmark
        pt = np.asarray(prob["point_idx"])
        order = np.argsort(pt, kind="stable")
        counts = np.bincount(pt, minlength=self.m)
        first = np.cumsum(counts) - counts
        reps = counts[pt[order]]
        a = np.repeat(np.arange(order.size), reps)
        b = first[pt[order]][a] + np.arange(a.size) - np.repeat(
            np.cumsum(reps) - reps, reps)
        self.pair_a = torch.as_tensor(order[a], device=device)
        self.pair_b = torch.as_tensor(order[b], device=device)

    def _proj(self, xi, Rc, tc, q, uv):
        """Whitened pixel residual at camera X * Exp(xi[:6]) and landmark
        q + xi[6:]."""
        Rc, tc = lie.retract(Rc, tc, xi[..., :6])
        p = lie.mv(Rc.transpose(-1, -2), q + xi[..., 6:] - tc)
        return (project(self.cal, p) - uv) * self.w_px

    def _anchor(self, xi, R, t, MR, Mt):
        R, t = lie.retract(R, t, xi)
        eR, et = lie.compose(*lie.inverse(MR, Mt), R, t)
        return lie.se3_log(eR, et) * self.w0

    def _rows(self, R, t, q):
        return R[self.cam], t[self.cam], q[self.pt], self.uv

    def error(self, R, t, q):
        F = self.cam.shape[0]
        rp = self._proj(torch.zeros_like(t[:1, :1]).expand(F, 9),
                        *self._rows(R, t, q))
        r0 = self._anchor(torch.zeros_like(t[:1, :1]).expand(1, 6), R[:1],
                          t[:1], self.MR[None], self.Mt[None])
        rq = (q - self.mean) * self.w_pt
        return 0.5 * (torch.sum(rp * rp) + torch.sum(r0 * r0)
                      + torch.sum(rq * rq))

    def step(self, R, t, q, lam, step_clip, reduce_dtype):
        """One damped GN step; returns the new (R, t, q)."""
        dt, dev = t.dtype, t.device
        r, J = lie.linearize(self._proj, 9, *self._rows(R, t, q))
        if self.rows_dtype is not None:
            r, J = (x.to(self.rows_dtype).to(dt) for x in (r, J))
        Jc, Jq = J[:, :, :6], J[:, :, 6:]
        r0, J0 = lie.linearize(self._anchor, 6, R[:1], t[:1], self.MR[None],
                               self.Mt[None])
        J0 = J0[0]

        n, m, D = self.n, self.m, 6 * self.n
        # camera block, gradient and damping
        A = torch.zeros(n, n, 6, 6, dtype=dt, device=dev)
        A[0, 0] += J0.T @ J0
        A.index_put_((self.cam, self.cam), Jc.transpose(1, 2) @ Jc,
                     accumulate=True)
        gc = torch.zeros(n, 6, dtype=dt, device=dev)
        gc[0] += J0.T @ r0[0]
        gc.index_add_(0, self.cam, (Jc.transpose(1, 2) @ r[:, :, None])[
            ..., 0])
        # landmark blocks: projections, the prior, the damping
        eye3 = torch.eye(3, dtype=dt, device=dev)
        V = (self.w_pt ** 2 + lam) * eye3.expand(m, 3, 3).clone()
        V.index_put_((self.pt,), Jq.transpose(1, 2) @ Jq, accumulate=True)
        gq = (q - self.mean) * self.w_pt ** 2
        gq = gq.index_add(0, self.pt, (Jq.transpose(1, 2) @ r[:, :, None])[
            ..., 0])
        W = Jc.transpose(1, 2) @ Jq                      # (F, 6, 3)
        Vi = torch.linalg.inv(V)

        # reduced camera system, in reduce_dtype: S = A - sum over pairs
        # (a, b) of one landmark's observations of W_a V^-1 W_b^T
        rd = reduce_dtype
        Wr = W.to(rd)
        WV = Wr @ Vi.to(rd)[self.pt]                     # (F, 6, 3)
        pa, pb = self.pair_a, self.pair_b
        Sred = A.to(rd)
        Sred.index_put_((self.cam[pa], self.cam[pb]),
                        -(WV[pa] @ Wr[pb].transpose(1, 2)), accumulate=True)
        S = Sred.permute(0, 2, 1, 3).reshape(D, D)
        S.diagonal().add_(lam)
        b = gc.to(rd).index_add(0, self.cam, -(WV @ gq.to(rd)[self.pt][
            ..., None])[..., 0])
        L, bad = torch.linalg.cholesky_ex(S)
        dc = torch.cholesky_solve(-b.reshape(D, 1), L).reshape(n, 6)
        # not positive definite: the step is NaN, and so is the answer
        dc = torch.where(bad == 0, dc, torch.full_like(dc, float("nan")))
        Wtd = torch.zeros(m, 3, dtype=rd, device=dev).index_add_(
            0, self.pt, (Wr.transpose(1, 2) @ dc[self.cam][..., None])[
                ..., 0])
        dq = -(Vi.to(rd) @ (gq.to(rd) + Wtd)[:, :, None])[..., 0]
        dc, dq = dc.to(dt), dq.to(dt)
        if step_clip is not None:
            dc = dc * torch.clamp(step_clip / torch.clamp(
                torch.linalg.norm(dc, dim=1, keepdim=True), min=1e-30),
                max=1.0)
            dq = dq * torch.clamp(step_clip / torch.clamp(
                torch.linalg.norm(dq, dim=1, keepdim=True), min=1e-30),
                max=1.0)
        R, t = lie.retract(R, t, dc)
        return R, t, q + dq


def solve_gn(problem: BundleProblem, start, iterations, damping,
             step_clip=None, reduce_dtype=torch.float64, history=None):
    """``iterations`` damped GN steps from ``start`` = (R, t, q) tensors.
    Returns (R, t, q, chi2 tensor); where ``history`` is a list, the chi2
    of the start and after each step is appended to it."""
    R, t, q = start
    for _ in range(iterations):
        if history is not None:
            history.append(float(problem.error(R, t, q)))
        R, t, q = problem.step(R, t, q, damping, step_clip, reduce_dtype)
    chi2 = problem.error(R, t, q)
    if history is not None:
        history.append(float(chi2))
    return R, t, q, chi2
