"""Solve loop: Gauss-Newton bundle adjustment with landmarks eliminated.

Set-up draws the configuration's problem and its starts from the seed and
builds the graph once with the port's ``GraphBuilder`` (one arena of
values per start). A solve is ``ba_gn_optimize_sqrt`` (the square-root,
per-landmark QR form) from one start with the traffic's iterations,
damping, chunk, step clip and assembly precision, and ends with the
final chi2 on the host.

The reference (``reference/ba.py``) runs the same damped steps in float64
from the same start; a solve is held to it by its chi2 and by the widest
gaps between its landmarks' and its cameras' positions and the
reference's. The traffic's trip count is where the float64 reference has
converged (its last step lowers chi2 by under 1e-6 of it on every start
measured), so a solve is a solution, not a point on the way to one.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.gen import synthetic as gen
from portbench.reference import ba as ref


def _starts(ctx, prob):
    cfg = ctx.config
    return [gen.ba_start(prob, cfg["init_noise"], (ctx.seed, 1, k))
            for k in range(ctx.traffic["starts"])]


def setup(ctx):
    cfg, tr = ctx.config, ctx.traffic

    def inputs():
        prob = gen.bal_problem(cfg["n_poses"], cfg["n_points"],
                               cfg["n_observations"], cfg["min_track"],
                               cfg["spacing"], cfg["image"],
                               cfg["pixel_noise"], cfg["init_noise"],
                               cfg["point_sigma"], cfg["cal"], ctx.seed,
                               cfg["rows_by_camera"])
        return prob, _starts(ctx, prob)

    prob, starts = ctx.timed("inputs_s", inputs)

    def load():
        from graph_slam_tpu_torch import graph as G

        return G

    G = ctx.timed("import_program_s", load)
    dtype = getattr(torch, cfg["dtype"])

    def build():
        b = G.GraphBuilder()
        R0, t0, q0 = starts[0]
        for k in range(cfg["n_poses"]):
            b.add_pose((R0[k], t0[k]))
        b.add_prior_pose(0, (prob["gt_R"][0], prob["gt_t"][0]),
                         sigmas=np.full(6, cfg["anchor_sigma"]))
        m = cfg["n_points"]
        b._add_points(q0)
        b._add_rows("prior_point", m, idx=np.arange(m), mean=prob["points"],
                    sqrt_info=np.broadcast_to(
                        np.eye(3) / cfg["point_sigma"], (m, 3, 3)))
        f = prob["pose_idx"].shape[0]
        b._add_rows("projection", f, pose_idx=prob["pose_idx"],
                    point_idx=prob["point_idx"], uv=prob["uv"],
                    cal=np.broadcast_to(np.asarray(cfg["cal"]), (f, 9)),
                    body_R=np.broadcast_to(np.eye(3), (f, 3, 3)),
                    body_t=np.zeros((f, 3)),
                    sqrt_info=np.broadcast_to(
                        np.eye(2) / cfg["pixel_sigma"], (f, 2, 2)))
        graph, values = b.build(bucket=cfg["bucket"], device=ctx.device,
                                dtype=dtype)
        arenas = []
        for R, t, q in starts:
            pR, pt, pq = (values.pose_R.clone(), values.pose_t.clone(),
                          values.point.clone())
            pR[:cfg["n_poses"]] = torch.as_tensor(R, dtype=dtype)
            pt[:cfg["n_poses"]] = torch.as_tensor(t, dtype=dtype)
            pq[:m] = torch.as_tensor(q, dtype=dtype)
            arenas.append(values._replace(pose_R=pR, pose_t=pt, point=pq))
        return graph, arenas

    graph, arenas = ctx.timed("build_s", build)
    kw = {k: tr[k] for k in ("iterations", "damping", "chunk", "step_clip",
                             "assembly_precision")}
    state = {"prob": prob, "starts": starts, "graph": graph,
             "arenas": arenas, "fn": G.ba_gn_optimize_sqrt, "kw": kw}
    ctx.timed("warm_s", solve, ctx, state, 0)
    return state


def solve(ctx, state, k, **options):
    """One solve from start ``k``; ``options`` override the call's keyword
    arguments (``calibrate.py`` switches on the program's own
    reduced-precision assembly this way)."""
    v, chi2 = state["fn"](state["graph"], state["arenas"][k],
                          **{**state["kw"], **options})
    n, m = ctx.config["n_poses"], ctx.config["n_points"]
    return {"chi2": float(chi2), "gn_iterations": state["kw"]["iterations"],
            "gn_steps": state["kw"]["iterations"], "t": v.pose_t[:n],
            "q": v.point[:m]}


def release(ctx, state):
    for key in ("graph", "arenas", "fn"):
        state.pop(key, None)


def reference(ctx, state, k, dtype=torch.float64, reduce_dtype=None,
              rows_dtype=None):
    """The reference's answer from start ``k``; a control passes lower
    precisions (``dtype`` of the rows and state, ``reduce_dtype`` of the
    reduced system, ``rows_dtype`` the projection rows are rounded to, each
    a torch dtype or its name)."""
    cfg, tr = ctx.config, ctx.traffic

    def as_dtype(d):
        return getattr(torch, d) if isinstance(d, str) else d

    dtype, rows_dtype = as_dtype(dtype), as_dtype(rows_dtype)
    reduce_dtype = as_dtype(reduce_dtype or cfg["reduced_dtype"])
    key = ("ref_problem", dtype, rows_dtype)
    if key not in state:
        state.pop(next((x for x in state if isinstance(x, tuple)), None),
                  None)                  # one problem's tensors at a time
        state[key] = ref.BundleProblem(state["prob"], cfg["pixel_sigma"],
                                       cfg["anchor_sigma"],
                                       device=ctx.device, dtype=dtype,
                                       rows_dtype=rows_dtype)
    start = tuple(torch.as_tensor(x, device=ctx.device, dtype=dtype)
                  for x in state["starts"][k])
    history = []
    R, t, q, chi2 = ref.solve_gn(state[key], start, tr["iterations"],
                                 tr["damping"], tr.get("step_clip"),
                                 reduce_dtype, history=history)
    return {"t": t, "q": q, "chi2": float(chi2), "history": history}


def compare(ctx, state, rec, r):
    dt = r["t"].dtype
    return {"chi2_gap": abs(rec["chi2"] - r["chi2"]) / abs(r["chi2"]),
            "point_gap_m": float((rec["q"].to(dt) - r["q"]).abs().max()),
            "pose_gap_m": float((rec["t"].to(dt) - r["t"]).abs().max())}
