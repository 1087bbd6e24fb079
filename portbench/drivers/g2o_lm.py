"""Solve loop: ``run_g2o_file`` on a pose graph written as ``.g2o`` text.

Set-up draws the configuration's sphere graph from the seed and writes one
``.g2o`` file per start (the graph's edges with the start's vertices) in
the run's temporary directory. A solve is the command-line user's path end
to end: read the file, build the graph on the card, LM to convergence, the
final chi2 on the host. The LM schedule is the traffic's ``lm`` block.

The reference reads the same file (``reference/pose_graph.py``) and runs
the same schedule in float64; a solve is held to it by its chi2, by the
widest gap between its poses' positions and the reference's, and by its
count of LM iterations, which has to equal the reference's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench.gen import synthetic as gen
from portbench.reference import pose_graph as ref


def setup(ctx):
    cfg, tr = ctx.config, ctx.traffic
    graph = ctx.timed("inputs_s", gen.sphere_graph, cfg["n_poses"],
                      cfg["n_loops"], cfg["meas_noise"], cfg["init_noise"],
                      ctx.seed)
    graph["info"] = np.diag(cfg["information_diag"])

    def write():
        paths = []
        for k in range(tr["starts"]):
            R, t = gen.sphere_start(graph["gt_R"], graph["gt_t"],
                                    cfg["init_noise"], (ctx.seed, 1, k))
            paths.append(os.path.join(ctx.tmpdir, f"start{k}.g2o"))
            gen.write_g2o(paths[-1], R, t, graph)
        return paths

    paths = ctx.timed("inputs_s", write)

    def load():
        from graph_slam_tpu_torch.graph import LMParams
        from graph_slam_tpu_torch.pipelines import run_g2o_file

        return run_g2o_file, LMParams(**tr["lm"])

    run_g2o_file, params = ctx.timed("import_program_s", load)
    state = {"paths": paths, "run": run_g2o_file, "params": params,
             "dtype": getattr(torch, cfg["dtype"])}
    ctx.timed("warm_s", solve, ctx, state, 0)
    return state


def solve(ctx, state, k):
    res = state["run"](state["paths"][k], state["params"],
                       device=ctx.device, dtype=state["dtype"])
    n = len(res.seq_ids)
    return {"chi2": float(res.error), "gn_iterations": int(res.iterations),
            "lm_iterations": int(res.iterations),
            "ids": np.asarray(res.seq_ids), "t": res.values.pose_t[:n]}


def release(ctx, state):
    state.pop("run", None)


def reference(ctx, state, k, dtype=torch.float64):
    g = ref.PoseGraph(state["paths"][k], ctx.config["anchor_sigma"],
                      device=ctx.device, dtype=dtype)
    R, t, chi2, it, trials = ref.solve_lm(g, ctx.traffic["lm"])
    return {"ids": g.ids, "t": t, "chi2": float(chi2), "iterations": it,
            "lm_iterations": it}


def compare(ctx, state, rec, r):
    """The relative chi2 gap, the widest position gap and the difference
    in LM iterations (the same accept/reject path takes as many)."""
    iters = float(abs(rec["lm_iterations"] - r["iterations"]))
    if not np.array_equal(rec["ids"], r["ids"]):
        return {"chi2_gap": float("inf"), "pose_gap_m": float("inf"),
                "lm_iter_gap": iters}
    gap = (rec["t"].to(r["t"].dtype) - r["t"]).abs().max()
    return {"chi2_gap": abs(rec["chi2"] - r["chi2"]) / abs(r["chi2"]),
            "pose_gap_m": float(gap), "lm_iter_gap": iters}
