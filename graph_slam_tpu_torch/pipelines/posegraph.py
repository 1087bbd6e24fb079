"""Offline SE(3) pose-graph SLAM from a VRO log or a g2o file (port of
``pipelines/posegraph.py``).

1. the first node gets a near-exact pose prior (sigma 1e-7);
2. every odometry record creates the next node, its initial estimate
   composed from the predecessor; with a camera->IMU extrinsic ``u2c`` the
   edge is taken to the body frame, ``T' = U T U^-1``, and its information
   by the adjoint, ``Ad_U info Ad_U^T``;
3. a *failed* record (info sentinel 10000) becomes an identity edge when
   it creates a node (information I*1e4 for ``backend="gtsam"``, I*1e-3
   for ``backend="g2o"``, by the adjoint too under ``u2c``; no edge at all
   with ``only_vo=False``), and is skipped when both of its endpoints
   exist;
4. records whose both endpoints already exist are loop closures;
5. optionally PCM loop gating, chordal initialization, and GNC;
6. Levenberg-Marquardt (GTSAM's schedule, or g2o's chunked one), or
   fixed-trip Gauss-Newton.

``run_g2o_file`` ingests a standard g2o pose graph and runs the same LM;
``trajectory_arrays`` gives the trajectory in the world frame ``w2o``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SlamParams
from ..core import se3, so3
from ..device import resolve
from ..graph import (GraphBuilder, LMParams, chordal_initialize, gn_optimize,
                     gnc_optimize, lm_optimize, lm_optimize_g2o, pcm_mask,
                     total_error)
from ..io.trajectory import read_g2o
from ..io.vro_log import FAILED_INFO_SENTINEL, VROLog

__all__ = ["PoseGraphResult", "build_pose_graph", "run_pose_graph",
           "build_graph_from_g2o", "run_g2o_file", "trajectory_arrays"]


@dataclasses.dataclass
class PoseGraphResult:
    values: object            # VariableArena after optimization
    graph: object             # FactorGraph
    error0: float
    error: float
    seq_ids: np.ndarray       # (N,) sequence id per graph id
    iterations: int


def _host_pose(p):
    return se3.Pose(torch.as_tensor(p.R).detach().cpu().double(),
                    torch.as_tensor(p.t).detach().cpu().double())


def build_pose_graph(log: VROLog, params: SlamParams = SlamParams(),
                     bucket: int = 256, backend: str = "gtsam", *,
                     only_vo: bool = True, u2c=None, device=None,
                     dtype=torch.float64):
    """VRO log -> (FactorGraph, VariableArena, seq_ids) on ``device``
    (``None``: the CUDA card).

    Nodes are created in file order; edges between existing nodes are loop
    closures. Edge transforms and initial estimates are computed on the
    host in float64. ``backend`` selects the fake-odometry weighting of a
    failed record: I*1e4 for "gtsam" (``fakeOdoNode``), I*1e-3 for "g2o".
    ``only_vo=False`` (the VIO pipeline's graph) gives a failed record that
    creates a node no edge: its pose comes from the IMU there.
    """
    device = resolve(device)
    if backend not in ("gtsam", "g2o"):
        raise ValueError(f"unknown backend {backend!r}")
    b = GraphBuilder()
    seq2graph: dict[int, int] = {}
    seq_ids: list[int] = []
    robust_k = params.robust_k if params.robust == "huber" else None

    xi = torch.as_tensor(np.asarray(log.xi, np.float64).reshape(-1, 6))
    T_all = se3.expmap(xi)
    fake_info = np.eye(6) * (FAILED_INFO_SENTINEL if backend == "gtsam"
                             else 1e-3)
    infos = np.asarray(log.info, np.float64)
    if u2c is not None:
        # every edge conjugated at once; fakeOdo information too, as the
        # reference's addToGTSAM conjugates it unconditionally
        u = _host_pose(u2c)
        T_all = se3.compose(se3.compose(u, T_all), se3.inverse(u))
        Ad = se3.adjoint(u).numpy()
        infos = np.einsum("ab,kbc,dc->kad", Ad, infos, Ad)
        fake_info = Ad @ fake_info @ Ad.T
    TR, Tt = T_all.R.numpy(), T_all.t.numpy()

    for k in range(len(log)):
        id_to = int(log.id_to[k])
        id_from = int(log.id_from[k])
        failed = log.info[k][0, 0] == FAILED_INFO_SENTINEL
        if not seq2graph:
            gid = b.add_pose((np.eye(3), np.zeros(3)))
            seq2graph[id_from] = gid
            seq_ids.append(id_from)
            b.add_prior_pose(gid, (np.eye(3), np.zeros(3)),
                             sigmas=np.full(6, 1e-7))
        if id_from not in seq2graph:
            continue  # the replay assumes ordered logs; skip dangling edges
        gi = seq2graph[id_from]
        if failed:
            # fakeOdoNode: identity transform, information I*1e4
            R, t, info = np.eye(3), np.zeros(3), fake_info
        else:
            R, t, info = TR[k], Tt[k], infos[k]

        if id_to not in seq2graph:
            Ri, ti = b.pose(gi)
            gj = b.add_pose((Ri @ R, Ri @ t + ti))
            seq2graph[id_to] = gj
            seq_ids.append(id_to)
            if failed and not only_vo:
                continue
        elif failed:
            continue
        else:
            gj = seq2graph[id_to]
        b.add_between(gi, gj, (R, t), information=info, robust=robust_k)

    graph, values = b.build(bucket=bucket, device=device, dtype=dtype)
    return graph, values, np.asarray(seq_ids)


def _gate_loops(graph, values):
    """PCM over the graph's non-consecutive between rows, against the
    GraphBuilder's odometry-composed estimate; the rejected rows go
    inactive."""
    bt = graph.between
    accepted = torch.as_tensor(pcm_mask(graph, values).accepted,
                               device=bt.active.device)
    return graph._replace(between=bt._replace(active=bt.active & accepted))


def run_pose_graph(log: VROLog, params: SlamParams = SlamParams(),
                   lm_params: LMParams = LMParams(), bucket: int = 256,
                   backend: str = "gtsam", init: str = "odometry",
                   loop_gate: str = "none", *, u2c=None, device=None,
                   dtype=torch.float64) -> PoseGraphResult:
    """Build the graph from ``log`` and optimize it (see the module
    docstring); on ``device`` (``None``: the CUDA card)."""
    graph, values, seq_ids = build_pose_graph(log, params, bucket=bucket,
                                              backend=backend, u2c=u2c,
                                              device=device, dtype=dtype)
    if loop_gate == "pcm":
        # before any initialization or optimization: chordal init and the
        # convex GNC stage are both corruptible by a gross outlier
        graph = _gate_loops(graph, values)
    elif loop_gate != "none":
        raise ValueError(f"unknown loop_gate {loop_gate!r} (none|pcm)")
    e0 = float(total_error(graph, values))
    if init == "chordal":
        values = chordal_initialize(graph, values)
    elif init != "odometry":
        raise ValueError(f"unknown init {init!r} (odometry|chordal)")
    if params.robust in ("gnc-tls", "gnc-gm"):
        # GNC over the loop closures, the odometry chain (consecutive graph
        # ids) trusted; dense solves up to 4096 tangent dims, PCG beyond
        bt = graph.between
        big = values.pose_R.shape[0] * 6 > 4096
        gres = gnc_optimize(graph, values, candidates=(bt.j - bt.i) != 1,
                            kind=params.robust[4:],
                            solver="pcg" if big else "dense",
                            damping=1e-3 if big else 1e-6)
        return PoseGraphResult(values=gres.values, graph=graph, error0=e0,
                               error=float(gres.error), seq_ids=seq_ids,
                               iterations=20)
    if params.optimizer == "gn":
        res = gn_optimize(graph, values, iterations=params.optimize_step)
    elif backend == "g2o":
        # g2o's schedule: LM iterations in chunks of 2 with per-chunk
        # lambda re-init; the caller's budget is honoured (the reference's
        # 20 when max_iterations was left at its default)
        total = (20 if lm_params.max_iterations
                 == LMParams.max_iterations else lm_params.max_iterations)
        res = lm_optimize_g2o(graph, values, total_iters=total,
                              chunks=max(1, -(-total // 2)))
    else:
        res = lm_optimize(graph, values, lm_params)
    return PoseGraphResult(values=res.values, graph=graph, error0=e0,
                           error=float(res.error), seq_ids=seq_ids,
                           iterations=int(res.iterations))


def build_graph_from_g2o(vertices: dict, edges: list, bucket: int = 256, *,
                         device=None, dtype=torch.float64):
    """(vertices, edges) from ``io.read_g2o`` -> (graph, values, ids) on
    ``device`` (``None``: the CUDA card).

    The first vertex gets a prior of sigma 1e-6 (g2o fixes vertex 0).
    """
    ids = sorted(vertices.keys())
    id2slot = {vid: k for k, vid in enumerate(ids)}

    def rotations(quats):
        q = torch.as_tensor(np.asarray(quats, np.float64).reshape(-1, 4))
        return so3.quat_to_matrix(q).numpy()

    Rv = rotations([vertices[vid][1] for vid in ids])
    Re = rotations([e[3] for e in edges])
    b = GraphBuilder()
    for k, vid in enumerate(ids):
        b.add_pose((Rv[k], vertices[vid][0]))
    b.add_prior_pose(0, (Rv[0], vertices[ids[0]][0]),
                     sigmas=np.full(6, 1e-6))
    for k, (i, j, tij, _, info) in enumerate(edges):
        b.add_between(id2slot[i], id2slot[j], (Re[k], tij), information=info)
    graph, values = b.build(bucket=bucket, device=device, dtype=dtype)
    return graph, values, np.asarray(ids)


def run_g2o_file(path: str, lm_params: LMParams = LMParams(),
                 bucket: int = 256, init: str = "odometry",
                 loop_gate: str = "none", *, device=None,
                 dtype=torch.float64) -> PoseGraphResult:
    """Read a .g2o pose graph, optimize it with ``lm_optimize``, return the
    result. ``loop_gate="pcm"`` gates its non-consecutive edges by pairwise
    consistency against the file's initial estimate first;
    ``init="chordal"`` replaces that estimate before the LM."""
    vertices, edges = read_g2o(path)
    graph, values, ids = build_graph_from_g2o(vertices, edges, bucket=bucket,
                                              device=device, dtype=dtype)
    if loop_gate == "pcm":
        graph = _gate_loops(graph, values)
    elif loop_gate != "none":
        raise ValueError(f"unknown loop_gate {loop_gate!r} (none|pcm)")
    e0 = float(total_error(graph, values))
    if init == "chordal":
        values = chordal_initialize(graph, values)
    res = lm_optimize(graph, values, lm_params)
    return PoseGraphResult(values=res.values, graph=graph, error0=e0,
                           error=float(res.error), seq_ids=ids,
                           iterations=int(res.iterations))


def trajectory_arrays(values, seq_ids, w2o=None):
    """(ids, t, quat_wxyz, seq) as numpy in the world frame ``w2o`` (a
    ``Pose``, identity when None), the writeTrajectory contract."""
    n = len(seq_ids)
    R = values.pose_R[:n]
    t = values.pose_t[:n]
    if w2o is not None:
        w = se3.Pose(*(torch.as_tensor(x).to(t) for x in (w2o.R, w2o.t)))
        P = se3.compose(se3.Pose(w.R.expand(R.shape), w.t.expand(t.shape)),
                        se3.Pose(R, t))
        R, t = P.R, P.t
    q = so3.matrix_to_quat(R)
    return (np.arange(n), t.detach().cpu().numpy(), q.detach().cpu().numpy(),
            np.asarray(seq_ids))
