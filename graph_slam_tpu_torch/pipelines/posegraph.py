"""Offline SE(3) pose-graph SLAM from a VRO log (port of
``pipelines/posegraph.py``).

1. the first node gets a near-exact pose prior (sigma 1e-7);
2. every odometry record creates the next node, its initial estimate
   composed from the predecessor; with a camera->IMU extrinsic ``u2c`` the
   edge is taken to the body frame, ``T' = U T U^-1``, and its information
   by the adjoint, ``Ad_U info Ad_U^T``;
3. a *failed* record (info sentinel 10000) becomes an identity edge with
   information I*1e4 (by the adjoint too under ``u2c``) when it creates a
   node, and is skipped when both of its endpoints exist;
4. records whose both endpoints already exist are loop closures;
5. Levenberg–Marquardt (or fixed-trip Gauss–Newton) batch optimization.

Ported: ``init="odometry"``, ``backend="gtsam"``, ``robust`` None or
``"huber"``, no loop gate, ``u2c``. The rest raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SlamParams
from ..core import se3, so3
from ..device import resolve
from ..graph import GraphBuilder, LMParams, gn_optimize, lm_optimize, total_error
from ..io.vro_log import FAILED_INFO_SENTINEL, VROLog

__all__ = ["PoseGraphResult", "build_pose_graph", "run_pose_graph",
           "trajectory_arrays"]


@dataclasses.dataclass
class PoseGraphResult:
    values: object            # VariableArena after optimization
    graph: object             # FactorGraph
    error0: float
    error: float
    seq_ids: np.ndarray       # (N,) sequence id per graph id
    iterations: int


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP item {item})")


def _host_pose(p):
    return se3.Pose(torch.as_tensor(p.R).detach().cpu().double(),
                    torch.as_tensor(p.t).detach().cpu().double())


def build_pose_graph(log: VROLog, params: SlamParams = SlamParams(),
                     bucket: int = 256, backend: str = "gtsam", *,
                     u2c=None, device=None, dtype=torch.float64):
    """VRO log -> (FactorGraph, VariableArena, seq_ids) on ``device``
    (``None``: the CUDA card).

    Nodes are created in file order; edges between existing nodes are loop
    closures. Edge transforms and initial estimates are computed on the
    host in float64.
    """
    device = resolve(device)
    if backend == "g2o":
        raise _not_ported("backend='g2o'", "A (lm_optimize_g2o)")
    if backend != "gtsam":
        raise ValueError(f"unknown backend {backend!r}")
    b = GraphBuilder()
    seq2graph: dict[int, int] = {}
    seq_ids: list[int] = []
    robust_k = params.robust_k if params.robust == "huber" else None

    xi = torch.as_tensor(np.asarray(log.xi, np.float64).reshape(-1, 6))
    T_all = se3.expmap(xi)
    fake_info = np.eye(6) * FAILED_INFO_SENTINEL
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
        elif failed:
            continue
        else:
            gj = seq2graph[id_to]
        b.add_between(gi, gj, (R, t), information=info, robust=robust_k)

    graph, values = b.build(bucket=bucket, device=device, dtype=dtype)
    return graph, values, np.asarray(seq_ids)


def run_pose_graph(log: VROLog, params: SlamParams = SlamParams(),
                   lm_params: LMParams = LMParams(), bucket: int = 256,
                   backend: str = "gtsam", init: str = "odometry",
                   loop_gate: str = "none", *, u2c=None, device=None,
                   dtype=torch.float64) -> PoseGraphResult:
    if loop_gate == "pcm":
        raise _not_ported("loop_gate='pcm'", "E (graph/pcm.py)")
    if loop_gate != "none":
        raise ValueError(f"unknown loop_gate {loop_gate!r} (none|pcm)")
    if init == "chordal":
        raise _not_ported("init='chordal'", "E (graph/init.py)")
    if init != "odometry":
        raise ValueError(f"unknown init {init!r} (odometry|chordal)")
    if params.robust in ("gnc-tls", "gnc-gm"):
        raise _not_ported(f"robust={params.robust!r}", "E (graph/gnc.py)")
    graph, values, seq_ids = build_pose_graph(log, params, bucket=bucket,
                                              backend=backend, u2c=u2c,
                                              device=device, dtype=dtype)
    e0 = float(total_error(graph, values))
    if params.optimizer == "gn":
        res = gn_optimize(graph, values, iterations=params.optimize_step)
    else:
        res = lm_optimize(graph, values, lm_params)
    return PoseGraphResult(values=res.values, graph=graph, error0=e0,
                           error=float(res.error), seq_ids=seq_ids,
                           iterations=int(res.iterations))


def trajectory_arrays(values, seq_ids):
    """(ids, t, quat_wxyz, seq) as numpy, the writeTrajectory contract.

    The reference's ``w2o`` world-frame rotation waits for
    ``core/extrinsics.py`` (ROADMAP item A).
    """
    n = len(seq_ids)
    t = values.pose_t[:n]
    q = so3.matrix_to_quat(values.pose_R[:n])
    return (np.arange(n), t.detach().cpu().numpy(), q.detach().cpu().numpy(),
            np.asarray(seq_ids))
