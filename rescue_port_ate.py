#!/usr/bin/env python3
"""The port's flagship rescue replay at any length, and its comparison
with the JAX package's run of the same scenario.

    python3 rescue_port_ate.py [--frames 2000] [--device cuda|cpu]
        [--seed 0] [--save port.npz] [--against jax.npz]
    python3 rescue_port_ate.py --load run.npz --against other.npz

Replays ``make_vio_plane_scenario(N, fail_every=100, render="lazy")``
through ``run_vio(engine="scan", plane_mode="rescue")`` at the JAX
bench's ``vio_planes_2k`` configuration (``bench.py:343-345``,
``chip_smoke.RESCUE_CFG``), as ``rescue_reference_ate.py`` does with the
JAX package, and prints one JSON line: the ATE (``chip_smoke._ate``),
the counts and the wall time. ``--save`` writes the ``.npz`` of
``rescue_reference_ate.py --save``; ``--against`` holds this run to such
a file: the ATE's relative gap, whether the per-rescue rows and counts
are equal, the first rescue whose row, planes or fresh pre-node planes
differ by more than 1e-6, and the first frame whose final position is
more than 1e-6 m away. ``--load`` compares two saved runs without
replaying. Imports only the port.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import RESCUE_CFG, _ate  # noqa: E402

POSE_TOL_M = 1e-6    # a frame "differs" beyond this final position gap
PLANE_TOL = 1e-6     # a rescued node's plane parameters "differ" beyond


def _host(x):
    """A torch tensor (on any device) or a JAX array, as numpy float64."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x, np.float64)


class RescueRecorder:
    """Wraps a plane stack's ``_PlaneStack.rescue`` (and the prediction
    bookkeeping it calls) to keep one row per rescue step: (node, frame,
    pre node, planes predicted (-1: no prediction ran), fresh
    extractions, plane factors added, landmarks added), the rescued
    node's planes and, where the previous node had none yet, the planes
    freshly extracted there. ``vio_planes`` and ``plane_node`` are the
    port's modules, or the JAX package's (``rescue_reference_ate.py``):
    the two share these names. ``undo()`` puts both functions back."""

    def __init__(self, vio_planes, plane_node):
        self.rows, self.planes, self.pre_planes = [], [], []
        self._src = None
        t0 = time.perf_counter()
        collect = plane_node._collect_prediction
        rescue = vio_planes._PlaneStack.rescue
        rec = self

        def collect_rec(*a, **kw):
            out = collect(*a, **kw)
            if isinstance(out, tuple):        # (detection, source rows)
                rec._src = out[1]
            return out

        def rescue_rec(stack, gj, est, seq_to, pre_gid, *a, **kw):
            rec._src = None
            n0, l0 = stack.n_plane, len(stack.book.world)
            pre_known = pre_gid in stack.plane_nodes
            rescue(stack, gj, est, seq_to, pre_gid, *a, **kw)
            pre = None if pre_known else stack.plane_nodes.get(pre_gid)
            det = stack.plane_nodes.get(gj)
            if rec._src is None:
                n_pred, n_fresh = -1, 0 if det is None else len(det)
            else:
                n_pred = sum(1 for k, _ in rec._src if k == 0)
                n_fresh = sum(1 for k, _ in rec._src if k == 1)
            rec.rows.append((int(gj), int(seq_to), int(pre_gid), n_pred,
                             n_fresh, stack.n_plane - n0,
                             len(stack.book.world) - l0))
            for out, d in ((rec.planes, det), (rec.pre_planes, pre)):
                out.append(np.zeros((0, 4)) if d is None
                           else _host(d.params))
            print(f"rescue {len(rec.rows)}: node {gj} at "
                  f"{time.perf_counter() - t0:.0f} s", file=sys.stderr,
                  flush=True)

        def undo():
            plane_node._collect_prediction = collect
            vio_planes._PlaneStack.rescue = rescue

        self.undo = undo
        plane_node._collect_prediction = collect_rec
        vio_planes._PlaneStack.rescue = rescue_rec

    def arrays(self, res, counts):
        """The ``.npz`` fields that ``--save`` writes."""
        n = len(res.seq_ids)
        book = res.plane_book

        def stacked(planes):
            return np.concatenate(planes).reshape(-1, 4) if planes \
                else np.zeros((0, 4))

        return dict(
            seq_ids=np.asarray(res.seq_ids, np.int64),
            pose_R=_host(res.values.pose_R[:n]),
            pose_t=_host(res.values.pose_t[:n]),
            rescue=np.asarray(self.rows, np.int64).reshape(-1, 7),
            rescue_planes=stacked(self.planes),
            rescue_plane_counts=np.asarray([len(p) for p in self.planes],
                                           np.int64),
            pre_planes=stacked(self.pre_planes),
            pre_plane_counts=np.asarray([len(p) for p in self.pre_planes],
                                        np.int64),
            book_world=np.asarray(book.world, np.float64).reshape(-1, 4),
            book_seen=np.asarray(book.seen_count, np.int64),
            book_last=np.asarray(book.last_seen, np.int64),
            counts=json.dumps(counts))


def _per_rescue(x, name):
    """A saved run's ``name`` planes split by rescue step (None if the
    file has none)."""
    if name not in x:
        return None
    return np.split(x[name], np.cumsum(x[name.replace("planes",
                                                      "plane_counts")])[:-1])


def _same(a, b):
    return a.shape == b.shape and (not len(a)
                                   or np.abs(a - b).max() <= PLANE_TOL)


def compare(run, ref):
    """Hold one run's arrays (``RescueRecorder.arrays`` or a loaded
    ``.npz``) to another's: counts, the first rescue whose row, planes or
    fresh pre-node planes differ, the first frame whose final position
    differs, the largest final position gap."""
    ca, cb = (json.loads(str(x["counts"])) for x in (run, ref))
    ra, rb = run["rescue"], ref["rescue"]
    pa, pb = (_per_rescue(x, "rescue_planes") for x in (run, ref))
    qa, qb = (_per_rescue(x, "pre_planes") for x in (run, ref))
    first_rescue = None
    for i in range(min(len(ra), len(rb))):
        same_pre = qa is None or qb is None or _same(qa[i], qb[i])
        if not (np.array_equal(ra[i], rb[i]) and _same(pa[i], pb[i])
                and same_pre):
            first_rescue = {"index": i, "port": ra[i].tolist(),
                            "reference": rb[i].tolist(),
                            "planes_port": pa[i].tolist(),
                            "planes_reference": pb[i].tolist()}
            if not same_pre:
                first_rescue.update(pre_planes_port=qa[i].tolist(),
                                    pre_planes_reference=qb[i].tolist())
            break
    if first_rescue is None and len(ra) != len(rb):
        first_rescue = {"index": min(len(ra), len(rb)),
                        "rescues": [len(ra), len(rb)]}
    same_seqs = np.array_equal(run["seq_ids"], ref["seq_ids"])
    gap = np.linalg.norm(run["pose_t"] - ref["pose_t"], axis=1) \
        if same_seqs else None
    far = np.nonzero(gap > POSE_TOL_M)[0] if same_seqs else []
    return {
        "ate_rel": abs(ca["ate_rmse_m"] - cb["ate_rmse_m"])
        / cb["ate_rmse_m"],
        "ate_m": [ca["ate_rmse_m"], cb["ate_rmse_m"]],
        "counts_equal": all(ca[k] == cb[k] for k in
                            ("rescue_steps", "n_plane_factors",
                             "landmarks")),
        "rescue_rows_equal": np.array_equal(ra, rb),
        "pre_planes_compared": qa is not None and qb is not None,
        "first_differing_rescue": first_rescue,
        "seq_ids_equal": same_seqs,
        "max_position_gap_m": float(gap.max()) if same_seqs else None,
        "first_frame_beyond_1e-6_m": int(run["seq_ids"][far[0]])
        if len(far) else None,
        "landmarks_max_abs_diff": float(np.abs(
            run["book_world"] - ref["book_world"]).max())
        if run["book_world"].shape == ref["book_world"].shape else None}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--device", default=None,
                    help="the port's device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0,
                    help="VioConfig.seed: the key of the RANSAC draws")
    ap.add_argument("--save", default=None,
                    help="write the run's poses and rescue records here")
    ap.add_argument("--against", default=None,
                    help="a --save file of the run to hold this one to")
    ap.add_argument("--load", default=None,
                    help="a --save file to hold to --against, instead of "
                         "a replay")
    args = ap.parse_args()
    if args.load and not args.against:
        ap.error("--load needs --against")
    if args.load:
        with np.load(args.load) as run, np.load(args.against) as ref:
            print(json.dumps(dict(compare(run, ref), file=args.load,
                                  against=args.against)))
        return
    import torch

    from graph_slam_tpu_torch.datasets import make_vio_plane_scenario
    from graph_slam_tpu_torch.pipelines import VioConfig, run_vio, vio_planes
    from graph_slam_tpu_torch.planes import plane_node

    device = args.device or "cuda"
    log, times, stream, params, frames, K, (gt_R, gt_t) = \
        make_vio_plane_scenario(n_frames=args.frames, fail_every=100,
                                render="lazy", return_gt=True,
                                device=device)
    rec = RescueRecorder(vio_planes, plane_node)
    t0 = time.perf_counter()
    try:
        res = run_vio(log, times, stream, params, frames=frames,
                      intrinsics=K, cfg=VioConfig(**RESCUE_CFG,
                                                  final_batch=False,
                                                  seed=args.seed),
                      device=device, dtype=torch.float64)
    finally:
        rec.undo()
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = len(res.seq_ids)
    seqs = np.asarray(res.seq_ids, int)
    ate, rot = _ate(res.values.pose_R[:n].double().cpu().numpy(),
                    res.values.pose_t[:n].double().cpu().numpy(),
                    gt_R[seqs], gt_t[seqs])
    out = {
        "frames": args.frames, "seed": args.seed, "ate_rmse_m": ate,
        "ate_rot_mean_deg": rot,
        "path_m": float(np.linalg.norm(np.diff(gt_t, axis=0),
                                       axis=1).sum()),
        "n_plane_factors": int(res.n_plane_factors),
        "landmarks": len(res.plane_book.world), "engine": "scan",
        "rescue_steps": res.timers["rescue_step"]["calls"],
        "error": res.error, "wall_s": wall, "device": device,
        "torch": torch.__version__}
    arrays = rec.arrays(res, out)
    if args.save:
        np.savez_compressed(args.save, **arrays)
    if args.against:
        with np.load(args.against) as ref:
            out["against"] = dict(compare(arrays, ref), file=args.against)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
