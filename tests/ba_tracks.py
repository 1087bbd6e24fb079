"""A bundle-adjustment graph with tracks of mixed length, for the
square-root Schur's width classes: numpy edits of ``make_ba_graph``'s
tables that the port's tests apply alike to the JAX package's graph and to
the port's (``make`` turns a numpy array into the package's array).

``MIXED`` is the generator's call: 16 cameras, 60 landmarks each seen by
12 of them, bucket 16 (so 4 dead landmark rows). ``mix_tracks`` keeps
each landmark's first ``TRACKS[q]`` observations: lengths 2 to 9 drawn
from a geometric law, landmark 0 all 12 (the long track), landmark 1 none
(its prior alone), landmark 2 one; landmark 3 gets a second prior.
"""

import numpy as np

MIXED = dict(n_poses=16, n_points=60, obs_per_point=12, seed=7,
             pixel_noise=0.5, bucket=16)
TRACKS = np.clip(1 + np.random.default_rng(11).geometric(0.35, 60), 2, 9)
TRACKS[:3] = (12, 0, 1)


def keep_first(point_idx, active, tracks):
    """Active mask that keeps landmark q's first ``tracks[q]`` active
    projection rows, in row order."""
    rows = np.flatnonzero(active)
    q = point_idx[rows]
    order = np.argsort(q, kind="stable")
    counts = np.bincount(q, minlength=len(tracks))
    rank = np.empty(rows.size, np.int64)
    rank[order] = np.arange(rows.size) - np.repeat(
        np.cumsum(counts) - counts, counts)
    out = np.zeros_like(active)
    out[rows] = rank < tracks[q]
    return out


def second_prior(graph, values, q, make):
    """Re-anchor landmark ``q`` with a second, offset prior in the first
    free row of the point-prior table."""
    pp = graph.prior_point
    slot = int(np.asarray(pp.active).sum())
    idx, mean = np.array(pp.idx), np.array(pp.mean)
    S, act = np.array(pp.sqrt_info), np.array(pp.active)
    idx[slot], mean[slot] = q, np.asarray(values.point[q]) + 0.05
    S[slot], act[slot] = np.eye(3) * 5.0, True
    return graph._replace(prior_point=pp._replace(
        idx=make(idx), mean=make(mean), sqrt_info=make(S), active=make(act)))


def mix_tracks(graph, values, make):
    """``MIXED``'s graph with ``TRACKS``' lengths and landmark 3's second
    prior."""
    pj = graph.projection
    act = keep_first(np.asarray(pj.point_idx), np.asarray(pj.active), TRACKS)
    graph = graph._replace(projection=pj._replace(active=make(act)))
    return second_prior(graph, values, 3, make)
