"""TUM RGB-D benchmark ingestion (rgb.txt / depth.txt / groundtruth.txt) —
a copy of ``graph_slam_tpu/io/tum.py`` (numpy; PIL imported at first read).

The reference reads SR4000 ``.bdat`` streams and RealSense recordings via
absent sibling repos; the de-facto public RGB-D benchmark format is the
TUM layout (Sturm et al., IROS 2012): a directory with ``rgb/`` and
``depth/`` PNG folders indexed by ``rgb.txt``/``depth.txt`` timestamp
lists (16-bit depth PNGs, 1/5000 m per unit) and a ``groundtruth.txt``
trajectory (``t tx ty tz qx qy qz qw``).

``TumDataset`` exposes the standard ``seq -> (intensity, depth_m)``
callable contract shared by every frame source here, with rgb<->depth
association by the benchmark's greedy nearest-timestamp rule, so every
pipeline and CLI tool (map, tsdf, video, online SLAM, BA) runs on a TUM
sequence unmodified. ``read_tum_groundtruth`` converts the ground truth
into the framework's ``Trajectory`` (w-first quaternions) for ATE/RPE.
"""

from __future__ import annotations

import os

import numpy as np

from .trajectory import Trajectory

__all__ = ["TumDataset", "associate_timestamps", "read_tum_groundtruth",
           "groundtruth_at", "is_tum_dir"]


def _read_list(path):
    """TUM list file -> (timestamps (N,), names [N])."""
    ts, names = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            ts.append(float(tok[0]))
            names.append(tok[1])
    return np.asarray(ts), names


def associate_timestamps(times_a, times_b, max_dt: float = 0.02):
    """Greedy best-first association (the benchmark's associate.py rule):
    smallest |ta - tb| pairs win, each a/b used at most once. Returns
    (idx_a, idx_b) arrays. Candidates come from each a's two sort
    neighbors in b, so this stays O(A+B) memory where the benchmark
    script's cross-product is O(A*B)."""
    times_a = np.asarray(times_a, float)
    times_b = np.asarray(times_b, float)
    if len(times_a) == 0 or len(times_b) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    b_order = np.argsort(times_b, kind="stable")
    tb = times_b[b_order]
    j = np.searchsorted(tb, times_a)
    cand_a, cand_b = [], []
    for off in (-1, 0):
        bb = np.clip(j + off, 0, len(tb) - 1)
        cand_a.append(np.arange(len(times_a)))
        cand_b.append(b_order[bb])
    ia = np.concatenate(cand_a)
    ib = np.concatenate(cand_b)
    diffs = np.abs(times_a[ia] - times_b[ib])
    keep = diffs <= max_dt
    ia, ib, diffs = ia[keep], ib[keep], diffs[keep]
    order = np.argsort(diffs)
    used_a, used_b = set(), set()
    out = []
    for k in order:
        a, b = int(ia[k]), int(ib[k])
        if a in used_a or b in used_b:
            continue
        used_a.add(a)
        used_b.add(b)
        out.append((a, b))
    out.sort()
    if not out:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    arr = np.asarray(out)
    return arr[:, 0], arr[:, 1]


def is_tum_dir(directory: str) -> bool:
    return (os.path.exists(os.path.join(directory, "rgb.txt"))
            and os.path.exists(os.path.join(directory, "depth.txt")))


class TumDataset:
    """Associated TUM sequence as a frame source.

    ``seq`` indexes the associated pairs in time order; ``timestamps``
    gives each pair's rgb timestamp (for IMU sync / gt alignment).
    """

    def __init__(self, directory: str, max_dt: float = 0.02,
                 depth_scale: float = 1.0 / 5000.0):
        self.dir = directory
        self.depth_scale = depth_scale
        rgb_t, rgb_n = _read_list(os.path.join(directory, "rgb.txt"))
        dep_t, dep_n = _read_list(os.path.join(directory, "depth.txt"))
        ia, ib = associate_timestamps(rgb_t, dep_t, max_dt)
        self.timestamps = rgb_t[ia]
        self._rgb = [rgb_n[i] for i in ia]
        self._dep = [dep_n[i] for i in ib]

    def __len__(self) -> int:
        return len(self._rgb)

    def __call__(self, seq: int):
        if seq < 0 or seq >= len(self._rgb):
            return None
        from PIL import Image

        rgb = np.asarray(
            Image.open(os.path.join(self.dir, self._rgb[seq])),
            dtype=np.float32)
        if rgb.ndim == 3:
            rgb = rgb[..., :3] @ np.asarray([0.299, 0.587, 0.114],
                                            np.float32)
        dep = np.asarray(
            Image.open(os.path.join(self.dir, self._dep[seq])))
        return rgb, dep.astype(np.float32) * self.depth_scale


def _read_gt_rows(path: str):
    """groundtruth.txt -> (timestamps (N,), t (N,3), quat_wxyz (N,4))."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = [float(x) for x in line.split()]
            if len(tok) < 8:
                continue
            rows.append(tok[:8])
    arr = np.asarray(rows).reshape(-1, 8)
    quat_wxyz = np.concatenate([arr[:, 7:8], arr[:, 4:7]], axis=1)
    return arr[:, 0], arr[:, 1:4], quat_wxyz


def read_tum_groundtruth(path: str) -> Trajectory:
    """groundtruth.txt (t tx ty tz qx qy qz qw) -> Trajectory (w-first)."""
    ts, t, quat_wxyz = _read_gt_rows(path)
    n = len(ts)
    return Trajectory(ids=np.arange(n), t=t, quat=quat_wxyz,
                      seq=np.arange(n))


def groundtruth_at(path: str, timestamps, max_dt: float = 0.02):
    """Ground-truth poses at the query ``timestamps`` (benchmark eval rule:
    nearest-timestamp association, unmatched queries dropped).

    Returns ``(query_idx, t (M,3), quat_wxyz (M,4))`` where ``query_idx``
    selects the matched entries of ``timestamps`` — feed the estimated
    trajectory rows at those indices to ``utils.metrics.ate_rmse``.
    """
    gt_ts, gt_t, gt_q = _read_gt_rows(path)
    iq, ig = associate_timestamps(np.asarray(timestamps, float), gt_ts,
                                  max_dt=max_dt)
    return iq, gt_t[ig], gt_q[ig]
