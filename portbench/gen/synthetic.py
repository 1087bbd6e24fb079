"""The benchmark's input generators, as numpy arrays.

``sphere_graph`` is a frozen copy of ``graph_slam_tpu_torch.datasets.
make_sphere_graph`` (it draws the same, in the same order); ``bal_problem``
places cameras and landmarks as ``make_ba_graph`` does (``ba_arc_poses``,
``project_cal3ds2`` are its copies) and gives them a BAL problem's counts
and track lengths. The benchmark keeps its own copies so that a later
change to the program cannot change the yardstick's inputs;
``tests/test_portbench_gen.py`` holds them to the port's generators at a
small size.

``sphere_start`` and ``ba_start`` draw further initial estimates of the
same kind (the generators' own perturbation recipe) from a key of their
own, so one graph can be solved from several starts.
"""

from __future__ import annotations

import numpy as np

SPHERE_INFO = np.diag([100.0, 100.0, 100.0, 25.0, 25.0, 25.0])


def rng(*key):
    """A numpy generator keyed by non-negative integers (any size)."""
    return np.random.default_rng([int(k) % (1 << 64) for k in key])


def so3_exp(w):
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-10:
        return np.eye(3) + W
    return np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th**2 * (W @ W)


def so3_exp_batch(w):
    """(N, 3) -> (N, 3, 3) Rodrigues, the same formula as ``so3_exp``."""
    th = np.linalg.norm(w, axis=1)
    z = np.zeros_like(th)
    W = np.stack([np.stack([z, -w[:, 2], w[:, 1]], -1),
                  np.stack([w[:, 2], z, -w[:, 0]], -1),
                  np.stack([-w[:, 1], w[:, 0], z], -1)], -2)
    small = th < 1e-10
    ths = np.where(small, 1.0, th)
    a = np.where(small, 1.0, np.sin(ths) / ths)
    b = np.where(small, 0.0, (1 - np.cos(ths)) / ths**2)
    return np.eye(3) + a[:, None, None] * W + b[:, None, None] * (W @ W)


def sphere_ground_truth(n_poses: int, radius: float = 10.0, turns: int = 25):
    """Spiral over a sphere: rotations (N, 3, 3) and positions (N, 3)."""
    k = np.arange(n_poses)
    phi = np.arccos(1 - 2 * (k + 0.5) / n_poses)
    lam = np.pi * turns * phi
    pos = radius * np.stack(
        [np.sin(phi) * np.cos(lam), np.sin(phi) * np.sin(lam), np.cos(phi)],
        axis=1)
    Rs = []
    for i in range(n_poses):
        fwd = pos[i + 1] - pos[i] if i + 1 < n_poses else pos[i] - pos[i - 1]
        fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
        up = pos[i] / (np.linalg.norm(pos[i]) + 1e-12)
        left = np.cross(up, fwd)
        left /= np.linalg.norm(left) + 1e-12
        fwd2 = np.cross(left, up)
        Rs.append(np.stack([fwd2, left, up], axis=1))
    return np.stack(Rs), pos


def sphere_graph(n_poses: int, n_loops: int, meas_noise: float,
                 init_noise: float, seed: int):
    """The sphere pose graph: ``n_poses - 1`` odometry edges and
    ``n_loops`` loop closures between poses 2-49 apart in the spiral, each
    measurement perturbed by ``meas_noise``, and the generator's own
    initial estimate. Returns a dict of arrays: ``gt_R``, ``gt_t``,
    ``init_R``, ``init_t``, ``i``, ``j``, ``meas_R``, ``meas_t`` and the
    shared ``info`` (6, 6)."""
    r = np.random.default_rng(seed)
    Rs, ts = sphere_ground_truth(n_poses)
    init_R, init_t = Rs.copy(), ts.copy()
    for i in range(1, n_poses):
        if init_noise == 0:
            break
        dR = so3_exp(r.normal(size=3) * init_noise * 0.3)
        init_R[i] = Rs[i] @ dR
        init_t[i] = ts[i] + r.normal(size=3) * init_noise

    def noisy(i, j):
        Rij, tij = Rs[i].T @ Rs[j], Rs[i].T @ (ts[j] - ts[i])
        dR = so3_exp(r.normal(size=3) * meas_noise * 0.3)
        return Rij @ dR, tij + r.normal(size=3) * meas_noise

    pairs = [(i, i + 1) for i in range(n_poses - 1)]
    meas = [noisy(i, j) for i, j in pairs]
    cand_i = r.integers(0, n_poses - 1, size=3 * n_loops)
    cand_j = cand_i + r.integers(2, 50, size=3 * n_loops)
    keep = cand_j < n_poses
    loops = [(int(i), int(j)) for i, j in
             zip(cand_i[keep][:n_loops], cand_j[keep][:n_loops])]
    pairs += loops
    meas += [noisy(i, j) for i, j in loops]
    ij = np.asarray(pairs, np.int64)
    return {"gt_R": Rs, "gt_t": ts, "init_R": init_R, "init_t": init_t,
            "i": ij[:, 0], "j": ij[:, 1],
            "meas_R": np.stack([m[0] for m in meas]),
            "meas_t": np.stack([m[1] for m in meas]),
            "info": SPHERE_INFO.copy()}


def sphere_start(gt_R, gt_t, init_noise: float, key):
    """An initial estimate by the generator's recipe: every pose but the
    first rotated by exp(0.3 init_noise n) and moved by init_noise n."""
    r = rng(*key)
    n = gt_t.shape[0]
    w = r.normal(size=(n, 3)) * init_noise * 0.3
    dt = r.normal(size=(n, 3)) * init_noise
    w[0] = 0.0
    dt[0] = 0.0
    return gt_R @ so3_exp_batch(w), gt_t + dt


def project_cal3ds2(cal, local):
    """The generator's numpy Cal3DS2 projection (no skew, depth >= 1e-6)."""
    fx, fy, _, cx, cy, k1, k2, p1, p2 = cal
    z = np.maximum(local[:, 2], 1e-6)
    x = local[:, 0] / z
    y = local[:, 1] / z
    r2 = x * x + y * y
    g = 1.0 + k1 * r2 + k2 * r2 * r2
    dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    dy = 2 * p2 * x * y + p1 * (r2 + 2 * y * y)
    return np.stack([fx * (g * x + dx) + cx, fy * (g * y + dy) + cy], axis=1)


def ba_arc_poses(n_poses: int):
    Rs = np.stack([so3_exp(np.array([0.0, 0.5 * np.sin(2 * np.pi * k
                                                        / n_poses), 0.0]))
                   for k in range(n_poses)])
    ts = np.stack([np.array([2.0 * k / n_poses,
                             0.1 * np.sin(4 * np.pi * k / n_poses), 0.0])
                   for k in range(n_poses)])
    return Rs, ts


def track_lengths(n_points: int, n_observations: int, min_track: int,
                  max_track: int):
    """How many landmarks have each track length: a geometric law of
    lengths ``min_track``, ``min_track + 1``, ... whose mean is
    ``n_observations / n_points``, cut at ``max_track``, rounded so that
    the counts add up to ``n_points`` landmarks and exactly
    ``n_observations`` observations. Independent of any seed: every seed
    solves the same sizes. Returns counts indexed by length."""
    extra = n_observations / n_points - min_track
    if not 0 < extra < max_track - min_track:
        raise ValueError(f"mean track {n_observations / n_points} not in "
                         f"({min_track}, {max_track})")
    p = 1.0 / (1.0 + extra)
    L = np.arange(min_track, max_track + 1)
    pmf = p * (1 - p) ** (L - min_track)
    pmf /= pmf.sum()
    c = n_points * pmf
    counts = np.floor(c).astype(np.int64)
    counts[np.argsort(counts - c)[:n_points - counts.sum()]] += 1
    # move single landmarks one length up (or down) until the
    # observations add up
    d = n_observations - int((L * counts).sum())
    step = 1 if d > 0 else -1
    for k in range(abs(d)):
        lo = int(np.argmax(counts[:-1] if step > 0 else counts[1:]))
        src = lo if step > 0 else lo + 1
        counts[src] -= 1
        counts[src + step] += 1
    out = np.zeros(max_track + 1, np.int64)
    out[L] = counts
    assert out.sum() == n_points and (np.arange(max_track + 1)
                                      * out).sum() == n_observations
    return out


def bal_problem(n_poses: int, n_points: int, n_observations: int,
                min_track: int, spacing: int, image, pixel_noise: float,
                init_noise: float, point_sigma: float, cal, seed: int,
                rows_by_camera: bool = True):
    """A bundle-adjustment problem with a BAL problem's counts, on the
    cameras (``ba_arc_poses``) and in the box of the port's
    ``make_ba_graph``: landmarks are drawn uniform in [-2, 4] x [-2, 2] x
    [3, 8] m, and a landmark is kept where ``min_track`` or more of its
    candidate cameras see it (anchor, anchor + ``spacing``, anchor + 2
    ``spacing``, ... modulo the cameras; it sees the landmark where it
    lies 0.3 m or more in front and projects inside ``image``, width and
    height in pixels), until ``n_points`` are kept. Track lengths follow
    ``track_lengths``, the longer ones to the landmarks more cameras see
    (ties in an order drawn from the seed), and a landmark's cameras are
    the first that many that see it, each projection perturbed by
    ``pixel_noise``; the initial estimate is drawn as ``make_ba_graph``
    draws it. ``cal`` is (fx, fy, s, cx, cy, k1, k2, p1, p2). Returns a
    dict of arrays: ``gt_R``, ``gt_t``, ``points`` (true), ``init_R``,
    ``init_t``, ``init_points``, exactly ``n_observations`` projection
    rows ``pose_idx``, ``point_idx``, ``uv`` (camera by camera, each
    camera's by landmark, as a BAL file lists its observations; landmark
    by landmark where not ``rows_by_camera``), ``cal`` and
    ``point_sigma``."""
    cal = np.asarray(cal, np.float64)
    cycle = n_poses // np.gcd(n_poses, spacing)
    hist = track_lengths(n_points, n_observations, min_track, cycle)
    r = np.random.default_rng(seed)
    Rs, ts = ba_arc_poses(n_poses)
    cand = 2 * n_points
    pts = np.stack([r.uniform(-2, 4, cand), r.uniform(-2, 2, cand),
                    r.uniform(3.0, 8.0, cand)], axis=1)
    anchors = r.integers(0, n_poses, size=cand)
    cams = (anchors[:, None] + spacing * np.arange(cycle)) % n_poses
    px = np.empty((cand, cycle, 2))
    vis = np.empty((cand, cycle), bool)
    for c in range(cycle):
        local = np.einsum("qji,qj->qi", Rs[cams[:, c]], pts - ts[cams[:, c]])
        px[:, c] = project_cal3ds2(cal, local)
        vis[:, c] = (local[:, 2] >= 0.3) & np.all(
            (px[:, c] >= 0) & (px[:, c] < np.asarray(image, np.float64)), 1)
    keep = np.flatnonzero(vis.sum(1) >= min_track)[:n_points]
    if keep.size < n_points:
        raise ValueError(f"{keep.size} of {cand} landmarks drawn are seen "
                         f"by {min_track} cameras; {n_points} wanted")
    pts, cams, px, vis = pts[keep], cams[keep], px[keep], vis[keep]
    init_R, init_t = Rs.copy(), ts.copy()
    for k in range(1, n_poses):
        if init_noise == 0:
            break
        dR = so3_exp(r.normal(size=3) * init_noise * 0.3)
        init_R[k] = Rs[k] @ dR
        init_t[k] = ts[k] + r.normal(size=3) * init_noise
    init_points = pts + r.normal(size=(n_points, 3)) * init_noise
    rank = np.lexsort((r.permutation(n_points), vis.sum(1)))
    lengths = np.empty(n_points, np.int64)
    lengths[rank] = np.repeat(np.arange(hist.size), hist)
    take = vis & (np.cumsum(vis, axis=1) <= lengths[:, None])
    short = take.sum(1) < lengths
    if short.any():
        raise ValueError(f"{int(short.sum())} landmarks are seen by fewer "
                         f"cameras than their track length")
    q, c = np.nonzero(take)                 # landmark by landmark
    uv = px[q, c] + r.normal(size=(q.size, 2)) * pixel_noise
    cam = cams[q, c]
    if rows_by_camera:                      # a BAL file's order
        order = np.lexsort((q, cam))
        q, cam, uv = q[order], cam[order], uv[order]
    return {"pose_idx": cam, "point_idx": q, "uv": uv, "gt_R": Rs,
            "gt_t": ts, "points": pts, "init_R": init_R, "init_t": init_t,
            "init_points": init_points, "cal": cal,
            "point_sigma": point_sigma}


def ba_start(prob, init_noise: float, key):
    """An initial estimate by the generator's recipe: cameras but the first
    perturbed as in ``sphere_start``, landmarks moved by init_noise n."""
    r = rng(*key)
    n, m = prob["gt_t"].shape[0], prob["points"].shape[0]
    w = r.normal(size=(n, 3)) * init_noise * 0.3
    dt = r.normal(size=(n, 3)) * init_noise
    w[0] = 0.0
    dt[0] = 0.0
    pts = prob["points"] + r.normal(size=(m, 3)) * init_noise
    return prob["gt_R"] @ so3_exp_batch(w), prob["gt_t"] + dt, pts


def matrix_to_quat_wxyz(R):
    """(N, 3, 3) rotations -> (N, 4) unit quaternions (w, x, y, z), w >= 0,
    by Shepperd's method (the largest of the four candidates)."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R, axis1=1, axis2=2)
    cand = np.stack([tr, R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]], axis=1)
    k = np.argmax(cand, axis=1)
    q = np.empty((R.shape[0], 4))
    for c in range(4):
        s = k == c
        if not s.any():
            continue
        Rs = R[s]
        if c == 0:
            d = np.sqrt(1.0 + tr[s]) * 2.0
            q[s] = np.stack([0.25 * d, (Rs[:, 2, 1] - Rs[:, 1, 2]) / d,
                             (Rs[:, 0, 2] - Rs[:, 2, 0]) / d,
                             (Rs[:, 1, 0] - Rs[:, 0, 1]) / d], 1)
        else:
            a, b, e = (c - 1, c % 3, (c + 1) % 3)
            d = np.sqrt(1.0 + Rs[:, a, a] - Rs[:, b, b] - Rs[:, e, e]) * 2.0
            qv = np.empty((Rs.shape[0], 4))
            qv[:, 0] = (Rs[:, e, b] - Rs[:, b, e]) / d
            qv[:, 1 + a] = 0.25 * d
            qv[:, 1 + b] = (Rs[:, b, a] + Rs[:, a, b]) / d
            qv[:, 1 + e] = (Rs[:, e, a] + Rs[:, a, e]) / d
            q[s] = qv
    q *= np.where(q[:, :1] < 0, -1.0, 1.0)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def write_g2o(path, R, t, graph):
    """g2o text: ``VERTEX_SE3:QUAT id x y z qx qy qz qw`` for every pose
    and ``EDGE_SE3:QUAT i j x y z qx qy qz qw`` + the 21 upper-triangular
    information entries for every edge, each number printed with ``repr``
    (every digit of the float64)."""
    q = matrix_to_quat_wxyz(R).tolist()
    qe = matrix_to_quat_wxyz(graph["meas_R"]).tolist()
    t = np.asarray(t, np.float64).tolist()
    mt = np.asarray(graph["meas_t"], np.float64).tolist()
    ii, jj = graph["i"].tolist(), graph["j"].tolist()
    info = " ".join(repr(v) for v in
                    graph["info"][np.triu_indices(6)].tolist())
    lines = [f"VERTEX_SE3:QUAT {k} {p[0]!r} {p[1]!r} {p[2]!r} "
             f"{a[1]!r} {a[2]!r} {a[3]!r} {a[0]!r}"
             for k, (p, a) in enumerate(zip(t, q))]
    lines += [f"EDGE_SE3:QUAT {i} {j} {p[0]!r} {p[1]!r} {p[2]!r} "
              f"{a[1]!r} {a[2]!r} {a[3]!r} {a[0]!r} {info}"
              for i, j, p, a in zip(ii, jj, mt, qe)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
