"""The benchmark's frozen generators draw what the port's generators draw."""

import numpy as np
import pytest
import torch

from graph_slam_tpu_torch.config import SR4000
from graph_slam_tpu_torch.datasets import make_ba_graph, make_sphere_graph
from graph_slam_tpu_torch.graph import GraphBuilder
from graph_slam_tpu_torch.io.trajectory import read_g2o
from graph_slam_tpu_torch.vision.cal3ds2 import Cal3DS2, project_point
from portbench.gen import synthetic as gen
from portbench.reference import pose_graph as ref_pg

CAL = [SR4000.fx, SR4000.fy, 0.0, SR4000.cx, SR4000.cy, SR4000.k1,
       SR4000.k2, SR4000.p1, SR4000.p2]


def host(x):
    return x.detach().cpu().numpy()


@pytest.mark.parametrize("n,epp,seed", [(40, 2.0, 0), (64, 1.98, 7)])
def test_sphere_graph_equals_make_sphere_graph(n, epp, seed):
    g_port, v_port, _ = make_sphere_graph(n, epp, 0.02, 0.1, seed,
                                          dtype=torch.float64, device="cpu",
                                          bucket=64)
    a = gen.sphere_graph(n, int((epp - 1.0) * n), 0.02, 0.1, seed)
    b = GraphBuilder()
    for k in range(n):
        b.add_pose((a["init_R"][k], a["init_t"][k]))
    b.add_prior_pose(0, (a["gt_R"][0], a["gt_t"][0]),
                     sigmas=np.full(6, 1e-6))
    for e in range(a["i"].shape[0]):
        b.add_between(int(a["i"][e]), int(a["j"][e]),
                      (a["meas_R"][e], a["meas_t"][e]),
                      information=a["info"])
    g, v = b.build(bucket=64, device="cpu", dtype=torch.float64)
    for x, y in ((v.pose_R, v_port.pose_R), (v.pose_t, v_port.pose_t)):
        np.testing.assert_array_equal(host(x), host(y))
    for f in g.between._fields:
        np.testing.assert_array_equal(host(getattr(g.between, f)),
                                      host(getattr(g_port.between, f)))


def test_ba_geometry_equals_make_ba_graph():
    n, m, seed = 12, 300, 5
    _, _, ((Rs, ts), _) = make_ba_graph(n, m, 4, 0.5, 0.05, seed,
                                        dtype=torch.float64, device="cpu",
                                        bucket=64)
    R, t = gen.ba_arc_poses(n)
    np.testing.assert_array_equal(R, np.stack(Rs))
    np.testing.assert_array_equal(t, np.stack(ts))
    local = np.random.default_rng(1).uniform([-1, -1, 0.5], [1, 1, 6],
                                             (500, 3))
    uv = project_point(Cal3DS2(*(torch.tensor(c, dtype=torch.float64)
                                 for c in CAL)),
                       torch.as_tensor(local))
    np.testing.assert_allclose(gen.project_cal3ds2(CAL, local), host(uv),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("n,m,obs,seed", [(40, 300, 1300, 5),
                                          (64, 500, 1729, 2 ** 33 + 3)])
def test_bal_problem_has_the_counts_and_tracks(n, m, obs, seed):
    p = gen.bal_problem(n, m, obs, 2, 3, (176, 144), 0.5, 0.05, 0.1, CAL,
                        seed)
    f = p["pose_idx"].shape[0]
    assert f == obs and p["points"].shape == (m, 3)
    counts = np.bincount(p["point_idx"], minlength=m)
    hist = gen.track_lengths(m, obs, 2, n // np.gcd(n, 3))
    np.testing.assert_array_equal(np.bincount(counts, minlength=hist.size),
                                  hist)
    assert counts.min() >= 2
    rows = p["pose_idx"] * m + p["point_idx"]
    assert np.all(np.diff(rows) > 0)    # camera by camera, as BAL lists
    # them, and no camera twice in a track
    R, t = p["gt_R"][p["pose_idx"]], p["gt_t"][p["pose_idx"]]
    local = np.einsum("fji,fj->fi", R, p["points"][p["point_idx"]] - t)
    assert local[:, 2].min() >= 0.3
    clean = gen.project_cal3ds2(CAL, local)
    assert clean.min() >= 0 and np.all(clean < [176, 144])
    assert 0.3 < np.abs(p["uv"] - clean).std() < 0.7
    again = gen.bal_problem(n, m, obs, 2, 3, (176, 144), 0.5, 0.05, 0.1,
                            CAL, seed)
    for k in p:
        np.testing.assert_array_equal(p[k], again[k])
    other = gen.bal_problem(n, m, obs, 2, 3, (176, 144), 0.5, 0.05, 0.1,
                            CAL, seed + 1)
    np.testing.assert_array_equal(np.sort(counts), np.sort(np.bincount(
        other["point_idx"], minlength=m)))     # every seed the same sizes


def test_starts_are_the_generators_recipe_and_keyed():
    a = gen.sphere_graph(30, 20, 0.02, 0.1, 3)
    R1, t1 = gen.sphere_start(a["gt_R"], a["gt_t"], 0.1, (3, 1, 0))
    R2, t2 = gen.sphere_start(a["gt_R"], a["gt_t"], 0.1, (3, 1, 0))
    R3, _ = gen.sphere_start(a["gt_R"], a["gt_t"], 0.1, (3, 1, 1))
    np.testing.assert_array_equal(R1, R2)
    assert not np.array_equal(R1, R3)
    np.testing.assert_array_equal(R1[0], a["gt_R"][0])
    np.testing.assert_allclose(R1 @ R1.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R1.shape),
                               atol=1e-10)
    big = gen.rng(2 ** 33 + 5, 1, 0).normal()
    assert np.isfinite(big)


def test_g2o_writer_is_read_alike_by_the_port_and_the_reference(tmp_path):
    a = gen.sphere_graph(30, 20, 0.02, 0.1, 4)
    R, t = gen.sphere_start(a["gt_R"], a["gt_t"], 0.1, (4, 1, 2))
    path = str(tmp_path / "g.g2o")
    gen.write_g2o(path, R, t, a)
    verts, edges = read_g2o(path)
    ids, vt, vq, ei, ej, et, eq, info = ref_pg.read_g2o(path)
    np.testing.assert_array_equal(ids, np.arange(30))
    np.testing.assert_array_equal(vt, t)
    np.testing.assert_array_equal(vt, np.stack([verts[k][0]
                                                for k in range(30)]))
    np.testing.assert_array_equal(vq, np.stack([verts[k][1]
                                                for k in range(30)]))
    np.testing.assert_allclose(ref_pg.quat_to_matrix(vq), R, atol=2e-16)
    np.testing.assert_array_equal(ei, a["i"])
    np.testing.assert_array_equal(ej, a["j"])
    np.testing.assert_array_equal(et, a["meas_t"])
    np.testing.assert_array_equal(info[0], a["info"])
    np.testing.assert_array_equal(info, np.stack([e[4] for e in edges]))
