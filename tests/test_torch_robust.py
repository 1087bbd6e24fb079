"""Parity of the port's robust pose-graph tools with the JAX package, on
the CPU in float64: chordal initialization, PCM loop gating, GNC with TLS
and GM weights, and ``run_pose_graph``'s ``loop_gate``/``init``/``robust``
options.

Shapes are the JAX tests' own (``tests/test_pcm.py``'s 120-pose sphere with
8 planted outliers, its tie case and its 40-node pipeline log), so the
reference compiles what its own tests compile. One reference run per
scenario is shared through module-scoped fixtures.

Tolerances: masks and index sets bit-equal; m2 (PCM's squared Mahalanobis
distances) 1e-9 relative (a 6x6 solve per pair: Cholesky here, LU in the
reference), with 1e-12 absolute for the diagonal's rounding noise (~1e-20
against a threshold of ~33); poses, weights and chi2 1e-9 (Cholesky solves of systems with
condition up to ~1e12 amplify rounding differences).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_slam_tpu import config as jconfig
from graph_slam_tpu.datasets import make_sphere_graph as j_make_sphere
from graph_slam_tpu.graph import gnc as jgnc
from graph_slam_tpu.graph import init as jinit
from graph_slam_tpu.graph import pcm as jpcm
from graph_slam_tpu.io import VROLog as JVROLog
from graph_slam_tpu.pipelines import posegraph as jpg
from graph_slam_tpu_torch import config
from graph_slam_tpu_torch.convert import arena_from_numpy, graph_from_numpy
from graph_slam_tpu_torch.graph import (chordal_initialize, gnc_optimize,
                                        max_clique, odometry_consistency,
                                        pairwise_consistency, pcm_mask,
                                        project_so3)
from graph_slam_tpu_torch.io import VROLog
from graph_slam_tpu_torch.pipelines import run_pose_graph, trajectory_arrays
from test_pcm import _corrupt

torch.set_num_threads(1)


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _port(graph, values):
    return (graph_from_numpy(_np_tree(graph), device="cpu"),
            arena_from_numpy(_np_tree(values), device="cpu"))


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _close_values(vt, vj, atol=1e-9):
    np.testing.assert_allclose(vt.pose_t.numpy(), np.asarray(vj.pose_t),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(vt.pose_R.numpy(), np.asarray(vj.pose_R),
                               rtol=0, atol=atol)


@pytest.fixture(scope="module")
def corrupted():
    """``tests/test_pcm.py``'s fixture: a 120-pose sphere and a copy with 8
    of its loop closures replaced by garbage, in both packages."""
    gj, vj, _ = j_make_sphere(n_poses=120, edges_per_pose=3.0, seed=0,
                              dtype=jnp.float64, bucket=64)
    gj_bad, bad, good = _corrupt(gj, n_bad=8)
    gt, vt = _port(gj, vj)
    gt_bad, _ = _port(gj_bad, vj)
    return gj, gj_bad, vj, gt, gt_bad, vt, bad, good


# -- chordal initialization ----------------------------------------------------


@pytest.mark.parametrize("which", ["clean", "corrupted"])
def test_chordal_initialize_matches(corrupted, which):
    gj, gj_bad, vj, gt, gt_bad, vt, _, _ = corrupted
    gj, gt = (gj, gt) if which == "clean" else (gj_bad, gt_bad)
    _close_values(chordal_initialize(gt, vt), jinit.chordal_initialize(gj, vj))


def test_project_so3_matches():
    r = np.random.default_rng(3)
    A = r.normal(size=(16, 3, 3))
    A[0] = np.diag([1.0, 2.0, -3.0])       # a reflection to correct
    out = project_so3(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(out, np.asarray(jinit.project_so3(
        jnp.asarray(A))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(out), 1.0, atol=1e-12)


# -- PCM -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def pcm_refs(corrupted):
    gj, gj_bad, vj, *_ = corrupted
    return {"clean": jpcm.pcm_mask(gj, vj), "corrupted": jpcm.pcm_mask(
        gj_bad, vj)}


@pytest.mark.parametrize("which", ["clean", "corrupted"])
def test_pcm_mask_matches(corrupted, pcm_refs, which):
    _, _, _, gt, gt_bad, vt, bad, good = corrupted
    res = pcm_mask(gt if which == "clean" else gt_bad, vt)
    ref = pcm_refs[which]
    np.testing.assert_array_equal(res.candidate_rows, ref.candidate_rows)
    np.testing.assert_allclose(res.m2_odo, ref.m2_odo, rtol=1e-9, atol=0)
    # the diagonal (a loop against itself) is rounding noise, ~1e-20
    np.testing.assert_allclose(res.m2, ref.m2, rtol=1e-9, atol=1e-12)
    assert res.threshold == ref.threshold
    np.testing.assert_array_equal(res.clique_rows, ref.clique_rows)
    np.testing.assert_array_equal(res.accepted, ref.accepted)
    if which == "corrupted":      # tests/test_pcm.py's gate
        assert not res.accepted[bad].any()
        assert res.accepted[good].mean() > 0.9


def test_pcm_consistency_functions_match(corrupted):
    """The public per-test functions with the odometry trusted exactly."""
    gj, gj_bad, vj, _, gt_bad, vt, _, _ = corrupted
    rows = pcm_mask(gt_bad, vt).candidate_rows
    np.testing.assert_allclose(
        odometry_consistency(gt_bad, vt, rows),
        jpcm.odometry_consistency(gj_bad, vj, rows), rtol=1e-9)
    np.testing.assert_allclose(
        pairwise_consistency(gt_bad, vt, rows[:40]),
        jpcm.pairwise_consistency(gj_bad, vj, rows[:40]), rtol=1e-9,
        atol=1e-12)


def test_pcm_pairs_in_chunks_match_one_chunk(corrupted, monkeypatch):
    """The byte bound on a chunk of pairs changes nothing but the chunking."""
    from graph_slam_tpu_torch.graph import pcm

    _, _, _, _, gt_bad, vt, _, _ = corrupted
    rows = pcm_mask(gt_bad, vt).candidate_rows
    whole = pairwise_consistency(gt_bad, vt, rows, 1e-3)
    L = len(rows)
    monkeypatch.setattr(pcm, "_PAIR_CHUNK_BYTES", 7 * L * pcm._PAIR_FLOATS * 8)
    chunked = pairwise_consistency(gt_bad, vt, rows, 1e-3)
    np.testing.assert_array_equal(chunked, whole)


def _tie_graph(builder_cls, **build):
    """``tests/test_pcm.py``'s tie: one good and one wild loop on a chain."""
    import np_lie

    rng = np.random.default_rng(5)
    b = builder_cls()
    n = 20
    for k in range(n):
        b.add_pose((np.eye(3), np.array([0.1 * k, 0.0, 0.0])))
    b.add_prior_pose(0, (np.eye(3), np.zeros(3)), sigmas=np.full(6, 1e-6))
    info = np.eye(6) * 400.0
    for k in range(n - 1):
        b.add_between(k, k + 1, (np.eye(3), np.array([0.1, 0, 0])),
                      information=info)
    b.add_between(0, n - 1, (np.eye(3), np.array([0.1 * (n - 1), 0, 0])),
                  information=info)
    b.add_between(1, n - 2, (np_lie.so3_exp(rng.normal(size=3)),
                             rng.normal(size=3) * 2.0), information=info)
    return b.build(bucket=32, **build)


def test_pcm_tie_breaks_toward_the_good_loop():
    from graph_slam_tpu.graph import GraphBuilder as JBuilder
    from graph_slam_tpu_torch.graph import GraphBuilder

    gj, vj = _tie_graph(JBuilder)
    gt, vt = _tie_graph(GraphBuilder, device="cpu")
    res, ref = pcm_mask(gt, vt), jpcm.pcm_mask(gj, vj)
    np.testing.assert_array_equal(res.accepted, ref.accepted)
    np.testing.assert_allclose(res.m2_odo, ref.m2_odo, rtol=1e-9)
    i, j = gt.between.i.numpy(), gt.between.j.numpy()
    assert res.accepted[np.flatnonzero((i == 0) & (j == 19))[0]]
    assert not res.accepted[np.flatnonzero((i == 1) & (j == 18))[0]]


@pytest.mark.parametrize("seed", range(8))
def test_max_clique_matches(seed):
    """The port's early-stopping pivot scan picks the reference's pivot, so
    the clique is the reference's, on sparse to near-complete graphs."""
    r = np.random.default_rng(seed)
    n = int(r.integers(5, 60))
    adj = r.random((n, n)) < (0.3, 0.6, 0.9, 0.99)[seed % 4]
    adj = adj & adj.T
    np.fill_diagonal(adj, True)
    assert max_clique(adj) == jpcm.max_clique(adj)
    assert max_clique(np.zeros((0, 0), bool)) == []


# -- GNC -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def gnc_refs(corrupted):
    _, gj_bad, vj, _, gt_bad, _, _, _ = corrupted
    cand = (np.asarray(gj_bad.between.j) - np.asarray(gj_bad.between.i)) != 1
    return cand, {kind: jgnc.gnc_optimize(gj_bad, vj, candidates=cand,
                                          kind=kind)
                  for kind in ("tls", "gm")}


@pytest.mark.parametrize("kind", ["tls", "gm"])
def test_gnc_matches(corrupted, gnc_refs, kind):
    _, _, _, _, gt_bad, vt, bad, _ = corrupted
    cand, refs = gnc_refs
    ref = refs[kind]
    res = gnc_optimize(gt_bad, vt, candidates=torch.as_tensor(cand),
                       kind=kind)
    np.testing.assert_array_equal(res.inliers.numpy(),
                                  np.asarray(ref.inliers))
    np.testing.assert_allclose(res.weights.numpy(), np.asarray(ref.weights),
                               rtol=0, atol=1e-9)
    assert _rel(res.error, ref.error) <= 1e-9
    assert _rel(res.error_raw, ref.error_raw) <= 1e-9
    assert _rel(res.mu, ref.mu) <= 1e-12
    _close_values(res.values, ref.values)
    if kind == "tls":             # tests/test_gnc.py's gate
        assert not res.inliers.numpy()[bad].any()


def test_gnc_rejects_an_unknown_kind(corrupted):
    _, _, _, _, gt_bad, vt, _, _ = corrupted
    with pytest.raises(ValueError, match="cauchy"):
        gnc_optimize(gt_bad, vt, kind="cauchy")


# -- run_pose_graph's options --------------------------------------------------


def _pipeline_log(vro_cls):
    """``tests/test_pcm.py``'s pipeline log: a 40-node chain, two
    consistent loop closures and one wild one."""
    rng = np.random.default_rng(3)
    n = 40
    id_to, id_from = list(range(1, n)), list(range(0, n - 1))
    xi = np.zeros((n - 1, 6))
    xi[:, 3] = 0.1
    xi[:, :3] += 0.002 * rng.standard_normal((n - 1, 3))
    xi[:, 3:] += 0.002 * rng.standard_normal((n - 1, 3))
    for to, frm, fake in [(n - 1, 0, None), (n - 5, 2, None),
                          (n - 3, 1, rng.standard_normal(6) * 2.0)]:
        id_to.append(to)
        id_from.append(frm)
        row = np.zeros(6)
        if fake is None:
            row[3] = 0.1 * (to - frm)
        else:
            row = fake
        xi = np.vstack([xi, row[None]])
    info = np.tile(np.eye(6)[None] * 400.0, (len(id_to), 1, 1))
    return vro_cls(np.asarray(id_to), np.asarray(id_from), xi, info)


OPTIONS = {
    "pcm": dict(loop_gate="pcm"),
    "chordal": dict(init="chordal"),
    "gnc-tls": dict(robust="gnc-tls"),
    "gnc-gm": dict(robust="gnc-gm"),
    "pcm+chordal+gnc-tls": dict(loop_gate="pcm", init="chordal",
                                robust="gnc-tls"),
}


def _run(module, params_cls, vro_cls, name, **extra):
    kw = dict(OPTIONS[name])
    robust = kw.pop("robust", None)
    return module.run_pose_graph(_pipeline_log(vro_cls),
                                 params_cls(robust=robust), bucket=64, **kw,
                                 **extra)


@pytest.fixture(scope="module")
def pipeline_refs():
    return {name: _run(jpg, jconfig.SlamParams, JVROLog, name)
            for name in OPTIONS}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_run_pose_graph_options_match(pipeline_refs, name):
    import graph_slam_tpu_torch.pipelines.posegraph as pg

    ref = pipeline_refs[name]
    res = _run(pg, config.SlamParams, VROLog, name, device="cpu")
    assert _rel(res.error0, ref.error0) <= 1e-12
    assert _rel(res.error, ref.error) <= 1e-9
    assert res.iterations == ref.iterations
    _, t, q, seq = trajectory_arrays(res.values, res.seq_ids)
    _, tj, qj, seq_j = jpg.trajectory_arrays(ref.values, ref.seq_ids)
    np.testing.assert_allclose(t, tj, atol=1e-9)
    np.testing.assert_allclose(q, qj, atol=1e-9)
    np.testing.assert_array_equal(seq, seq_j)
    np.testing.assert_array_equal(res.graph.between.active.numpy(),
                                  np.asarray(ref.graph.between.active))


def test_pcm_gate_beats_the_plain_solve():
    """``tests/test_pcm.py``'s pipeline gate on the port."""
    log = _pipeline_log(VROLog)
    gated = run_pose_graph(log, loop_gate="pcm", device="cpu")
    plain = run_pose_graph(log, device="cpu")
    assert gated.error < 0.05 * plain.error


@pytest.mark.parametrize("kw", [{"loop_gate": "nope"}, {"init": "nope"},
                                {"backend": "nope"}])
def test_run_pose_graph_unknown_options_raise(kw):
    with pytest.raises(ValueError, match="nope"):
        run_pose_graph(_pipeline_log(VROLog), device="cpu", **kw)
