"""The port's multi-device solving (``graph_slam_tpu_torch.parallel``,
``graph.sharded_gn_many``) against the JAX package, on the CPU in float64.

The JAX package runs ``shard_map`` over ``make_mesh(4)`` of the suite's 8
virtual CPU devices; the port runs the same inputs on 4 gloo ranks, one
process each, through ``parallel.launch(4, ..., device="cpu")``. One
module-scoped launch runs every port scenario once (``run_calls``), at the
shapes ``tests/test_sharding.py`` and ``tests/test_batch.py`` compile: the
48-pose sphere (dense GN and PCG-60), the 8 x 120 BA graph (PCG-50 and the
landmark-sharded square-root Schur), the same BA graph with 121 landmarks
(a count 4 does not divide), ``__graft_entry__.py``'s 12-frame VIO window
(PCG-60) and ``test_batch.py``'s fleet of four 40-pose spheres.

Tolerances: values and chi2 within 1e-9 (chi2 relative) of the JAX
package's sharded run and of the port's own single-process solver, but
PCG-50 on the BA graph (values 1e-6, chi2 1e-7); the ranks' results
bit-equal to rank 0's; padded tables leaf-equal. Gaps measured when this
file was written (values; chi2 relative), against JAX's sharded run and
against the port on one process: dense GN 6.2e-15, 3.6e-15 (chi2 9.7e-16,
9.5e-15); sphere PCG-60 5.3e-15, 4.9e-15 (1.9e-14, 4.5e-15); square-root
BA 2.7e-15, 2.7e-15 and, with 121 landmarks, 3.1e-15, 2.3e-15; VIO PCG-60
3.9e-12, 1.9e-12 (3.3e-12, 1.3e-12); BA PCG-50 2.8e-7, 4.6e-7 (2.1e-8,
4.9e-8). CG amplifies the order of the sums on that unconverged BA
system: the JAX package's own sharded and single-device runs differ by
6.6e-7 there, the port's single-device run from JAX's by 6.8e-7.
"""

import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_slam_tpu.parallel as jpar
from graph_slam_tpu.datasets import make_ba_graph as j_make_ba
from graph_slam_tpu.datasets import make_sphere_graph as j_make_sphere
from graph_slam_tpu.graph import batch as jbatch
from graph_slam_tpu.graph.factors import total_error as j_total_error
from graph_slam_tpu_torch.convert import arena_from_numpy, graph_from_numpy
from graph_slam_tpu_torch.graph import (gn_optimize, sharded_gn_many,
                                        stack_pytrees, total_error)
from graph_slam_tpu_torch.graph.ba_solve import ba_gn_optimize_sqrt
from graph_slam_tpu_torch.parallel import (launch, make_mesh,
                                           pad_graph_for_mesh,
                                           sharded_ba_sqrt, sharded_gn)
from graph_slam_tpu_torch.parallel.dryrun import _vio_window
from graph_slam_tpu_torch.parallel.launch import run_calls

torch.set_num_threads(1)

N = 4
TOL = 1e-9


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _port(graph, values):
    return (graph_from_numpy(_np_tree(graph), device="cpu"),
            arena_from_numpy(_np_tree(values), device="cpu"))


def _j_vio_window(n_frames=12, bucket=8):
    """``__graft_entry__.py:169-216``'s VIO window, built by the JAX
    package."""
    from graph_slam_tpu.graph import GraphBuilder
    from graph_slam_tpu.imu import init_preint, integrate_segment, \
        vn100_params

    rng = np.random.default_rng(7)
    params = vn100_params()
    dt = 1.0 / 200.0
    per = 20
    acc = (rng.normal(size=(n_frames * per, 3)) * 0.2
           - np.asarray(params.gravity))
    gyr = rng.normal(size=(n_frames * per, 3)) * 0.2
    b = GraphBuilder()
    for f in range(n_frames):
        b.add_pose((np.eye(3), np.zeros(3) + 0.01 * f))
        b.add_vel(np.zeros(3))
        b.add_bias(np.zeros(6))
    b.add_prior_pose(0, (np.eye(3), np.zeros(3)), sigmas=np.full(6, 1e-6))
    b.add_prior_vel(0, np.zeros(3), sigma=1e-3)
    b.add_prior_bias(0, np.zeros(6), sigma=1e-3)
    for f in range(1, n_frames):
        st = integrate_segment(
            init_preint(jnp.zeros(6), params),
            jnp.asarray(acc[(f - 1) * per:f * per]),
            jnp.asarray(gyr[(f - 1) * per:f * per]),
            jnp.full(per, dt), params)
        b.add_imu_factor(f - 1, f, st, np.asarray(params.gravity))
        b.add_between(f - 1, f,
                      (np.eye(3), np.zeros(3) + rng.normal(size=3) * 1e-3),
                      sigmas=np.full(6, 1e-2))
    planes_body = [np.array([0.0, 0.0, 1.0, -2.0]),
                   np.array([0.0, 1.0, 0.0, -1.5]),
                   np.array([1.0, 0.0, 0.0, -3.0])]
    for lp in planes_body:
        b.add_plane(lp)
    for f in range(n_frames):
        for li, lp in enumerate(planes_body):
            b.add_plane_factor(f, li, lp + rng.normal(size=4) * 1e-3,
                               sqrt_info=np.diag([1e2, 1e2, 1e2]))
    return b.build(bucket=bucket)


def _fleet_j():
    return [j_make_sphere(n_poses=40, edges_per_pose=3.0, seed=s,
                          dtype=jnp.float64, bucket=16)[:2]
            for s in range(N)]


def _stacked(pairs):
    return stack_pytrees([g for g, _ in pairs]), \
        stack_pytrees([v for _, v in pairs])


@pytest.fixture(scope="module")
def problems():
    """name -> (JAX graph, JAX values): every scenario's inputs."""
    sphere = j_make_sphere(n_poses=48, edges_per_pose=3.0, seed=0,
                           dtype=jnp.float64, bucket=16)[:2]
    ba = j_make_ba(n_poses=8, n_points=120, obs_per_point=3, seed=4,
                   dtype=jnp.float64, bucket=8)[:2]
    ba121 = j_make_ba(n_poses=8, n_points=121, obs_per_point=3, seed=4,
                      dtype=jnp.float64, bucket=1)[:2]
    return {"sphere": sphere, "ba": ba, "ba121": ba121,
            "vio": _j_vio_window()}


# (name, problem, port function, keyword arguments, (values, chi2)
# tolerances) of each sharded run
CASES = [
    ("dense", "sphere", sharded_gn,
     dict(iterations=6, damping=1e-4, solver="dense"), (TOL, TOL)),
    ("pcg", "sphere", sharded_gn,
     dict(iterations=6, damping=1e-4, solver="pcg", pcg_iters=60),
     (TOL, TOL)),
    ("ba_pcg", "ba", sharded_gn,
     dict(iterations=6, damping=1e-2, solver="pcg", pcg_iters=50),
     (1e-6, 1e-7)),
    ("ba_sqrt", "ba", sharded_ba_sqrt,
     dict(iterations=6, damping=1e-3, chunk=16), (TOL, TOL)),
    ("ba_sqrt_121", "ba121", sharded_ba_sqrt,
     dict(iterations=6, damping=1e-3, chunk=16), (TOL, TOL)),
    ("vio", "vio", sharded_gn,
     dict(iterations=8, damping=1e-4, solver="pcg", pcg_iters=60),
     (TOL, TOL)),
]


_RANK_LAUNCHES = []     # the region-grow launches the fixture's ranks sent


@pytest.fixture(scope="module")
def ranks(problems):
    """Every rank's results of one 4-rank gloo launch: one entry a CASES
    row, then the fleet's ``LMResult``."""
    calls = [(fn, _port(*problems[prob]), kw) for _, prob, fn, kw, _ in CASES]
    calls.append((sharded_gn_many, _stacked([_port(*p) for p in _fleet_j()]),
                  dict(iterations=8, solver="pcg", damping=1e-3,
                       pcg_iters=50)))
    before = launch.region_grow_launches
    out = launch(N, run_calls, calls, device="cpu", timeout=300)
    _RANK_LAUNCHES.append(launch.region_grow_launches - before)
    return out


def _jax_run(fn, graph, values, kw):
    mesh = jpar.make_mesh(N)
    if fn is sharded_ba_sqrt:
        return jpar.sharded_ba_sqrt(mesh, graph, values, **kw)
    return jpar.sharded_gn(mesh, graph, values, **kw)


def _port_single(fn, graph, values, kw):
    """The port's own single-process solver of the same problem."""
    if fn is sharded_ba_sqrt:
        return ba_gn_optimize_sqrt(graph, values, **kw)
    res = gn_optimize(graph, values, **kw)
    return res.values, res.error


def _close(vals, err, want_vals, want_err, tol=(TOL, TOL)):
    for name in ("pose_R", "pose_t", "vel", "bias", "plane", "point"):
        np.testing.assert_allclose(np.asarray(getattr(vals, name)),
                                   np.asarray(getattr(want_vals, name)),
                                   rtol=0, atol=tol[0], err_msg=name)
    assert abs(float(err) - float(want_err)) <= tol[1] * abs(float(want_err))


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_sharded_solve_matches_jax(case, problems, ranks):
    _, prob, fn, kw, tol = CASES[case]
    vals, err = ranks[0][case]
    jv, je = _jax_run(fn, *problems[prob], kw)
    _close(vals, err, jv, je, tol)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_sharded_solve_matches_the_port_on_one_process(case, problems,
                                                       ranks):
    _, prob, fn, kw, tol = CASES[case]
    vals, err = ranks[0][case]
    g, v = _port(*problems[prob])
    e0 = float(total_error(g, v))
    sv, se = _port_single(fn, g, v, kw)
    _close(vals, err, sv, se, tol)
    assert float(err) < 0.5 * e0


def test_every_rank_returns_rank_0s_result(ranks):
    def leaves(x):
        if isinstance(x, (tuple, list)):
            return [y for v in x for y in leaves(v)]
        return [np.asarray(x)]

    first = leaves(ranks[0])
    for other in ranks[1:]:
        for a, b in zip(first, leaves(other), strict=True):
            np.testing.assert_array_equal(a, b)


def test_sharded_fleet_matches_jax(ranks):
    pairs_j = _fleet_j()
    res = ranks[0][len(CASES)]
    ref = jbatch.sharded_gn_many(
        jpar.make_mesh(N), jbatch.stack_pytrees([g for g, _ in pairs_j]),
        jbatch.stack_pytrees([v for _, v in pairs_j]), iterations=8,
        solver="pcg", damping=1e-3, pcg_iters=50)
    assert res.error.shape == (N,) and res.values.pose_t.shape[0] == N
    np.testing.assert_allclose(res.error, np.asarray(ref.error), rtol=TOL)
    np.testing.assert_allclose(res.values.pose_t,
                               np.asarray(ref.values.pose_t), atol=TOL)
    np.testing.assert_array_equal(res.values.num_poses,
                                  np.asarray(ref.values.num_poses))


def test_the_ranks_send_back_their_kernel_launches(ranks):
    """Each rank's ``region_grow.launches`` comes back and ``launch`` adds
    them up; the sharded solvers launch no kernel, and on the CPU the
    wrapper takes its plain version, so the ranks' sum is 0. The results
    come back without the counts."""
    assert _RANK_LAUNCHES == [0]
    assert len(ranks) == N and len(ranks[0]) == len(CASES) + 1


def test_indivisible_batch_raises_from_a_rank():
    """A rank's exception comes back as itself, with the rank's
    traceback as its cause; no rank is left running."""
    pairs = [_port(*p) for p in _fleet_j()]
    with pytest.raises(ValueError, match="divisible") as info:
        launch(3, sharded_gn_many, *_stacked(pairs), device="cpu",
               timeout=120)
    assert "rank" in str(info.value.__cause__)
    assert "sharded_gn_many" in str(info.value.__cause__)
    assert not multiprocessing.active_children()


def test_a_rank_past_its_timeout_is_killed():
    g, v = _port(*j_make_sphere(n_poses=48, edges_per_pose=3.0, seed=0,
                                dtype=jnp.float64, bucket=16)[:2])
    with pytest.raises(TimeoutError, match="did not finish within"):
        launch(2, sharded_gn, g, v, iterations=10 ** 6, device="cpu",
               timeout=2.0)
    assert not multiprocessing.active_children()


def test_launch_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="module-level function"):
        launch(2, len, device="cpu")
    with pytest.raises(ValueError, match="gloo"):
        launch(2, sharded_gn, device="cpu", backend="nccl")
    with pytest.raises(RuntimeError, match="not in a torch.distributed"):
        make_mesh(4)


@pytest.mark.parametrize("n", [8, 3])
def test_pad_graph_for_mesh_matches_jax(n):
    """``test_sharding.py``'s divisibility case, leaf-equal to the JAX
    package's padding, the error kept."""
    gj, vj, _ = j_make_sphere(n_poses=10, edges_per_pose=2.0, seed=1,
                              dtype=jnp.float64, bucket=16)
    g, v = _port(gj, vj)
    padded = pad_graph_for_mesh(g, n)
    want = jpar.pad_graph_for_mesh(gj, n)
    for tab, wtab in zip(padded, want, strict=True):
        assert tab.active.shape[0] % n == 0
        for x, w in zip(tab, wtab, strict=True):
            np.testing.assert_array_equal(x.numpy(), np.asarray(w))
    e1, e2 = float(total_error(g, v)), float(total_error(padded, v))
    assert abs(e1 - e2) <= 1e-12 * max(e1, 1.0)
    assert abs(e2 - float(j_total_error(want, vj))) <= 1e-12 * e2


def test_dry_run_vio_window_is_the_reference_graph():
    """The dry run's VIO window, built by the port, against the JAX
    package's construction (float64 preintegration on both sides)."""
    gj, vj = _j_vio_window()
    g, v = _vio_window(12, "cpu").build(bucket=8, device="cpu")
    for tab, wtab in zip(g, gj, strict=True):
        for x, w in zip(tab, wtab, strict=True):
            np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=1e-9,
                                       atol=1e-9)
    for x, w in zip(v, vj, strict=True):
        np.testing.assert_array_equal(x.numpy(), np.asarray(w))
