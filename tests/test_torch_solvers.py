"""Parity of the port's solver inventory with the JAX package, on the CPU in
float64: dense assembly and the matrix-free products, the incidence gather
path, ``gn_optimize``'s ``update_mask``/``return_history``, the banded GN
and superblock direct solvers, fleet GN against per-graph solves, and pose
marginalization with its Chow-Liu tree.

Shapes are the JAX tests' own (``tests/test_banded.py``'s 60- and 37-pose
spheres at bucket 4, ``test_sparsity.py``'s 24- and 40-pose spheres,
``test_batch.py``'s fleet of 40-pose spheres, ``test_sparsify.py``'s
40-pose sphere). One reference run per scenario is shared through
module-scoped fixtures.

Tolerances: index tables and masks bit-equal; assembly and products 1e-10
(relative to entries of up to 1e12 from the 1e-6-sigma anchor, so rtol
1e-10 with atol 1e-10); GN iterates and chi2 1e-9 (Cholesky or CG solves
of systems with condition ~1e12 amplify rounding); the fleet against its
own per-graph solves bit-equal in the port and 1e-9 against the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_slam_tpu.datasets import make_sphere_graph as j_make_sphere
from graph_slam_tpu.graph import assemble as jassemble
from graph_slam_tpu.graph import banded as jbanded
from graph_slam_tpu.graph import batch as jbatch
from graph_slam_tpu.graph import lm as jlm
from graph_slam_tpu.graph import sparsify as jsparsify
from graph_slam_tpu.graph import sparsity as jsparsity
from graph_slam_tpu.graph.factors import linearize_blocks as j_linearize
from graph_slam_tpu.graph.factors import total_error as j_total_error
from graph_slam_tpu.graph.variables import used_slot_mask as j_used_mask
from graph_slam_tpu_torch.convert import (arena_from_numpy, graph_from_numpy,
                                          to_numpy)
from graph_slam_tpu_torch.graph import (LMParams, ProjectionTable,
                                        assemble_dense,
                                        band_halfwidth, empty_table,
                                        banded_direct_gn_optimize,
                                        banded_gn_optimize, build_incidence,
                                        chow_liu_tree, diag_precond,
                                        gn_optimize, gn_optimize_many,
                                        gradient, hvp_fn, linearize_blocks,
                                        lm_optimize,
                                        marginalize_poses, solve_many,
                                        stack_pytrees, total_error,
                                        unstack_pytree, used_slot_mask)
from graph_slam_tpu_torch.graph.sparsity import (diag_gather, gather_sum,
                                                 gradient_gather,
                                                 hvp_fn_gather)

torch.set_num_threads(1)


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _port(graph, values):
    return (graph_from_numpy(_np_tree(graph), device="cpu"),
            arena_from_numpy(_np_tree(values), device="cpu"))


def _sphere(n, edges, seed, bucket, **kw):
    gj, vj, _ = j_make_sphere(n_poses=n, edges_per_pose=edges, seed=seed,
                              dtype=jnp.float64, bucket=bucket, **kw)
    return (gj, vj) + _port(gj, vj)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _close_values(vt, vj, atol=1e-9):
    np.testing.assert_allclose(vt.pose_t.numpy(), np.asarray(vj.pose_t),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(vt.pose_R.numpy(), np.asarray(vj.pose_R),
                               rtol=0, atol=atol)


# -- assembly and the gather path ----------------------------------------------


@pytest.fixture(scope="module")
def sphere24():
    return _sphere(24, 3.0, 0, 8)


def test_assemble_dense_and_gradient_match(sphere24):
    gj, vj, gt, vt = sphere24
    H, g = assemble_dense(gt, vt)
    Hj, gj_ = jax.jit(jassemble.assemble_dense)(gj, vj)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj_), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(gradient(gt, vt).numpy(),
                               np.asarray(jax.jit(jassemble.gradient)(gj, vj)),
                               rtol=1e-10, atol=1e-10)


@pytest.fixture(scope="module")
def products(sphere24):
    """The reference's matrix-free products at lam = 0.3 on one vector."""
    gj, vj, _, _ = sphere24
    v = np.random.default_rng(1).normal(size=j_used_mask(vj).shape[0])

    @jax.jit
    def ref(graph, values, v):
        blocks = j_linearize(graph, values)
        mask = j_used_mask(values)
        return (jassemble.hvp_fn(blocks, mask, 0.3)(v),
                jassemble.diag_precond(blocks, mask, 0.3))

    inc_j = jsparsity.build_incidence(gj, vj)

    @jax.jit
    def ref_gather(graph, values, v, idx):
        blocks = j_linearize(graph, values)
        mask = j_used_mask(values)
        inc = jsparsity.Incidence(idx, inc_j.n_flat)
        return (jsparsity.hvp_fn_gather(blocks, inc, mask, 0.3)(v),
                jsparsity.diag_gather(blocks, inc, mask, 0.3),
                jsparsity.gradient_gather(blocks, inc, mask.dtype))

    return v, inc_j, ref(gj, vj, jnp.asarray(v)), ref_gather(
        gj, vj, jnp.asarray(v), inc_j.idx)


def test_hvp_and_diag_precond_match(sphere24, products):
    _, _, gt, vt = sphere24
    v, _, (hv_j, d_j), _ = products
    blocks = linearize_blocks(gt, vt)
    mask = used_slot_mask(vt)
    np.testing.assert_allclose(hvp_fn(blocks, mask, 0.3)(
        torch.as_tensor(v)).numpy(), np.asarray(hv_j), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(diag_precond(blocks, mask, 0.3).numpy(),
                               np.asarray(d_j), rtol=1e-10, atol=1e-10)


def test_build_incidence_matches(sphere24, products):
    _, _, gt, vt = sphere24
    _, inc_j, _, _ = products
    inc = build_incidence(gt, vt)
    assert inc.n_flat == inc_j.n_flat and inc.dim == inc_j.dim
    np.testing.assert_array_equal(inc.idx.numpy(), np.asarray(inc_j.idx))
    padded = build_incidence(gt, vt, pad_to_multiple=8)
    assert padded.idx.shape[1] % 8 == 0
    np.testing.assert_array_equal(
        padded.idx.numpy()[:, :inc.idx.shape[1]], inc.idx.numpy())


def test_gather_products_match(sphere24, products):
    """The gather path against the reference's, and against the port's
    scatter path."""
    _, _, gt, vt = sphere24
    v, _, (hv_j, d_j), (hv_g, d_g, g_g) = products
    blocks = linearize_blocks(gt, vt)
    mask = used_slot_mask(vt)
    inc = build_incidence(gt, vt)
    vt_ = torch.as_tensor(v)
    hv = hvp_fn_gather(blocks, inc, mask, 0.3)(vt_)
    np.testing.assert_allclose(hv.numpy(), np.asarray(hv_g), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(hv.numpy(),
                               hvp_fn(blocks, mask, 0.3)(vt_).numpy(),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(diag_gather(blocks, inc, mask, 0.3).numpy(),
                               np.asarray(d_g), rtol=1e-10, atol=1e-10)
    g = gradient_gather(blocks, inc, torch.float64)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_g), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(g.numpy(), gradient(gt, vt).numpy(),
                               rtol=1e-10, atol=1e-10)
    flat = torch.arange(inc.n_flat, dtype=torch.float64)
    np.testing.assert_array_equal(
        gather_sum(inc, flat).numpy(),
        np.asarray(jsparsity.gather_sum(jsparsity.Incidence(
            jnp.asarray(inc.idx.numpy()), inc.n_flat), jnp.asarray(
                flat.numpy()))))


def test_build_incidence_refuses_unported_tables(sphere24):
    """``build_incidence`` raised on a projection table until bundle
    adjustment was ported; now an active projection row's pose and point
    columns each gain one gather entry, and an inactive row none
    (tests/test_torch_ba.py holds a BA graph's table to the reference)."""
    _, _, gt, vt = sphere24
    vt = vt._replace(point=torch.zeros(1, 3, dtype=torch.float64))
    base = build_incidence(gt, vt)
    proj = empty_table(ProjectionTable, 2, device="cpu")
    proj = proj._replace(pose_idx=torch.tensor([3, 5]),
                         active=torch.tensor([True, False]))
    inc = build_incidence(gt._replace(projection=proj), vt)
    D = base.idx.shape[0]           # the last 3 columns: the point
    assert inc.idx.shape[0] == D and inc.n_flat == base.n_flat + 18

    def live(inc):
        return (inc.idx < inc.n_flat).sum(dim=1)

    gained = live(inc) - live(base)
    assert gained[18:24].tolist() == [1] * 6
    assert gained[D - 3:].tolist() == [1, 1, 1] and int(gained.sum()) == 9


@pytest.fixture(scope="module")
def sphere40():
    return _sphere(40, 3.0, 2, 8)


@pytest.fixture(scope="module")
def gn_refs(sphere40):
    """The reference's GN runs on the 40-pose sphere: the gather PCG path
    (``test_sparsity.py``'s configuration), ``return_history``, and
    ``update_mask`` freezing every third pose."""
    gj, vj, _, _ = sphere40
    inc = jsparsity.build_incidence(gj, vj)
    um = np.ones(j_used_mask(vj).shape[0])
    um[np.arange(0, 40, 3)[:, None] * 6 + np.arange(6)] = 0.0
    return um, {
        "gather": jlm.gn_optimize(gj, vj, iterations=5, solver="pcg",
                                  pcg_iters=400, damping=1e-9, inc=inc),
        "history": jlm.gn_optimize(gj, vj, iterations=4, damping=1e-9,
                                   return_history=True),
        "update_mask": jlm.gn_optimize(gj, vj, iterations=4, damping=1e-9,
                                       update_mask=jnp.asarray(um),
                                       return_history=True),
    }


@pytest.mark.parametrize("case", ["gather", "history", "update_mask"])
def test_gn_optimize_options_match(sphere40, gn_refs, case):
    _, _, gt, vt = sphere40
    um, refs = gn_refs
    ref = refs[case]
    if case == "gather":
        res = gn_optimize(gt, vt, iterations=5, solver="pcg", pcg_iters=400,
                          damping=1e-9, inc=build_incidence(gt, vt))
        assert res.history is None
    else:
        kw = {"update_mask": torch.as_tensor(um)} \
            if case == "update_mask" else {}
        res = gn_optimize(gt, vt, iterations=4, damping=1e-9,
                          return_history=True, **kw)
        np.testing.assert_allclose(res.history.numpy(),
                                   np.asarray(ref.history), rtol=1e-9)
        assert float(res.error) == float(res.history[-1])
    assert _rel(res.error, ref.error) <= 1e-9
    _close_values(res.values, ref.values)
    if case == "update_mask":     # frozen poses did not move
        frozen = np.arange(0, 40, 3)
        np.testing.assert_array_equal(res.values.pose_t.numpy()[frozen],
                                      vt.pose_t.numpy()[frozen])


@pytest.fixture(scope="module")
def lm_gather_ref(sphere40):
    """The reference's LM over the gather PCG on the 40-pose sphere."""
    gj, vj, _, _ = sphere40
    return jlm.lm_optimize(gj, vj, jlm.LMParams(solver="pcg"),
                           inc=jsparsity.build_incidence(gj, vj))


def test_lm_optimize_gather_pcg_matches(sphere40, lm_gather_ref):
    """``lm_optimize(inc=)``: every trial solves with the gather PCG, as
    the reference's ``lm_optimize`` does with an ``Incidence``."""
    _, _, gt, vt = sphere40
    ref = lm_gather_ref
    res = lm_optimize(gt, vt, LMParams(solver="pcg"),
                      inc=build_incidence(gt, vt))
    assert res.iterations == int(ref.iterations)
    assert _rel(res.error, ref.error) <= 1e-9
    _close_values(res.values, ref.values)


def test_gather_pcg_matches_the_scatter_pcg(sphere40):
    """The gather path (Jacobi preconditioner) and the scatter path (3x3
    block-Jacobi) reach the same GN iterates with 400 CG trips, as
    ``test_sparsity.py`` holds the gather path to the dense solve."""
    _, _, gt, vt = sphere40
    kw = dict(iterations=5, solver="pcg", pcg_iters=400, damping=1e-9)
    a = gn_optimize(gt, vt, inc=build_incidence(gt, vt), **kw)
    b = gn_optimize(gt, vt, **kw)
    assert _rel(a.error, b.error) <= 1e-6
    np.testing.assert_allclose(a.values.pose_t.numpy(),
                               b.values.pose_t.numpy(), atol=1e-5)


# -- banded solvers ------------------------------------------------------------


@pytest.fixture(scope="module")
def banded_refs():
    """``tests/test_banded.py``'s spheres and the reference's banded runs."""
    s60 = _sphere(60, 3.0, 0, 4)
    s37 = _sphere(37, 2.5, 3, 4)
    W60 = jbanded.band_halfwidth(s60[0])
    W37 = jbanded.band_halfwidth(s37[0])
    return {
        "pcg": (s60, W60, dict(iterations=6, band_w=W60, damping=1e-6,
                               pcg_iters=150),
                jbanded.banded_gn_optimize(s60[0], s60[1], iterations=6,
                                           band_w=W60, damping=1e-6,
                                           pcg_iters=150)),
        "direct": (s60, W60, dict(iterations=6, band_w=W60, damping=1e-6),
                   jbanded.banded_direct_gn_optimize(
                       s60[0], s60[1], iterations=6, band_w=W60,
                       damping=1e-6)),
        "direct_padded": (s37, W37, dict(iterations=5, band_w=W37,
                                         super_s=W37 + 3, damping=1e-6),
                          jbanded.banded_direct_gn_optimize(
                              s37[0], s37[1], iterations=5, band_w=W37,
                              super_s=W37 + 3, damping=1e-6)),
    }


@pytest.mark.parametrize("case", ["pcg", "direct", "direct_padded"])
def test_banded_solvers_match(banded_refs, case):
    (gj, vj, gt, vt), W, kw, (vals_j, err_j) = banded_refs[case]
    assert band_halfwidth(gt) == W
    fn = banded_gn_optimize if case == "pcg" else banded_direct_gn_optimize
    vals, err = fn(gt, vt, **kw)
    assert _rel(err, err_j) <= 1e-9
    _close_values(vals, vals_j)
    # the reference's own gate: the same iterates as dense GN
    dense = gn_optimize(gt, vt, iterations=kw["iterations"], damping=1e-6)
    assert _rel(err, dense.error) <= 1e-9


def test_banded_wider_band_is_harmless(banded_refs):
    (_, _, gt, vt), W, kw, _ = banded_refs["pcg"]
    _, e1 = banded_gn_optimize(gt, vt, **kw)
    _, e2 = banded_gn_optimize(gt, vt, **dict(kw, band_w=W + 7))
    assert abs(float(e1) - float(e2)) <= 1e-9 * float(e1)


@pytest.mark.parametrize("case", ["small_superblock", "narrow_band",
                                  "non_pose"])
def test_banded_solvers_refuse(banded_refs, case):
    (_, _, gt, vt), W, _, _ = banded_refs["pcg"]
    if case == "small_superblock":
        with pytest.raises(ValueError, match="super_s"):
            banded_direct_gn_optimize(gt, vt, iterations=1, band_w=W,
                                      super_s=W - 1)
    elif case == "narrow_band":
        with pytest.raises(ValueError, match="span"):
            banded_gn_optimize(gt, vt, iterations=1, band_w=W - 1)
    else:
        from graph_slam_tpu_torch.graph import empty_table
        from graph_slam_tpu_torch.graph.factors import PriorVec3Table

        pv = empty_table(PriorVec3Table, 1, device="cpu")
        with pytest.raises(NotImplementedError, match="pose-only"):
            banded_gn_optimize(gt._replace(prior_vel=pv), vt._replace(
                vel=torch.zeros(1, 3, dtype=torch.float64)), iterations=1,
                band_w=W)


# -- the fleet -----------------------------------------------------------------


FLEET = 4


@pytest.fixture(scope="module")
def fleet():
    """``tests/test_batch.py``'s fleet in float64: four 40-pose spheres of
    different seeds, and the reference's batched PCG run."""
    pairs_j = [j_make_sphere(n_poses=40, edges_per_pose=3.0, seed=s,
                             dtype=jnp.float64, bucket=16)[:2]
               for s in range(FLEET)]
    pairs_t = [_port(g, v) for g, v in pairs_j]
    ref = jbatch.gn_optimize_many(
        jbatch.stack_pytrees([g for g, _ in pairs_j]),
        jbatch.stack_pytrees([v for _, v in pairs_j]), iterations=8,
        solver="pcg", damping=1e-3, pcg_iters=50)
    return pairs_t, ref


def test_gn_optimize_many_matches(fleet):
    pairs, ref = fleet
    graphs = stack_pytrees([g for g, _ in pairs])
    arenas = stack_pytrees([v for _, v in pairs])
    res = gn_optimize_many(graphs, arenas, iterations=8, solver="pcg",
                           damping=1e-3, pcg_iters=50)
    assert res.error.shape == (FLEET,)
    np.testing.assert_allclose(res.error.numpy(), np.asarray(ref.error),
                               rtol=1e-9)
    np.testing.assert_allclose(res.values.pose_t.numpy(),
                               np.asarray(ref.values.pose_t), atol=1e-9)
    for k, (g, v) in enumerate(pairs):
        # each graph takes the steps of its own gn_optimize: per-graph CG
        single = gn_optimize(g, v, iterations=8, solver="pcg", damping=1e-3,
                             pcg_iters=50)
        np.testing.assert_array_equal(res.values.pose_t[k].numpy(),
                                      single.values.pose_t.numpy())
        assert float(res.error[k]) == float(single.error)


def test_solve_many_dense(fleet):
    pairs, _ = fleet
    out = solve_many(pairs, iterations=6, solver="dense", damping=1e-6)
    assert len(out) == FLEET
    for (g, v), res in zip(pairs, out):
        assert float(res.error) < 0.1 * float(total_error(g, v))
        assert res.values.pose_t.ndim == 2
        single = gn_optimize(g, v, iterations=6, damping=1e-6)
        assert _rel(res.error, single.error) <= 1e-12


def test_stack_unstack_round_trip(fleet):
    pairs, _ = fleet
    back = unstack_pytree(stack_pytrees([v for _, v in pairs]), FLEET)
    for (_, v), b in zip(pairs, back):
        for x, y in zip(v, b):
            np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_solve_many_rejects_mismatched_shapes():
    from graph_slam_tpu_torch.datasets import make_sphere_graph

    g1, v1, _ = make_sphere_graph(20, 3.0, seed=0, bucket=16, device="cpu")
    g2, v2, _ = make_sphere_graph(44, 3.0, seed=1, bucket=16, device="cpu")
    with pytest.raises(ValueError, match="identical bucket"):
        solve_many([(g1, v1), (g2, v2)])


# -- pose marginalization ------------------------------------------------------


@pytest.fixture(scope="module")
def marginalized():
    """``tests/test_sparsify.py``'s chi2 case: a 40-pose sphere optimized
    by 30 dense GN steps, every third pose from 1 marginalized."""
    gj, vj, gt, vt = _sphere(40, 3.0, 1, 64, meas_noise=0.01,
                             init_noise=0.02)
    full = jlm.gn_optimize(gj, vj, iterations=30)
    drop = np.arange(1, 40, 3)
    ref = jsparsify.marginalize_poses(gj, full.values, drop, bucket=32)
    return gt, full.values, drop, ref


def test_marginalize_poses_matches(marginalized):
    gt, full_j, drop, (g2_j, v2_j, old2new_j) = marginalized
    full = arena_from_numpy(_np_tree(full_j), device="cpu")
    g2, v2, old2new = marginalize_poses(gt, full, drop, bucket=32)
    assert old2new == old2new_j
    g2_np = _np_tree(g2_j)
    for name in ("prior_pose", "between"):
        for field in getattr(g2, name)._fields:
            np.testing.assert_allclose(
                to_numpy(getattr(getattr(g2, name), field)),
                getattr(getattr(g2_np, name), field), rtol=1e-9, atol=1e-9,
                err_msg=f"{name}.{field}")
    for field in v2._fields:
        np.testing.assert_array_equal(to_numpy(getattr(v2, field)),
                                      np.asarray(getattr(v2_j, field)))
    e_lin = float(total_error(g2, v2))
    assert _rel(e_lin, jax.jit(j_total_error)(g2_j, v2_j)) <= 1e-9
    # test_sparsify.py's gate: the rebuilt graph starts near its optimum
    assert float(gn_optimize(g2, v2, iterations=20).error) <= e_lin + 1e-9


def test_marginalize_poses_refuses(marginalized):
    gt, full_j, _, _ = marginalized
    full = arena_from_numpy(_np_tree(full_j), device="cpu")
    with pytest.raises(ValueError, match="prior"):
        marginalize_poses(gt, full, [0])
    with pytest.raises(ValueError, match="out of range"):
        marginalize_poses(gt, full, [40])


def test_chow_liu_tree_matches():
    A = np.random.default_rng(0).normal(size=(24, 24))
    cov = A @ A.T + 24 * np.eye(24)
    assert chow_liu_tree(cov, 4) == jsparsify.chow_liu_tree(cov, 4)
    assert chow_liu_tree(cov, 4, root=2) == jsparsify.chow_liu_tree(
        cov, 4, root=2)
    assert chow_liu_tree(np.eye(6), 1) == []
