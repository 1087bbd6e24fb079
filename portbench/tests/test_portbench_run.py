"""Whole runs of the harness at a CPU test's size: the result line, the
check against the reference, the control and the planted faults, the
refusals."""

import dataclasses
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import calibrate, harness
from portbench.tests import tiny

CELLS = ["tiny-sphere-lm-dense", "tiny-ba-sqrt"]
REPO = str(tiny.REPO)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("bench"))


def run(root, cell, trace=0, seed=2 ** 31 + 11):
    res = harness.run(tiny.args(cell, seed=seed, trace=trace), root=root,
                         device="cpu", require_card=False)
    return res


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(root, cell, trace):
    res = run(root, cell, trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        b = res["breakdown"]
        assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
        assert not {"ba_solve_ms", "g2o_solve_ms", "setup_s"} & set(
            res["metrics"])
    else:
        assert len(res["metrics"]) == 2 and "setup_s" in res["metrics"]
        assert all(m["value"] > 0 for m in res["metrics"].values())
    out, err = io.StringIO(), io.StringIO()
    harness.emit(res, out, err)
    assert json.loads(out.getvalue().splitlines()[-1]) == res
    lines = err.getvalue().splitlines()
    assert len(lines) == len(res["checks"])
    assert all(s.startswith("check ") for s in lines)


def test_forbidden_modules_by_whole_top_level_name():
    mods = {"graph_slam_tpu_torch": 1, "graph_slam_tpu_torch.graph": 1,
            "jaxtyping": 1, "flaxen": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    for bad in ("jax", "jax.numpy", "jaxlib.xla", "flax.linen",
                "graph_slam_tpu", "graph_slam_tpu.core.se3"):
        assert harness.forbidden_modules({**mods, bad: 1}) == [
            bad.split(".")[0]]


def test_a_forbidden_module_refuses_the_result(root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["json"])
    with pytest.raises(harness.Refused, match="jax"):
        run(root, "tiny-sphere-lm-dense")


def fault_step_unchanged(mp):
    from graph_slam_tpu_torch.graph import ba_solve, lm
    from graph_slam_tpu_torch.pipelines import posegraph

    def lm_same(graph, values, params=None, inc=None):
        return lm.LMResult(values, lm.total_error(graph, values), 1, 0.0,
                           True)

    mp.setattr(posegraph, "lm_optimize", lm_same)
    mp.setattr(ba_solve, "sqrt_schur_gn_step",
               lambda graph, values, *a, **k: values)


def fault_half_the_factors(mp):
    """Every other factor row left out of the linearisation."""
    from graph_slam_tpu_torch.graph import factors, lm

    def half(fn):
        def f(values, table):
            r, J = fn(values, table)
            keep = (torch.arange(r.shape[0]) % 2 == 0).to(r.dtype)
            return r * keep[:, None], J * keep[:, None, None]
        return f

    mp.setattr(factors, "_projection_lin",
               half(factors._projection_lin))
    orig = lm.linearize_blocks

    def blocks(graph, values):
        out = orig(graph, values)
        return [(r * (torch.arange(r.shape[0]) % 2 == 0)[:, None],
                 J * (torch.arange(r.shape[0]) % 2 == 0)[:, None, None], c)
                for r, J, c in out]

    mp.setattr(lm, "linearize_blocks", blocks)


def fault_answer_altered(mp):
    """The answer altered where it is produced: one pose moved by 1 mm
    and one landmark by 1 m."""
    import graph_slam_tpu_torch.graph as G
    import graph_slam_tpu_torch.pipelines as P

    def moved(values):
        t, q = values.pose_t.clone(), values.point.clone()
        t[1, 0] += 1e-3
        if q.shape[0] > 1:
            q[1, 0] += 1.0
        return values._replace(pose_t=t, point=q)

    orig_run = P.run_g2o_file

    def run_g2o_file(*a, **k):
        res = orig_run(*a, **k)
        return dataclasses.replace(res, values=moved(res.values))

    mp.setattr(P, "run_g2o_file", run_g2o_file)
    fn = G.ba_gn_optimize_sqrt
    mp.setattr(G, "ba_gn_optimize_sqrt", lambda *a, **k: (
        lambda out: (moved(out[0]), out[1]))(fn(*a, **k)))


@pytest.mark.parametrize("fault", [fault_step_unchanged,
                                   fault_half_the_factors,
                                   fault_answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run(root, cell)
    assert res["correct"] is False and res["failed"] >= 1
    assert any(c["value"] is None or not c["value"] <= c["limit"]
               for c in res["checks"].values())


def test_the_float32_control_of_the_pose_graph_fails(root):
    """The reference in float32 in the program's place, held to the float64
    reference, fails the cell's limits."""
    cell = harness.Cell(root, "tiny-sphere-lm-dense")
    line = calibrate.readings(cell, 7, [cell.config["control"]],
                              torch.device("cpu"))
    assert all(v <= cell.limits[n] for n, v in line["program"].items())
    assert any(not v <= cell.limits[n]
               for n, v in line["control"][0].items())


def test_the_bfloat16_rows_control_of_bundle_adjustment_fails(root):
    """The reference with its projection rows rounded to bfloat16 in the
    program's place, held to the float64 reference, fails the cell's
    limits at a CPU test's size."""
    cell = harness.Cell(root, "tiny-ba-sqrt")
    line = calibrate.readings(cell, 7, [cell.config["control"]],
                              torch.device("cpu"))
    assert all(v <= cell.limits[n] for n, v in line["program"].items())
    assert any(not v <= cell.limits[n]
               for n, v in line["control"][0].items())


@pytest.mark.cuda
def test_the_reduced_precision_control_of_bundle_adjustment_fails():
    """The reference with its projection rows rounded to bfloat16, at the
    cell's own size, fails the cell's limits where the program passes
    them."""
    if not torch.cuda.is_available():
        pytest.skip("the cell's own size runs on the card")
    cell = harness.Cell(harness.CHECKOUT, "bal-ladybug-318-sqrt")
    line = calibrate.readings(cell, 7, [cell.config["control"]],
                              torch.device("cuda"))
    assert all(v <= cell.limits[n] for n, v in line["program"].items())
    assert any(not v <= cell.limits[n]
               for n, v in line["control"][0].items())


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "bal-ladybug-318-sqrt", "--seed", "1", "--seconds", "1"],
                       cwd=REPO, capture_output=True, text=True,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/ has no port
    to run: the run fails before any result."""
    tiny.make_copy(tmp_path)
    code = ("import sys; sys.path[:] = [p for p in sys.path if p not in "
            "('', {repo!r})]; sys.path.insert(0, {root!r}); "
            "import argparse; from portbench import harness; "
            "harness.run(argparse.Namespace(workload='tiny-ba-sqrt', seed=1, "
            "seconds=0.5, trace=0), root={root!r}, device='cpu', "
            "require_card=False)").format(repo=REPO,
                                                       root=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "graph_slam_tpu_torch" in p.stderr
