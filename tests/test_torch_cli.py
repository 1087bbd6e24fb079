"""The port's command line (``graph_slam_tpu_torch.cli``) against the JAX
package, on the CPU.

The parser is held to ``graph_slam_tpu.cli.build_parser()`` flag for flag
(the port adds only the top-level ``--device``). Every subcommand runs in
process through ``main(["--device", "cpu", ...])`` on the SR4000 wall
scenario of ``tests/test_cli.py`` (five ``.gsf`` frames, a four-edge VRO
log), on the two-plane room of ``test_plane_node.simulate_frames`` (``vio``,
with a preset file) or on the goldens, and its output is held to the JAX
package on the same inputs: to the JAX ``main`` run in process with the
same arguments (``slam``, ``vio``, ``plane-check``, ``delete-vo``,
``match``, ``view``, ``imu-preview``, ``presets``), or to the JAX function
that the reference's command calls. ``g2o`` is held to the golden optimum
that ``tests/test_goldens.py`` holds the JAX package's ``run_g2o_file`` to;
``bench`` runs on a 60-pose sphere. ``slam`` and ``vio`` are also held to
the port's own ``OnlineSlam`` and ``run_vio`` with the settings the command
gives them.

Tolerances: trajectories and chi2 of the float64 solvers within 1e-9;
clouds read back from float32 text within 1e-6 m, colours equal; filters,
meshes, logs and converted frames equal; the TSDF mesh's vertices within
1e-5 m (the port keeps the float32 grid the JAX package widens to float64
under x64); the online SLAM trajectory within 1e-6 m of JAX's and of the
port's in-process session; ``vio`` from float32 frames within the gap
``tests/test_torch_rescue.py`` pins for them (5e-6, chi2 5e-3 relative);
plane scores within 1e-5; matches within 2e-6 (float32 RANSAC refits
whose draws differ between the packages, on exact frames where the
consensus sets do not). Each looser bound is argued where it is used.
"""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest

from test_pipelines2 import render_wall_frame

from graph_slam_tpu import cli as jcli
from graph_slam_tpu.config import SR4000 as JSR4000
from graph_slam_tpu.config import SlamParams as JSlamParams
from graph_slam_tpu.core import se3 as jse3
from graph_slam_tpu.io import frames as jframes
from graph_slam_tpu.io import read_trajectory as jread_trajectory
from graph_slam_tpu.io import read_vro_log as jread_vro_log
from graph_slam_tpu_torch import cli
from graph_slam_tpu_torch.config import SR4000
from graph_slam_tpu_torch.io import (FrameStore, VROLog, read_trajectory,
                                     read_vro_log, write_trajectory,
                                     write_vro_log)
from graph_slam_tpu_torch.mapping import read_pcd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
XS = [0.0, 0.12, 0.24, 0.36, 0.48]


def run_port(*args):
    """``main(["--device", "cpu", *args])`` in process: (return, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--device", "cpu", *args])
    return rc, buf.getvalue()


def _read_ply(path):
    """(vertices (V, 3), colours (V, 3) or None, faces (F, 3)) of an ASCII
    PLY."""
    with open(path) as f:
        lines = f.read().splitlines()
    n_v = n_f = 0
    k = 0
    while lines[k] != "end_header":
        tok = lines[k].split()
        if tok[:2] == ["element", "vertex"]:
            n_v = int(tok[2])
        if tok[:2] == ["element", "face"]:
            n_f = int(tok[2])
        k += 1
    rows = [np.asarray(x.split(), float) for x in lines[k + 1:k + 1 + n_v]]
    v = np.asarray(rows).reshape(n_v, -1)
    faces = np.asarray([x.split()[1:] for x in lines[k + 1 + n_v:
                                                     k + 1 + n_v + n_f]],
                       int).reshape(n_f, 3)
    return v[:, :3], (v[:, 3:6] if v.shape[1] >= 6 else None), faces


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """``tests/test_cli.py``'s five-frame translating camera: .gsf frames,
    the VRO log, and a trajectory log of the true poses (identity
    rotations)."""
    root = tmp_path_factory.mktemp("torch_cli")
    frames_dir = str(root / "frames")
    store = FrameStore(frames_dir)
    for k, x in enumerate(XS):
        store.save(k, *render_wall_frame(SR4000, np.array([x, 0.0, 0.0])))
    info = np.diag([8e3] * 3 + [4e3] * 3)
    xi = [np.asarray(jse3.logmap(jse3.Pose(jnp.eye(3), jnp.array(
        [XS[k] - XS[k - 1], 0.0, 0.0])))) for k in range(1, len(XS))]
    log = VROLog(np.arange(1, len(XS)), np.arange(len(XS) - 1),
                 np.stack(xi), np.tile(info, (len(XS) - 1, 1, 1)))
    vro = str(root / "vro.log")
    write_vro_log(vro, log)
    gt = str(root / "gt.log")
    ids = np.arange(len(XS))
    write_trajectory(gt, ids, np.stack([[x, 0.0, 0.0] for x in XS]),
                     np.tile([1.0, 0.0, 0.0, 0.0], (len(XS), 1)), ids)
    return root, frames_dir, vro, gt


# -- the parser --------------------------------------------------------------

def _flags(sub):
    return {name: {a.dest: (tuple(a.option_strings), a.default,
                            None if a.choices is None else tuple(a.choices),
                            a.required, a.nargs,
                            getattr(a.type, "__name__", a.type))
                   for a in sp._actions if a.dest != "help"}
            for name, sp in sub.choices.items()}


def test_parser_matches_jax():
    jp, jsub = jcli.build_parser()
    tp, tsub = cli.build_parser()
    assert list(tsub.choices) == list(jsub.choices)
    assert len(tsub.choices) == 26
    assert _flags(tsub) == _flags(jsub)
    top = {a.dest for a in tp._actions} - {a.dest for a in jp._actions}
    assert top == {"device"}
    assert tp.parse_args(["presets"]).device is None


def test_preset_args_with_device_first(scenario):
    """A preset's args apply when ``--device`` comes before the
    subcommand, and a preset of another tool is refused."""
    _, sub = cli.build_parser()
    cli._apply_preset_args(sub.choices, ["--device", "cpu", "map",
                                         "--config", "mapping_PCD"])
    assert sub.choices["map"].get_default("roi") == "10,40,170,140"
    with pytest.raises(SystemExit, match="parameterizes subcommand 'map'"):
        cli.main(["--device", "cpu", "slam", "--frames", scenario[1],
                  "--config", "mapping_PCD"])


def test_module_entry_point_subprocess():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", "graph_slam_tpu_torch",
                          "--device", "cpu", "presets"], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-800:]
    _, want = _jax_stdout(jcli.cmd_presets, None)
    assert out.stdout == want
    assert len(out.stdout.splitlines()) == 26


def test_port_imports_no_jax():
    """Every module of the port, ``chip_smoke.py`` and
    ``rescue_port_ate.py``, imported in a fresh process: neither ``jax``
    nor ``graph_slam_tpu`` is loaded."""
    code = ("import importlib, pkgutil, sys\n"
            "import graph_slam_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke, rescue_port_ate\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(\n"
            "    ('jax.', 'jaxlib')) or m.split('.')[0] == 'graph_slam_tpu']\n"
            "print(len(sys.modules), bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-800:]
    assert out.stdout.strip().endswith("[]"), out.stdout


def _jax_stdout(fn, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(args)
    return rc, buf.getvalue()


def run_jax(*args):
    """The JAX package's ``main([*args])`` in process: (return, stdout)."""
    return _jax_stdout(jcli.main, list(args))


# -- pose graph, g2o, sparsify, evaluate -------------------------------------

def test_posegraph_matches_jax(scenario, tmp_path):
    from graph_slam_tpu.core import extrinsics as jext
    from graph_slam_tpu.graph import pose_marginals_all as jmarg
    from graph_slam_tpu.pipelines import run_pose_graph as jrun
    from graph_slam_tpu.pipelines import trajectory_arrays as jarrays

    root, _, vro, gt = scenario
    _, out = run_port("posegraph", "--vro", vro, "--out-dir", str(tmp_path),
                      "--marginals", str(tmp_path / "m.txt"), "--gt", gt)
    res = jrun(jread_vro_log(vro), JSlamParams())
    _, t, q, seq = jarrays(res.values, res.seq_ids,
                           w2o=jext.world_to_original(0.0))
    got = read_trajectory(str(tmp_path / "trajectory.log"))
    np.testing.assert_allclose(got.t, t, atol=1e-9)
    np.testing.assert_allclose(got.quat, q, atol=1e-9)
    np.testing.assert_array_equal(got.seq, seq)
    assert f"({res.iterations} LM iterations, 5 nodes)" in out
    from graph_slam_tpu_torch.io import read_marginals

    _, covs = read_marginals(str(tmp_path / "m.txt"))
    want = np.asarray(jmarg(res.graph, res.values, 5))
    np.testing.assert_allclose(covs, want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())
    assert "ATE RMSE" in out


def test_g2o_matches_the_golden_pin(tmp_path):
    """``g2o`` on the golden graph against the pinned optimum
    (``tests/goldens/chi2.json``) that ``tests/test_goldens.py`` holds the
    JAX package's ``run_g2o_file`` to, at the same 1e-6 relative."""
    path = os.path.join(GOLDENS, "sphere200_noisy.g2o")
    _, out = run_port("g2o", "--input", path, "--out-dir", str(tmp_path))
    pins = json.load(open(os.path.join(GOLDENS, "chi2.json")))
    e0, e1 = (float(x) for x in out.split("chi2: ")[1].split(" (")[0]
              .split(" -> "))
    np.testing.assert_allclose(e0, pins["g2o_error0"], rtol=1e-6)
    np.testing.assert_allclose(e1, pins["g2o_error"], rtol=1e-6)
    assert "200 vertices" in out
    got = read_trajectory(str(tmp_path / "trajectory.log"))
    assert len(got.t) == 200 and np.isfinite(got.t).all()


def _chi2s(out, sep):
    """(chi2 before, chi2 after) of a ``g2o`` (``sep="chi2: "``) or
    ``ba-imu`` (``"chi2 "``) report."""
    return tuple(float(x) for x in out.split(sep)[1].split(" (")[0]
                 .split(" -> "))


def test_g2o_sharded_matches_jax_and_the_pin(tmp_path):
    """``g2o --sharded 2 --iters 15``: factor-sharded PCG on two gloo
    ranks, held to the golden optimum at ``tests/test_cli.py::
    test_g2o_sharded``'s 1e-3 and to the JAX package's ``main`` run in
    process with the same arguments (two of the suite's virtual devices) at
    1e-6: chi2 relative, trajectory in meters."""
    args = ["g2o", "--input", os.path.join(GOLDENS, "sphere200_noisy.g2o"),
            "--sharded", "2", "--iters", "15", "--out-dir"]
    _, out = run_port(*args, str(tmp_path / "t"))
    _, want = run_jax(*args, str(tmp_path / "j"))
    assert "(15 sharded GN iterations over 2 devices, 200 vertices)" in out
    pins = json.load(open(os.path.join(GOLDENS, "chi2.json")))
    e0, e1 = _chi2s(out, "chi2: ")
    je0, je1 = _chi2s(want, "chi2: ")
    assert abs(e1 - pins["g2o_error"]) <= 1e-3 * pins["g2o_error"]
    np.testing.assert_allclose([e0, e1], [je0, je1], rtol=1e-6)
    got = read_trajectory(str(tmp_path / "t" / "trajectory.log"))
    ref = jread_trajectory(str(tmp_path / "j" / "trajectory.log"))
    np.testing.assert_array_equal(got.ids, np.asarray(ref.ids))
    np.testing.assert_allclose(got.t, np.asarray(ref.t), rtol=0, atol=1e-6)


def test_sparsify_matches_jax(scenario, tmp_path):
    from graph_slam_tpu.graph import gn_optimize, marginalize_poses
    from graph_slam_tpu.pipelines import run_pose_graph as jrun

    _, _, vro, _ = scenario
    _, out = run_port("sparsify", "--vro", vro, "--out-dir", str(tmp_path))
    res = jrun(jread_vro_log(vro), JSlamParams())
    g2, v2, old2new = marginalize_poses(res.graph, res.values, [1, 3])
    opt = gn_optimize(g2, v2, iterations=10)
    assert "poses 5 -> 3, between factors 4 -> " in out
    got = read_trajectory(str(tmp_path / "trajectory.log"))
    np.testing.assert_allclose(got.t, np.asarray(opt.values.pose_t)[:3],
                               atol=1e-9)
    from graph_slam_tpu_torch.io import read_g2o

    vertices, edges = read_g2o(str(tmp_path / "sparsified.g2o"))
    assert len(vertices) == 3
    assert len(edges) == int(np.asarray(g2.between.active).sum())


def test_evaluate_matches_jax(scenario, tmp_path):
    from graph_slam_tpu.utils.metrics import ate_stats, rpe_stats

    _, _, _, gt = scenario
    est = tmp_path / "est.log"
    r = np.random.default_rng(0)
    t = np.stack([[x, 0.0, 0.0] for x in XS]) + r.normal(0, 0.01, (5, 3))
    write_trajectory(str(est), np.arange(5), t,
                     np.tile([1.0, 0.0, 0.0, 0.0], (5, 1)), np.arange(5))
    run_port("evaluate", "--est", str(est), "--gt", gt, "--json",
             str(tmp_path / "ev.json"), "--delta", "2", "--scale")
    got = json.load(open(tmp_path / "ev.json"))
    ate, aligned = ate_stats(jread_trajectory(str(est)).t,
                             jread_trajectory(gt).t, with_scale=True)
    rp = rpe_stats(aligned, jread_trajectory(gt).t, delta=2)
    for k, v in ate.items():
        np.testing.assert_allclose(got["ate"][k], v, rtol=1e-12)
    for k, v in rp.items():
        np.testing.assert_allclose(got["rpe"][k], v, rtol=1e-12)


# -- mapping ------------------------------------------------------------------

def _jax_cloud(traj_path, frames_dir, stride, skip=2, z_max=10.0,
               voxel=0.0, roi=None):
    from graph_slam_tpu.mapping import accumulate_cloud, voxel_filter

    store = jframes.FrameStore(frames_dir)
    if roi is not None:
        u0, v0, u1, v1 = roi

        def src(seq):
            inten, depth = store(seq)
            m = np.zeros_like(depth)
            m[v0:v1, u0:u1] = 1.0
            return inten, depth * m
    else:
        src = store
    pts, cols = accumulate_cloud(jread_trajectory(traj_path), src, JSR4000,
                                 stride=stride, skip=skip, z_max=z_max)
    if voxel:
        pts, cols = voxel_filter(pts, cols, voxel=voxel)
    return pts, cols


def test_map_filter_mesh_match_jax(scenario, tmp_path):
    from graph_slam_tpu.mapping import grid_triangulate
    from graph_slam_tpu.mapping import occupancy_denoise, passthrough

    _, frames_dir, _, gt = scenario
    pcd = str(tmp_path / "map.pcd")
    run_port("map", "--traj", gt, "--frames", frames_dir, "--out", pcd,
             "--stride", "1", "--voxel", "0.05")
    pts, cols = read_pcd(pcd)
    want, want_c = _jax_cloud(gt, frames_dir, 1, voxel=0.05)
    np.testing.assert_allclose(pts, want, atol=1e-6)
    np.testing.assert_array_equal(cols, want_c)

    ply = str(tmp_path / "map.ply")
    run_port("map", "--traj", gt, "--frames", frames_dir, "--out", ply,
             "--stride", "2", "--z-max", "5.0")
    v, c, _ = _read_ply(ply)
    want, want_c = _jax_cloud(gt, frames_dir, 2, z_max=5.0)
    np.testing.assert_allclose(v, want, atol=1e-6)
    np.testing.assert_array_equal(c, want_c)

    roi = str(tmp_path / "roi.pcd")
    run_port("map", "--traj", gt, "--frames", frames_dir, "--config",
             "mapping_PCD", "--stride", "1", "--out", roi)
    pts_roi, _ = read_pcd(roi)
    want, _ = _jax_cloud(gt, frames_dir, 1, roi=(10, 40, 170, 140))
    np.testing.assert_allclose(pts_roi, want, atol=1e-6)

    filt = str(tmp_path / "f.pcd")
    run_port("filter", "--pcd", pcd, "--out", filt, "--voxel", "0.1",
             "--z-min", "1.5", "--z-max", "3.0", "--min-neighbors", "4")
    p0, c0 = read_pcd(pcd)
    p1, c1 = passthrough(p0, c0, lo=1.5, hi=3.0)
    p1, c1 = occupancy_denoise(p1, c1, voxel=0.1, min_neighbors=4)
    got, got_c = read_pcd(filt)
    np.testing.assert_allclose(got, p1, atol=1e-6)
    np.testing.assert_array_equal(got_c, c1)

    mesh = str(tmp_path / "mesh.ply")
    _, out = run_port("mesh", "--pcd", pcd, "--out", mesh)
    verts, faces = grid_triangulate(p0, 0.05, 0.15)
    mv, _, mf = _read_ply(mesh)
    np.testing.assert_array_equal(mf, faces)
    np.testing.assert_allclose(mv, verts, rtol=1e-15, atol=0)
    assert f"{len(verts)} vertices, {len(faces)} faces" in out


def test_video_matches_jax(scenario, tmp_path):
    from graph_slam_tpu.mapping import incremental_map_video

    _, frames_dir, _, gt = scenario
    run_port("video", "--traj", gt, gt, "--frames", frames_dir, "--out-dir",
             str(tmp_path / "t"), "--every", "2")
    snaps = incremental_map_video([jread_trajectory(gt)] * 2,
                                  jframes.FrameStore(frames_dir), JSR4000,
                                  str(tmp_path / "j"), every=2, voxel=0.05)
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))
    for s in snaps:
        v, c, _ = _read_ply(str(tmp_path / "t" / os.path.basename(s)))
        wv, wc, _ = _read_ply(s)
        np.testing.assert_allclose(v, wv, atol=1e-6)
        np.testing.assert_array_equal(c, wc)
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / "t" / "camera_path.txt"),
        np.loadtxt(tmp_path / "j" / "camera_path.txt"), atol=1e-12)


def test_tsdf_matches_jax(scenario, tmp_path):
    from graph_slam_tpu.mapping import extract_mesh, fuse_trajectory

    _, frames_dir, _, gt = scenario
    out = str(tmp_path / "mesh.ply")
    _, stdout = run_port("tsdf", "--traj", gt, "--frames", frames_dir,
                         "--out", out, "--size", "4.0", "--n", "64",
                         "--origin=-2,-2,0")
    vol = fuse_trajectory(jread_trajectory(gt),
                          jframes.FrameStore(frames_dir), JSR4000,
                          np.array([-2.0, -2.0, 0.0]), 4.0, n=64)
    verts, faces = extract_mesh(vol)
    v, _, f = _read_ply(out)
    assert len(faces) > 1000
    assert f"{len(verts)} vertices, {len(faces)} faces" in stdout
    np.testing.assert_array_equal(f, faces)
    np.testing.assert_allclose(v, verts, atol=1e-5)


def test_convert_frames_matches_jax(tmp_path):
    from graph_slam_tpu.io import convert_bdat_dir

    src = tmp_path / "bdat"
    src.mkdir()
    r = np.random.default_rng(3)
    for seq in (7, 8):
        z = r.uniform(0.5, 4.0, (144, 176)).astype("<f4")
        amp = r.integers(0, 60000, (144, 176)).astype("<u2")
        (src / f"d1_{seq:07d}.bdat").write_bytes(
            b"\0" * 12 + z.tobytes() + amp.tobytes())
    _, out = run_port("convert-frames", "--src", str(src), "--dst",
                      str(tmp_path / "t"))
    assert "converted 2 frames" in out
    assert convert_bdat_dir(str(src), str(tmp_path / "j")) == 2
    for seq in (7, 8):
        name = f"{seq:07d}.gsf"
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


# -- logs, planes, matching ---------------------------------------------------

def test_log_tools_match_jax(scenario, tmp_path):
    from graph_slam_tpu.tools import (compute_trans_difference, convert_vo2ba,
                                      merge_vro)

    _, _, vro, _ = scenario
    matches = str(tmp_path / "m.log")
    np.savetxt(matches, np.array([[k, k - 1, 5 + 10 * k]
                                  for k in range(1, 5)]))
    counts = np.loadtxt(matches)[:, 2].astype(int)
    jlog = jread_vro_log(vro)
    for model in ("cut", "hybrid"):
        out = str(tmp_path / f"{model}.log")
        run_port("convert", "--vro", vro, "--model", model, "--matches",
                 matches, "--min-match-num", "20", "--out", out)
        want = convert_vo2ba(jlog, model, match_counts=counts,
                             min_match_num=20)
        got = read_vro_log(out)
        np.testing.assert_array_equal(got.info, want.info)
        np.testing.assert_array_equal(got.xi, want.xi)
    out = str(tmp_path / "merge.log")
    run_port("merge", "--ba", str(tmp_path / "cut.log"), "--vro", vro,
             "--matches", matches, "--thresh", "20", "--out", out)
    want = merge_vro(jread_vro_log(str(tmp_path / "cut.log")), jlog, counts,
                     thresh=20)
    np.testing.assert_array_equal(read_vro_log(out).info, want.info)
    _, stdout = run_port("diff", "--log1", vro, "--log2",
                         str(tmp_path / "cut.log"))
    dt, dr = compute_trans_difference(jlog,
                                      jread_vro_log(str(tmp_path /
                                                        "cut.log")))
    assert f"mean |dt|={np.nanmean(dt):.6f} m" in stdout
    assert f"max |dr|={np.nanmax(dr):.6f}" in stdout


def test_plane_check_and_delete_vo_match_jax(scenario, tmp_path):
    """``plane-check`` and ``delete-vo`` against the JAX package's commands
    on the same files, each with its own plane extraction."""
    _, frames_dir, vro, _ = scenario
    scores = str(tmp_path / "pc.log")
    jscores = str(tmp_path / "jpc.log")
    _, out = run_port("plane-check", "--vro", vro, "--frames", frames_dir,
                      "--out", scores)
    _, want_out = run_jax("plane-check", "--vro", vro, "--frames", frames_dir,
                          "--out", jscores)
    assert "scored 4 edges" in out
    assert out.replace("pc.log", "") == want_out.replace("jpc.log", "")
    got, want = np.loadtxt(scores), np.loadtxt(jscores)
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=1e-5,
                               atol=1e-5)
    pair = ["plane-check", "--vro", vro, "--frames", frames_dir, "--pair",
            "0:1", "--min-support", "200"]
    _, out = run_port(*pair)
    assert "scored 1 edges" in out and "edge 0->1: matched_planes=1" in out
    _, want_out = run_jax(*pair)
    assert out == want_out

    # JAX's delete-vo on its own scores; the port's from its scores and
    # from the frames (its extraction again) held to that
    tail = ["--thresh", "-1.0", "--out"]
    _, want_out = run_jax("delete-vo", "--vro", vro, "--scores", jscores,
                          *tail, str(tmp_path / "jdel.log"))
    want = jread_vro_log(str(tmp_path / "jdel.log")).valid
    for src in (["--scores", scores], ["--frames", frames_dir]):
        _, out = run_port("delete-vo", "--vro", vro, *src, *tail,
                          str(tmp_path / "del.log"))
        assert out.replace("del.log", "") == want_out.replace("jdel.log", "")
        got = read_vro_log(str(tmp_path / "del.log"))
        np.testing.assert_array_equal(got.valid, want)
        assert (~got.valid).all()


def test_add_vo_sparse_matches_jax(scenario, tmp_path):
    from graph_slam_tpu.tools import add_vo_at_sparse_area, make_frame_matcher
    from graph_slam_tpu.vision.frontend import make_feature_cache

    _, frames_dir, vro, _ = scenario
    out = str(tmp_path / "add.log")
    _, stdout = run_port("add-vo-sparse", "--vro", vro, "--frames",
                         frames_dir, "--sparse-thresh", "9999", "--window",
                         "3", "--out", out)
    store = jframes.FrameStore(frames_dir)
    feat = make_feature_cache(store, JSR4000)
    counts = {s: int(np.asarray(feat(s).valid).sum()) for s in range(5)}
    want = add_vo_at_sparse_area(jread_vro_log(vro), counts,
                                 make_frame_matcher(store, JSR4000,
                                                    feature_cache=feat),
                                 window=3, sparse_thresh=9999)
    got = read_vro_log(out)
    np.testing.assert_array_equal(got.id_to, want.id_to)
    np.testing.assert_array_equal(got.id_from, want.id_from)
    np.testing.assert_allclose(got.xi, want.xi, atol=1e-5)
    np.testing.assert_allclose(got.info, want.info, rtol=1e-5,
                               atol=1e-5 * np.abs(want.info).max())
    assert f"({len(want) - 4} edges added, 5 sparse frames)" in stdout


@pytest.mark.parametrize("method", ["svd", "pnp"])
def test_match_matches_jax(scenario, tmp_path, method):
    args = ["match", "--frames", scenario[1], "--src", "1", "--tar", "0",
            "--method", method, "--out-ply", str(tmp_path / "t.ply")]
    _, out = run_port(*args)
    rc, want = _jax_stdout(jcli.cmd_match,
                           jcli.build_parser()[0].parse_args(
                               args[:-1] + [str(tmp_path / "j.ply")]))
    assert rc == 0 and "match OK" in out

    def row(text, head):
        line = next(x for x in text.splitlines() if x.startswith(head))
        return np.asarray(line[len(head):].split(), float)

    np.testing.assert_allclose(row(out, "t:"), row(want, "t:"), atol=2e-6)
    np.testing.assert_allclose(row(out, "xi (rot-first se3 log):"),
                               row(want, "xi (rot-first se3 log):"),
                               atol=2e-6)
    np.testing.assert_allclose(row(out, "info diag:"),
                               row(want, "info diag:"), rtol=1e-5)
    np.testing.assert_allclose(row(out, "t:"), [0.12, 0.0, 0.0], atol=5e-3)
    v, c, _ = _read_ply(str(tmp_path / "t.ply"))
    wv, wc, _ = _read_ply(str(tmp_path / "j.ply"))
    np.testing.assert_allclose(v, wv, atol=2e-5)
    np.testing.assert_array_equal(c, wc)


def test_view_modes_match_jax(scenario, tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    _, frames_dir, vro, _ = scenario
    lst = str(tmp_path / "vo_list.log")
    with open(lst, "w") as f:
        f.write("1 0 20\n2 1 30\n")
    runs = [["--mode", "pair", "--vro", vro, "--from-id", "0", "--to-id",
             "1"],
            ["--mode", "range", "--vro", vro, "--start", "0", "--end", "3"],
            ["--mode", "list", "--vro", vro, "--list", lst, "--min-num", "1",
             "--max-num", "26"],
            ["--mode", "planes", "--frame-id", "0", "--min-support", "200"]]
    for extra in runs:
        _, out = run_port("view", "--frames", frames_dir, "--out-dir",
                          str(tmp_path / "t"), *extra)
        _, want = _jax_stdout(jcli.cmd_view, jcli.build_parser()[0]
                              .parse_args(["view", "--frames", frames_dir,
                                           "--out-dir", str(tmp_path / "j"),
                                           *extra]))
        assert out.replace(str(tmp_path / "t"), "") == \
            want.replace(str(tmp_path / "j"), "")
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert "planes_0.png" in names and "reg_0_1.ply" in names
    for name in names:
        if name.endswith(".ply"):
            v, c, _ = _read_ply(str(tmp_path / "t" / name))
            wv, wc, _ = _read_ply(str(tmp_path / "j" / name))
            np.testing.assert_allclose(v, wv, atol=1e-6)
            np.testing.assert_array_equal(c, wc)
        else:
            np.testing.assert_array_equal(
                np.asarray(Image.open(tmp_path / "t" / name)),
                np.asarray(Image.open(tmp_path / "j" / name)))


def test_imu_preview_matches_jax(tmp_path):
    t = np.arange(0, 2, 0.005)
    gyr = np.zeros((len(t), 3))
    gyr[:, 2] = 0.1
    gyr[:, 0] = 0.02 * np.sin(t)
    acc = np.tile([0.0, 0.0, 9.81], (len(t), 1))
    rpy = np.zeros((len(t), 3))
    rpy[:, 0] = np.degrees(0.1 * t)
    imu = str(tmp_path / "imu.log")
    np.savetxt(imu, np.column_stack([t, acc, gyr, rpy]))
    args = ["imu-preview", "--imu", imu, "--static-samples", "10", "--out"]
    _, out = run_port(*args, str(tmp_path / "t.log"))
    _, want = _jax_stdout(jcli.cmd_imu_preview, jcli.build_parser()[0]
                          .parse_args(args + [str(tmp_path / "j.log")]))
    assert out.replace("t.log", "") == want.replace("j.log", "")
    assert (tmp_path / "t.log").read_text() == \
        (tmp_path / "j.log").read_text()


# -- frames-driven estimators --------------------------------------------------

def test_ba_imu_matches_jax(scenario):
    from graph_slam_tpu.pipelines.ba_imu import (BaImuConfig,
                                                 features_from_store,
                                                 run_ba_imu)

    _, frames_dir, _, _ = scenario
    _, out = run_port("ba-imu", "--frames", frames_dir, "--seqs", "0:5")
    frames, matches = features_from_store(jframes.FrameStore(frames_dir),
                                          list(range(5)), JSR4000)
    res = run_ba_imu(frames, matches, {}.get, None, None, JSR4000,
                     cfg=BaImuConfig(use_imu=False))
    assert f"(proj={res.n_projection_factors} landmarks={res.n_landmarks} " \
           "imu=0)" in out
    e0, e1 = (float(x) for x in out.split("chi2 ")[1].split(" (")[0]
              .split(" -> "))
    np.testing.assert_allclose(e0, res.error0, rtol=1e-6)
    np.testing.assert_allclose(e1, res.error, rtol=1e-6)


def test_ba_imu_sharded_matches_jax(scenario):
    """``ba-imu --sharded 2``: the landmark-sharded square-root Schur on
    two gloo ranks against the JAX package's ``main`` run in process with
    the same arguments (``tests/test_cli.py::test_ba_imu_sharded``'s
    command): the same counts, chi2 within 1e-6 relative."""
    _, frames_dir, _, _ = scenario
    args = ["ba-imu", "--frames", frames_dir, "--seqs", "0:5", "--sharded",
            "2"]
    _, out = run_port(*args)
    _, want = run_jax(*args)
    assert out.split(" (")[1] == want.split(" (")[1]     # counts
    np.testing.assert_allclose(_chi2s(out, "chi2 "), _chi2s(want, "chi2 "),
                               rtol=1e-6)


def _slam_args(frames_dir, gt, out):
    return ["slam", "--frames", frames_dir, "--out-dir", out, "--n-hyp",
            "512", "--min-inliers", "10", "--record", out + "/rec.log",
            "--marginals", out + "/m.txt", "--gt", gt]


@pytest.fixture(scope="module")
def slam_run(scenario):
    """The port's ``slam`` on the scenario's store: (output dir, stdout)."""
    root, frames_dir, _, gt = scenario
    out = str(root / "slam")
    return out, run_port(*_slam_args(frames_dir, gt, out))[1]


def test_slam_matches_the_in_process_session(scenario, slam_run):
    """``slam`` against the port's ``OnlineSlam`` fed the store's frames,
    with the settings the command gives it."""
    from graph_slam_tpu_torch.config import SlamParams
    from graph_slam_tpu_torch.pipelines import OnlineSlam

    _, frames_dir, _, _ = scenario
    tdir, out = slam_run
    store = FrameStore(frames_dir)
    kw = dict(n_hyp=512, min_inliers=10)
    ts = OnlineSlam(cam=SR4000, params=SlamParams(), device="cpu", **kw)
    st_t = [ts.process_frame(*store(k), seq_id=k) for k in range(5)]
    ts.optimize()
    assert st_t == ["first"] + ["keyframe"] * 4
    assert "frames=5 keyframes=5 [first=1 keyframe=4]" in out
    got = read_trajectory(tdir + "/trajectory.log")
    _, t_in, q_in, _ = ts.trajectory()
    np.testing.assert_allclose(got.t, t_in, atol=1e-6)
    np.testing.assert_allclose(got.quat, q_in, atol=1e-6)
    np.testing.assert_allclose(read_vro_log(tdir + "/rec.log").xi,
                               ts.vro_log().xi, atol=1e-12)
    from graph_slam_tpu_torch.io import read_marginals

    assert len(read_marginals(tdir + "/m.txt")[0]) == 5
    assert "ATE RMSE" in out


def test_slam_matches_jax(scenario, slam_run, tmp_path):
    """``slam`` against the JAX package's ``slam`` on the same store and
    flags: the frontend's RANSAC draws differ between the packages, so its
    float32 refits differ in their last bits (measured: poses 3.8e-8 m,
    recorded VO 6e-8 and its information 3.4e-6 of its largest entry,
    chi2 3e-4 relative, marginals 2.5e-4 of their largest entry)."""
    from graph_slam_tpu.io import read_marginals as jread_marginals
    from graph_slam_tpu_torch.io import read_marginals

    _, frames_dir, _, gt = scenario
    tdir, out = slam_run
    jdir = str(tmp_path)
    _, want = run_jax(*_slam_args(frames_dir, gt, jdir))
    lines, jlines = out.splitlines(), want.splitlines()
    assert len(lines) == len(jlines) == 6
    for k in (0, 5):           # statuses and keyframes; ATE and RPE
        assert lines[k] == jlines[k]
    assert lines[3].replace(tdir, "") == jlines[3].replace(jdir, "")
    np.testing.assert_allclose(float(lines[1].split(": ")[1]),
                               float(jlines[1].split(": ")[1]), rtol=1e-3)
    got, ref = (read_trajectory(d + "/trajectory.log") for d in (tdir, jdir))
    np.testing.assert_array_equal(got.seq, ref.seq)
    np.testing.assert_allclose(got.t, ref.t, atol=1e-6)
    np.testing.assert_allclose(got.quat, ref.quat, atol=1e-6)
    g, r = (read_vro_log(d + "/rec.log") for d in (tdir, jdir))
    np.testing.assert_array_equal(g.id_to, r.id_to)
    np.testing.assert_array_equal(g.id_from, r.id_from)
    np.testing.assert_allclose(g.xi, r.xi, atol=1e-6)
    np.testing.assert_allclose(g.info, r.info, rtol=0,
                               atol=1e-5 * np.abs(r.info).max())
    cov, jcov = (read_marginals(tdir + "/m.txt")[1],
                 jread_marginals(jdir + "/m.txt")[1])
    np.testing.assert_allclose(cov, jcov, rtol=0,
                               atol=1e-3 * np.abs(jcov).max())


@pytest.fixture(scope="module")
def vio_files(tmp_path_factory):
    """``test_plane_node.simulate_frames``'s two-plane room written as the
    ``vio`` command reads it: (VRO log, IMU log, times, frame store)."""
    from test_plane_node import simulate_frames

    root = tmp_path_factory.mktemp("torch_cli_vio")
    log, img_times, stream, _, _, frames = simulate_frames()
    store = FrameStore(str(root / "frames"))
    for seq, (inten, depth) in frames.items():
        store.save(seq, inten, depth)
    vro = str(root / "vro.log")
    write_vro_log(vro, VROLog(log.id_to, log.id_from, log.xi, log.info))
    imu_path = str(root / "imu_v100.log")
    np.savetxt(imu_path, np.concatenate(
        [stream.t[:, None], stream.acc, stream.gyr,
         np.zeros((len(stream.t), 3))], axis=1))
    times_path = str(root / "timestamp.log")
    with open(times_path, "w") as f:
        for seq, t in img_times.items():
            f.write(f"{seq} {t}\n")
    preset = str(root / "vio_preset.json")
    with open(preset, "w") as f:
        json.dump(VIO_PRESET, f)
    return root, vro, imu_path, times_path, str(root / "frames"), preset


# a preset file: the top level sets SlamParams, "vio" sets VioConfig; small
# arenas, so that the JAX package compiles its programs once and quickly
VIO_PRESET = {"description": "test", "optimize_step": 4,
              "vio": {"plane_mode": "rescue", "bucket": 16,
                      "max_imu_window": 64}}


def _vio_args(vio_files, out):
    _, vro, imu_path, times_path, frames, preset = vio_files
    return ["vio", "--vro", vro, "--imu", imu_path, "--times", times_path,
            "--frames", frames, "--extrinsic", "identity", "--config",
            preset, "--out-dir", out]


@pytest.fixture(scope="module")
def vio_run(vio_files):
    """The port's ``vio --plane-mode rescue`` from the files: (output dir,
    stdout)."""
    out = str(vio_files[0] / "out")
    return out, run_port(*_vio_args(vio_files, out))[1]


def test_vio_matches_port_run(vio_files, vio_run):
    """``vio --frames`` with a preset file against the port's ``run_vio``
    with the configuration the command builds from it."""
    from graph_slam_tpu_torch import imu
    from graph_slam_tpu_torch.config import SlamParams
    from graph_slam_tpu_torch.core import extrinsics
    from graph_slam_tpu_torch.io import open_frame_source
    from graph_slam_tpu_torch.pipelines import trajectory_arrays
    from graph_slam_tpu_torch.pipelines.vio import VioConfig, run_vio

    _, vro, imu_path, times_path, frames, _ = vio_files
    tdir, out = vio_run
    res = run_vio(read_vro_log(vro), cli._read_times(times_path),
                  imu.read_vn100_log(imu_path),
                  imu.vn100_params(device="cpu"),
                  params=SlamParams(optimize_step=4),
                  frames=open_frame_source(frames),
                  intrinsics=SR4000, device="cpu",
                  cfg=VioConfig(optimize_step=4, **VIO_PRESET["vio"]))
    assert f"plane={res.n_plane_factors})" in out
    assert res.n_plane_factors >= 4
    got = read_trajectory(tdir + "/trajectory.log")
    _, t, _, _ = trajectory_arrays(
        res.values, res.seq_ids,
        w2o=extrinsics.world_to_original(0.0, device="cpu"))
    assert len(got.t) == len(read_vro_log(vro).id_to) + 1
    np.testing.assert_allclose(got.t, t, atol=1e-9)


def test_vio_matches_jax(vio_files, vio_run, tmp_path):
    """``vio --frames`` with a preset file against the JAX package's ``vio``
    on the same files and flags. The store holds float32 depth, which the
    reference refits in float32 and the port in float64: the gap is the one
    ``tests/test_torch_rescue.py`` pins on float32 frames (values 5e-6,
    chi2 5e-3 relative; measured here 2.5e-7 m and 2.4e-3), with the
    counts equal."""
    tdir, out = vio_run
    jdir = str(tmp_path)
    _, want = run_jax(*_vio_args(vio_files, jdir))
    lines, jlines = out.splitlines(), want.splitlines()
    assert len(lines) == len(jlines) == 3
    assert lines[0] == jlines[0] and lines[0].startswith("note: ")
    head, counts = lines[1].split(" (")
    jhead, jcounts = jlines[1].split(" (")
    assert counts == jcounts and "plane=6)" in counts
    np.testing.assert_allclose(
        [float(x) for x in head.split(": ")[1].split(" -> ")],
        [float(x) for x in jhead.split(": ")[1].split(" -> ")],
        rtol=5e-3, atol=1e-6)
    got, ref = (read_trajectory(d + "/trajectory.log") for d in (tdir, jdir))
    np.testing.assert_array_equal(got.seq, ref.seq)
    np.testing.assert_allclose(got.t, ref.t, atol=5e-6)
    np.testing.assert_allclose(got.quat, ref.quat, atol=5e-6)


# -- services and the bench -----------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_serve_and_publish_subcommands(scenario, tmp_path):
    from graph_slam_tpu.mapping import read_published
    from graph_slam_tpu.serving import SlamClient

    _, frames_dir, _, gt = scenario
    port = _free_port()
    th = threading.Thread(target=run_port, args=(
        "serve", "--port", str(port), "--max-messages", "2"), daemon=True)
    th.start()
    client = None
    for _ in range(200):
        try:
            client = SlamClient("127.0.0.1", port, timeout=120.0)
            break
        except OSError:
            th.join(0.05)
    assert client is not None
    store = FrameStore(frames_dir)
    assert client.send_frame(0, *store(0))["status"] == "first"
    assert client.send_frame(1, *store(1))["status"] == "keyframe"
    client.sock.close()
    th.join(60)
    assert not th.is_alive()

    pcd = str(tmp_path / "map.pcd")
    run_port("map", "--traj", gt, "--frames", frames_dir, "--out", pcd,
             "--voxel", "0.05")
    port = _free_port()
    th = threading.Thread(target=run_port, args=(
        "publish", "--pcd", pcd, "--port", str(port), "--rate", "50",
        "--cycles", "40"), daemon=True)
    th.start()
    msgs = None
    for _ in range(200):
        try:
            msgs = read_published("127.0.0.1", port, n_messages=1)
            break
        except OSError:
            th.join(0.05)
    th.join(60)
    pts, cols, header = msgs[0]
    want, want_c = read_pcd(pcd)
    np.testing.assert_array_equal(pts, want.astype(np.float32))
    np.testing.assert_array_equal(cols, want_c)
    assert header["frame_id"] == "map"


def test_bench_on_a_small_sphere(monkeypatch):
    from graph_slam_tpu.datasets import make_sphere_graph as jsphere
    from graph_slam_tpu.graph import gn_optimize as jgn
    from graph_slam_tpu_torch import datasets

    real = datasets.make_sphere_graph
    monkeypatch.setattr(datasets, "make_sphere_graph",
                        lambda n, *a, **kw: real(60, *a, **kw))
    _, out = run_port("bench")
    g, v, _ = jsphere(n_poses=60, edges_per_pose=4.0, seed=0,
                      dtype=jnp.float32, bucket=256)
    res = jgn(g, v, iterations=200, solver="pcg", damping=1e-3,
              pcg_iters=10)
    assert "GN it/s" in out
    got = float(out.split(" -> ")[1].split(" ")[0])
    np.testing.assert_allclose(got, float(res.error), rtol=1e-3)
