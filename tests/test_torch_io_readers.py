"""The port's remaining readers, the native IO runtime, the colour table and
the launch-file presets against the JAX package, on the CPU.

- ``io.rgbd_png`` (PNG pairs), ``io.sr4000`` (``.bdat`` in its three
  layouts), ``io.tum`` (association, sequences, ground truth) and
  ``utils.colors``: equal outputs on the same files;
- ``native``: every function against its Python fallback and against the
  JAX package's native build, and each reader of the earlier slices that
  now goes through it (``read_vro_log``, ``read_trajectory``,
  ``write_ply_points``, ``FrameStore.load_batch``, the IMU logs) equal on
  both paths;
- the presets: each JSON byte-equal to the JAX copy but for the value of
  ``source``, which names the same launch file by its path in the
  reference repository instead of a machine's absolute path;
  ``load_params`` equal; every preset's ``args`` a real flag of the port's
  parser.

Tolerances: equality throughout, but float32 text, which the native writer
prints to 9 significant digits (``%.9g``) and the Python one whole.
"""

import json
import os

import numpy as np
import pytest

from graph_slam_tpu import config as jconfig
from graph_slam_tpu import io as jio
from graph_slam_tpu import native as jnative
from graph_slam_tpu.imu import streams as jstreams
from graph_slam_tpu.utils import colors as jcolors
from graph_slam_tpu_torch import cli, config, io as tio, native
from graph_slam_tpu_torch.imu import streams
from graph_slam_tpu_torch.io import rgbd_png, sr4000, tum
from graph_slam_tpu_torch.utils import colors


def _pil_image():
    """PIL's Image module; the PNG cases skip where PIL is missing."""
    return pytest.importorskip("PIL.Image")


# -- colours --------------------------------------------------------------------

def test_colors_equal():
    assert colors.COLORS == jcolors.COLORS
    for key in list(colors.COLORS) + list(range(-3, 12)):
        np.testing.assert_array_equal(colors.color(key), jcolors.color(key))


# -- SR4000 .bdat -------------------------------------------------------------------

def _bdat(path, layout, header=0, seed=0):
    r = np.random.default_rng(seed)
    n = 144 * 176
    z = r.uniform(0.3, 5.0, n).astype("<f4")
    amp = r.integers(0, 65535, n).astype("<u2")
    if layout == "zxyi":
        body = z.tobytes() + (z * 0.5).tobytes() + (z * 0.2).tobytes() \
            + amp.tobytes()
    elif layout == "zf_i":
        z[::97] = np.nan
        body = z.tobytes() + amp.tobytes()
    else:
        body = (z * 1000).astype("<u2").tobytes() + amp.tobytes()
    with open(path, "wb") as f:
        f.write(bytes(range(header % 256))[:header] + body)


@pytest.mark.parametrize("layout", ["zxyi", "zf_i", "z_i"])
def test_read_bdat_equal(tmp_path, layout):
    path = str(tmp_path / "f.bdat")
    _bdat(path, layout, header=24)
    for kw in ({}, {"layout": layout}, {"header_bytes": 24},
               {"sqrt_intensity": False}, {"layout": layout,
                                           "z_unit_mm": False}):
        got = sr4000.read_bdat(path, **kw)
        want = jio.read_bdat(path, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_bdat_errors_and_convert_equal(tmp_path):
    small = tmp_path / "small.bdat"
    small.write_bytes(b"\0" * 100)
    with pytest.raises(ValueError, match="too small"):
        sr4000.read_bdat(str(small))
    with pytest.raises(ValueError, match="too small for layout"):
        sr4000.read_bdat(str(small), layout="z_i")
    src = tmp_path / "src"
    src.mkdir()
    for seq, layout in ((3, "zf_i"), (4, "zf_i")):
        _bdat(str(src / f"frame_{seq:07d}.bdat"), layout, header=8, seed=seq)
    (src / "notes.bdat").write_bytes(b"x")       # no sequence id: skipped
    assert sr4000.convert_bdat_dir(str(src), str(tmp_path / "t")) == 2
    assert jio.convert_bdat_dir(str(src), str(tmp_path / "j")) == 2
    for seq in (3, 4):
        name = f"{seq:07d}.gsf"
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


# -- PNG pairs and TUM sequences --------------------------------------------------

def test_png_pairs_equal(tmp_path):
    Image = _pil_image()
    r = np.random.default_rng(1)
    for seq in (0, 1):
        Image.fromarray(r.integers(0, 255, (24, 32, 3), dtype=np.uint8)) \
            .save(tmp_path / f"color_{seq:06d}.png")
        Image.fromarray(r.integers(0, 8000, (24, 32), dtype=np.uint16)) \
            .save(tmp_path / f"depth_{seq:06d}.png")
    Image.fromarray(r.integers(0, 255, (24, 32), dtype=np.uint8)) \
        .save(tmp_path / "0000002.png")
    Image.fromarray(r.integers(0, 8000, (24, 32), dtype=np.uint16)) \
        .save(tmp_path / "0000002_depth.png")
    src = tio.open_frame_source(str(tmp_path))
    jsrc = jio.open_frame_source(str(tmp_path))
    assert isinstance(src, rgbd_png.PngFrameStore)
    for seq in (0, 1, 2, 3):
        got, want = src(seq), jsrc(seq)
        if want is None:
            assert got is None
            continue
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    fixed = rgbd_png.PngFrameStore(str(tmp_path),
                                   color_pattern="color_{seq:06d}.png",
                                   depth_pattern="depth_{seq:06d}.png",
                                   depth_scale=0.002)
    jfixed = jio.PngFrameStore(str(tmp_path),
                               color_pattern="color_{seq:06d}.png",
                               depth_pattern="depth_{seq:06d}.png",
                               depth_scale=0.002)
    np.testing.assert_array_equal(fixed(1)[1], jfixed(1)[1])
    assert fixed(2) is None and jfixed(2) is None


def test_frame_source_detection(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    assert isinstance(tio.open_frame_source(str(empty)), tio.FrameStore)
    tio.FrameStore(str(tmp_path / "gsf")).save(
        0, np.ones((4, 5), np.float32), np.ones((4, 5), np.float32))
    assert isinstance(tio.open_frame_source(str(tmp_path / "gsf")),
                      tio.FrameStore)


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    """A four-frame TUM sequence with timestamp jitter, an unmatchable depth
    entry and a ground truth (``tests/test_tum.py``'s layout)."""
    Image = _pil_image()
    root = tmp_path_factory.mktemp("tum")
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    r = np.random.default_rng(0)
    rgb_lines, dep_lines = ["# color"], ["# depth"]
    for k in range(4):
        t = 10.0 + 0.1 * k
        Image.fromarray(r.integers(0, 255, (24, 32, 3), dtype=np.uint8)) \
            .save(root / "rgb" / f"{t:.6f}.png")
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        td = t + 0.008
        Image.fromarray(np.full((24, 32), 5000 + 100 * k, np.uint16)) \
            .save(root / "depth" / f"{td:.6f}.png")
        dep_lines.append(f"{td:.6f} depth/{td:.6f}.png")
    Image.fromarray(np.full((24, 32), 5000, np.uint16)).save(
        root / "depth" / "99.000000.png")
    dep_lines.append("99.000000 depth/99.000000.png")
    (root / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text("\n".join(dep_lines) + "\n")
    (root / "groundtruth.txt").write_text(
        "# gt\n10.0 1.0 2.0 3.0 0.0 0.0 0.0 1.0\n"
        "10.1 1.1 2.0 3.0 0.0 0.0 0.7071 0.7071\n10.2 1.0 2.0\n")
    return root


def test_tum_equal(tum_dir):
    d = str(tum_dir)
    assert tum.is_tum_dir(d) and not tum.is_tum_dir(str(tum_dir / "rgb"))
    src, jsrc = tio.open_frame_source(d), jio.open_frame_source(d)
    assert isinstance(src, tum.TumDataset) and len(src) == len(jsrc) == 4
    np.testing.assert_array_equal(src.timestamps, jsrc.timestamps)
    for seq in (-1, 0, 3, 4):
        got, want = src(seq), jsrc(seq)
        if want is None:
            assert got is None
            continue
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    gt = str(tum_dir / "groundtruth.txt")
    a, b = tum.read_tum_groundtruth(gt), jio.read_tum_groundtruth(gt)
    for f in ("ids", "t", "quat", "seq"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    q = np.array([9.99, 10.005, 10.09, 10.5])
    for g, w in zip(tum.groundtruth_at(gt, q), jio.groundtruth_at(gt, q)):
        np.testing.assert_array_equal(g, w)


def test_associate_timestamps_equal():
    r = np.random.default_rng(4)
    for n_a, n_b in ((0, 5), (40, 37), (200, 220)):
        a = np.sort(r.uniform(0, 5, n_a))
        b = r.uniform(0, 5, n_b)
        for max_dt in (0.005, 0.02):
            for g, w in zip(tum.associate_timestamps(a, b, max_dt),
                            jio.associate_timestamps(a, b, max_dt)):
                np.testing.assert_array_equal(g, w)


# -- the native runtime ---------------------------------------------------------------

def test_native_builds_into_the_package():
    assert native.available() and jnative.available()
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path).endswith(os.path.join(
        "graph_slam_tpu_torch", "_build"))


def _vro_rows(n=50, seed=0):
    r = np.random.default_rng(seed)
    rows = r.normal(size=(n, 29))
    rows[:, 0] = np.arange(1, n + 1)
    rows[:, 1] = np.arange(n)
    return rows


def test_native_vro_log_equal(tmp_path, monkeypatch):
    rows = _vro_rows()
    path = str(tmp_path / "t.log")
    assert native.write_vro_log(path, rows)
    assert jnative.write_vro_log(str(tmp_path / "j.log"), rows)
    assert open(path).read() == open(tmp_path / "j.log").read()
    got = native.parse_vro_log(path)
    np.testing.assert_array_equal(got, jnative.parse_vro_log(path))
    np.testing.assert_array_equal(got[:, 2:], rows[:, 2:])
    # read_vro_log: the native path and the numpy fallback give one log
    log = tio.read_vro_log(path)
    jlog = jio.read_vro_log(path)
    monkeypatch.setattr(native, "_LIB", False)
    assert native.parse_vro_log(path) is None
    fb = tio.read_vro_log(path)
    for f in ("id_to", "id_from", "xi", "info"):
        np.testing.assert_array_equal(getattr(log, f), getattr(fb, f))
        np.testing.assert_array_equal(getattr(log, f), getattr(jlog, f))
    empty = tmp_path / "empty.log"
    empty.write_text("")
    assert len(tio.read_vro_log(str(empty))) == 0


def test_native_table_and_trajectory_equal(tmp_path, monkeypatch):
    path = tmp_path / "traj.log"
    r = np.random.default_rng(1)
    t = r.normal(size=(30, 3))
    q = r.normal(size=(30, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tio.write_trajectory(str(path), np.arange(30), t, q, np.arange(30) * 2)
    with open(path, "a") as f:
        f.write("# a comment\n1 2 3\n")
    got = native.parse_table(str(path), 9)
    np.testing.assert_array_equal(got, jnative.parse_table(str(path), 9))
    assert got.shape == (30, 9)
    tr = tio.read_trajectory(str(path))
    jtr = jio.read_trajectory(str(path))
    monkeypatch.setattr(native, "_LIB", False)
    fb = tio.read_trajectory(str(path))
    for f in ("ids", "t", "quat", "seq"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(fb, f))
        np.testing.assert_array_equal(getattr(tr, f), getattr(jtr, f))
    np.testing.assert_array_equal(tr.t, t)


def test_native_cloud_writer_equal(tmp_path, monkeypatch):
    r = np.random.default_rng(2)
    pts = r.normal(size=(200, 3))
    cols = r.integers(0, 256, (200, 3)).astype(np.uint8)
    for mode, c in ((0, None), (1, cols), (2, cols)):
        t_path, j_path = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
        assert native.write_cloud_ascii(t_path, "head\n", pts, c, mode)
        assert jnative.write_cloud_ascii(j_path, "head\n", pts, c, mode)
        assert open(t_path).read() == open(j_path).read()
    tio.write_ply_points(str(tmp_path / "n.ply"), pts, cols)
    jio.write_ply_points(str(tmp_path / "jn.ply"), pts, cols)
    assert (tmp_path / "n.ply").read_bytes() == \
        (tmp_path / "jn.ply").read_bytes()
    monkeypatch.setattr(native, "_LIB", False)
    assert not native.write_cloud_ascii(t_path, "", pts, None, 0)
    p32 = pts.astype(np.float32)
    tio.write_ply_points(str(tmp_path / "f.ply"), p32, cols)
    native_rows = np.loadtxt(tmp_path / "n.ply", skiprows=10)
    fb_rows = np.loadtxt(tmp_path / "f.ply", skiprows=10)
    np.testing.assert_array_equal(fb_rows[:, :3], p32)
    np.testing.assert_allclose(native_rows[:, :3], fb_rows[:, :3], rtol=1e-7)
    np.testing.assert_array_equal(native_rows[:, 3:], fb_rows[:, 3:])


def test_native_frames_equal(tmp_path, monkeypatch):
    r = np.random.default_rng(3)
    img = r.integers(0, 65535, (12, 16)).astype("<u2")
    raw = tmp_path / "raw.u16"
    raw.write_bytes(img.tobytes())
    np.testing.assert_array_equal(native.read_frame_u16(str(raw), 16, 12),
                                  img)
    np.testing.assert_array_equal(jnative.read_frame_u16(str(raw), 16, 12),
                                  img)
    assert native.read_frame_u16(str(raw), 16, 13) is None
    store = tio.FrameStore(str(tmp_path / "gsf"))
    for s in range(5):
        store.save(s, r.uniform(0, 255, (12, 16)).astype(np.float32),
                   r.uniform(0.1, 5, (12, 16)).astype(np.float32))
    paths = [store.path(s) for s in range(5)]
    words = 8 + 2 * 12 * 16
    got = native.read_frames_u16(paths, words, 1, n_threads=3)
    np.testing.assert_array_equal(got,
                                  jnative.read_frames_u16(paths, words, 1))
    assert native.read_frames_u16(paths + [paths[0] + "x"], words, 1) is None
    batch = store.load_batch(range(5), 16, 12)
    jbatch = jio.FrameStore(str(tmp_path / "gsf")).load_batch(range(5), 16,
                                                               12)
    monkeypatch.setattr(native, "_LIB", False)
    fb = store.load_batch(range(5), 16, 12)
    for a, b, c in zip(batch, fb, jbatch):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for s in range(5):
        np.testing.assert_array_equal(fb[0][s], store(s)[0])


@pytest.mark.parametrize("kind", ["vn100", "mems"])
def test_native_imu_logs_equal(tmp_path, monkeypatch, kind):
    r = np.random.default_rng(5)
    path = str(tmp_path / f"{kind}.log")
    if kind == "vn100":
        t = np.arange(300) * 0.005
        np.savetxt(path, np.column_stack([t, r.normal(size=(300, 9))]))
        read, jread = streams.read_vn100_log, jstreams.read_vn100_log
    else:
        fid = np.concatenate([np.arange(200, 256), np.arange(0, 144)])
        np.savetxt(path, np.column_stack(
            [fid, r.integers(-3000, 3000, (200, 6))]), fmt="%d")
        read, jread = streams.read_mems_log, jstreams.read_mems_log
    got, want = read(path), jread(path)
    monkeypatch.setattr(native, "_LIB", False)
    fb = read(path)
    for f in ("t", "acc", "gyr", "rpy", "start", "dt"):
        a, b, c = getattr(got, f), getattr(fb, f), getattr(want, f)
        if a is None:
            assert b is None and c is None
            continue
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


# -- presets ------------------------------------------------------------------------

def test_presets_equal_to_jax():
    names = config.preset_names()
    assert names == jconfig.preset_names() and len(names) == 26
    for name in names:
        with open(config.preset_path(name), "rb") as f:
            got = f.read()
        with open(jconfig.preset_path(name), "rb") as f:
            want = f.read()
        src = json.loads(got)["source"]
        jsrc = json.loads(want)["source"]
        assert src.startswith("launch/") and jsrc.endswith("/" + src)
        assert got == want.replace(jsrc.encode(), src.encode())
        assert config.load_config_dict(name)["source"] == src
        assert config.load_params(name) == \
            config.SlamParams(**vars(jconfig.load_params(name)))


def test_preset_args_are_port_flags():
    _, sub = cli.build_parser()
    for name in config.preset_names():
        preset = config.load_config_dict(name)
        tool = preset.get("tool")
        if tool is None:
            continue
        assert tool in sub.choices, (name, tool)
        dests = {a.dest for a in sub.choices[tool]._actions}
        for key in preset.get("args", {}):
            assert key.replace("-", "_") in dests, (name, key)


def test_preset_loading_paths_and_errors(tmp_path):
    p = tmp_path / "mine.json"
    config.save_params(str(p), config.SlamParams(lookback_nodes=3,
                                                 robust="huber"))
    assert config.load_params(str(p)) == \
        config.SlamParams(lookback_nodes=3, robust="huber")
    jconfig.save_params(str(tmp_path / "j.json"),
                        jconfig.SlamParams(lookback_nodes=3, robust="huber"))
    assert p.read_text() == (tmp_path / "j.json").read_text()
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"lookback_nodes": 2, "nonsense": 1}))
    with pytest.raises(ValueError, match="nonsense"):
        config.load_params(str(bad))
    with pytest.raises(FileNotFoundError, match="available: ba_two_frames"):
        config.load_config_dict("no_such_preset")
