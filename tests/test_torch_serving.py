"""The port's SLAM service (``graph_slam_tpu_torch.serving``) and point-cloud
publisher (``mapping.publish``) against the JAX package, on the CPU.

A live server in a thread (``serve_slam(device="cpu")``) takes the SR4000
wall frames of ``tests/test_serving.py`` over loopback. What goes over the
wire is ``.gsf`` bytes, so the server's session sees the decoded frames:
it is held to an in-process ``OnlineSlam`` of the port fed those decoded
frames (statuses equal, poses within 1e-9 m) and to the JAX package's
``OnlineSlam`` on them (statuses equal, trajectory within 1e-6 m: the
RANSAC draws differ between the packages, but on exact frames the
consensus sets do not). The JAX package's
client drives one of the sessions, so the two packages share a protocol.

Tolerances otherwise: frame and point-cloud bytes equal.
"""

import socket
import threading

import numpy as np
import pytest

from test_pipelines2 import render_wall_frame

from graph_slam_tpu.config import SR4000 as JSR4000
from graph_slam_tpu.config import SlamParams as JSlamParams
from graph_slam_tpu.io import frames as jframes
from graph_slam_tpu.mapping import publish as jpublish
from graph_slam_tpu.pipelines import OnlineSlam as JOnlineSlam
from graph_slam_tpu.serving import SlamClient as JSlamClient
from graph_slam_tpu_torch.config import SR4000, SlamParams
from graph_slam_tpu_torch.io.frames import decode_frame, encode_frame
from graph_slam_tpu_torch.mapping import publish
from graph_slam_tpu_torch.pipelines import OnlineSlam
from graph_slam_tpu_torch.serving import (SlamClient, recv_msg, send_msg,
                                          serve_slam)

XS = [0.0, 0.12, 0.24, 0.36]
SLAM_KW = dict(n_hyp=512, min_inliers=10)


def _frames():
    return [render_wall_frame(SR4000, np.array([x, 0.0, 0.0])) for x in XS]


def _server(**kw):
    """A port server on an ephemeral port in a daemon thread: (thread,
    port)."""
    ready = threading.Event()
    ports = []
    th = threading.Thread(
        target=serve_slam, args=(SR4000, SlamParams(optimize_step=100)),
        kwargs=dict(port=0, ready=ready, port_out=ports, slam_kwargs=SLAM_KW,
                    device="cpu", **kw), daemon=True)
    th.start()
    assert ready.wait(30)
    return th, ports[0]


@pytest.fixture(scope="module")
def in_process():
    """The port's and the JAX package's sessions on the decoded frames:
    (port statuses, port trajectory t, JAX statuses, JAX trajectory t)."""
    ts = OnlineSlam(cam=SR4000, params=SlamParams(optimize_step=100),
                    device="cpu", **SLAM_KW)
    js = JOnlineSlam(cam=JSR4000, params=JSlamParams(optimize_step=100),
                     **SLAM_KW)
    st, sj, poses = [], [], []
    for seq, (img, depth) in enumerate(_frames()):
        frame = decode_frame(encode_frame(img, depth))
        st.append(ts.process_frame(*frame, seq_id=seq))
        sj.append(js.process_frame(*frame, seq_id=seq))
        poses.append(ts.og.pose(len(ts.frames) - 1).t.numpy().copy())
    chi2 = ts.optimize()
    js.optimize()
    return st, np.stack(poses), chi2, ts.trajectory(), sj, js.trajectory()


def test_frame_bytes_round_trip_equal():
    img, depth = render_wall_frame(SR4000, np.zeros(3))
    blob = encode_frame(img, depth)
    assert blob == jframes.encode_frame(img, depth)
    assert encode_frame(img, depth, 250) == \
        jframes.encode_frame(img, depth, 250)
    i2, d2 = decode_frame(blob)
    ji, jd = jframes.decode_frame(blob)
    np.testing.assert_array_equal(i2, ji)
    np.testing.assert_array_equal(d2, jd)
    np.testing.assert_allclose(i2, np.round(img), atol=1.0)
    np.testing.assert_allclose(d2, depth, atol=1e-3)


@pytest.mark.parametrize("client", ["port", "jax"])
def test_serve_slam_end_to_end(in_process, client):
    st, poses, chi2, (ids, t, q, seqs), sj, (_, tj, _, _) = in_process
    th, port = _server()
    make = SlamClient if client == "port" else JSlamClient
    c = make("127.0.0.1", port, timeout=300.0)
    statuses = []
    for seq, (img, depth) in enumerate(_frames()):
        rep = c.send_frame(seq, img, depth)
        assert rep["type"] == "pose" and rep["seq"] == seq
        assert rep["keyframes"] == seq + 1
        statuses.append(rep["status"])
        np.testing.assert_allclose(rep["t"], poses[seq], rtol=0, atol=1e-9)
    assert statuses == st == sj == ["first"] + ["keyframe"] * 3
    summary = c.finish()
    th.join(timeout=120)
    assert not th.is_alive()
    assert summary["type"] == "summary" and summary["keyframes"] == 4
    np.testing.assert_allclose(summary["chi2"], chi2, rtol=1e-9)
    np.testing.assert_array_equal(summary["ids"], ids)
    np.testing.assert_array_equal(summary["seq"], seqs)
    np.testing.assert_allclose(summary["t"], t, rtol=0, atol=1e-9)
    np.testing.assert_allclose(summary["q"], q, rtol=0, atol=1e-9)
    np.testing.assert_allclose(summary["t"], np.asarray(tj), rtol=0,
                               atol=1e-6)
    for k, x in enumerate(XS):
        assert abs(summary["t"][k][0] - x) < 0.05


def test_session_survives_reconnect_and_garbage(in_process):
    _, _, _, (_, t, _, _), _, _ = in_process
    th, port = _server()
    frames = _frames()
    c1 = SlamClient("127.0.0.1", port, timeout=300.0)
    for seq in (0, 1):
        assert c1.send_frame(seq, *frames[seq])["type"] == "pose"
    c1.sock.close()                      # client drops mid-session

    c2 = SlamClient("127.0.0.1", port, timeout=300.0)
    send_msg(c2.sock, {"type": "frame", "seq": 99}, b"garbage")
    rep, _ = recv_msg(c2.sock)
    assert rep["type"] == "error" and "bad frame" in rep["error"]
    send_msg(c2.sock, {"type": "frame"}, encode_frame(*frames[2]))
    rep, _ = recv_msg(c2.sock)
    assert rep["type"] == "error"        # no seq
    send_msg(c2.sock, {"type": "ping"})
    rep, _ = recv_msg(c2.sock)
    assert rep == {"type": "error", "error": "unknown message type"}
    for seq in (2, 3):
        assert c2.send_frame(seq, *frames[seq])["type"] == "pose"
    summary = c2.finish()
    th.join(timeout=120)
    assert summary["keyframes"] == 4     # both connections' frames
    np.testing.assert_allclose(summary["t"], t, rtol=0, atol=1e-9)


def test_max_messages_and_on_bound():
    bound = []
    th, port = _server(max_messages=1, on_bound=bound.append)
    assert bound == [port]
    c = SlamClient("127.0.0.1", port, timeout=300.0)
    assert c.send_frame(0, *_frames()[0])["status"] == "first"
    th.join(timeout=120)
    assert not th.is_alive()


def test_serve_slam_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve_slam(SR4000, port=0)


# -- the point-cloud publisher ---------------------------------------------------

def _cloud(n=300, seed=0):
    r = np.random.default_rng(seed)
    return r.normal(size=(n, 3)), r.integers(0, 256, (n, 3)).astype(np.uint8)


@pytest.mark.parametrize("with_colors", [True, False])
def test_pointcloud2_bytes_equal(with_colors):
    pts, cols = _cloud()
    cols = cols if with_colors else None
    msg = publish.encode_pointcloud2(pts, cols, frame_id="odom", stamp=12.5)
    assert msg == jpublish.encode_pointcloud2(pts, cols, frame_id="odom",
                                              stamp=12.5)
    p, c, header = publish.decode_pointcloud2(msg)
    jp, jc, jheader = jpublish.decode_pointcloud2(msg)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(p, pts.astype(np.float32))
    assert header == jheader
    assert header["point_step"] == (16 if with_colors else 12)
    if with_colors:
        np.testing.assert_array_equal(c, cols)
        np.testing.assert_array_equal(c, jc)
    else:
        assert c is None and jc is None
    with pytest.raises(ValueError, match="not a GSPC"):
        publish.decode_pointcloud2(b"XXXX" + msg[4:])


def test_publish_and_read_round_trip(tmp_path):
    pts, cols = _cloud(500, seed=1)
    pcd = str(tmp_path / "map.pcd")
    from graph_slam_tpu_torch.mapping import read_pcd, write_pcd

    write_pcd(pcd, pts, cols)
    want, want_c = read_pcd(pcd)
    ready = threading.Event()
    ports = []
    th = threading.Thread(target=publish.publish_pcd, args=(pcd,),
                          kwargs=dict(port=0, rate_hz=50.0, max_cycles=30,
                                      ready=ready, port_out=ports),
                          daemon=True)
    th.start()
    assert ready.wait(30)
    got = publish.read_published("127.0.0.1", ports[0], n_messages=2)
    jgot = jpublish.read_published("127.0.0.1", ports[0], n_messages=1)
    th.join(timeout=30)
    assert not th.is_alive()
    for p, c, header in got + jgot:
        np.testing.assert_array_equal(p, want.astype(np.float32))
        np.testing.assert_array_equal(c, want_c)
        assert header["frame_id"] == "map" and header["width"] == 500


def test_serve_pointcloud_stops_on_event():
    pts, cols = _cloud(50)
    stop = threading.Event()
    ports = []
    ready = threading.Event()
    th = threading.Thread(target=publish.serve_pointcloud, args=(pts, cols),
                          kwargs=dict(port=0, rate_hz=100.0, stop=stop,
                                      ready=ready, port_out=ports),
                          daemon=True)
    th.start()
    assert ready.wait(30)
    (p, _, _), = publish.read_published("127.0.0.1", ports[0])
    np.testing.assert_array_equal(p, pts.astype(np.float32))
    stop.set()
    th.join(timeout=30)
    assert not th.is_alive()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", ports[0]), timeout=1).close()
