"""Headless point-cloud publisher: the ``pub_pcd`` role without ROS — a
copy of ``graph_slam_tpu/mapping/publish.py`` (numpy and sockets).

The reference's ``mapping/pub_pcd.cpp:18-62`` loads a PCD, converts it to
a ``sensor_msgs/PointCloud2`` and republishes it at 1 Hz on the ``pc_map``
topic until shutdown. This module plays the same role headlessly:

- :func:`encode_pointcloud2` / :func:`decode_pointcloud2` pack a point
  cloud into the PointCloud2 *data layout* (PCL ``PointXYZRGB`` packing:
  little-endian ``x y z`` FLOAT32 at offsets 0/4/8, packed ``rgb`` UINT32
  at offset 12, ``point_step=16``, ``height=1``, row-major data blob —
  ``pcl_conversions::toROSMsg`` of ``pub_pcd.cpp:44-46``) behind a small
  self-describing JSON header, so any consumer can reconstruct the exact
  ROS message fields.
- :func:`serve_pointcloud` republishes the encoded message to every
  connected TCP subscriber at a fixed rate (the ``ros::Rate loop_rate(1.)``
  publish loop, ``pub_pcd.cpp:52-59``).
- :func:`read_published` is the matching subscriber.

Transport is length-prefixed frames over TCP on localhost by default —
the moral equivalent of a latched ROS topic for a framework with no ROS
dependency. Nothing here touches the device: publishing is pure IO.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time

import numpy as np

__all__ = ["encode_pointcloud2", "decode_pointcloud2", "serve_pointcloud",
           "read_published", "publish_pcd"]

_MAGIC = b"GSPC"

# sensor_msgs/PointField datatype codes (the subset PCL XYZRGB uses)
_FLOAT32 = 7
_UINT32 = 6


def encode_pointcloud2(points, colors=None, frame_id: str = "map",
                       stamp: float = 0.0) -> bytes:
    """Pack a cloud as a PointCloud2-layout message (pub_pcd.cpp:44-46).

    Returns ``GSPC`` + u32 header length + JSON header + raw data blob.
    The JSON header carries the PointCloud2 metadata (frame_id, stamp,
    width/height, fields with name/offset/datatype/count, is_bigendian,
    point_step, row_step, is_dense) and the blob is the ROS ``data``
    array byte-for-byte.
    """
    pts = np.ascontiguousarray(np.asarray(points, np.float32))
    n = len(pts)
    if colors is not None:
        cols = np.asarray(colors).astype(np.uint32)
        rgb = (cols[:, 0] << 16) | (cols[:, 1] << 8) | cols[:, 2]
        data = np.empty((n, 4), np.uint32)
        data[:, :3] = pts.view(np.uint32).reshape(n, 3)
        data[:, 3] = rgb
        fields = [{"name": "x", "offset": 0, "datatype": _FLOAT32,
                   "count": 1},
                  {"name": "y", "offset": 4, "datatype": _FLOAT32,
                   "count": 1},
                  {"name": "z", "offset": 8, "datatype": _FLOAT32,
                   "count": 1},
                  {"name": "rgb", "offset": 12, "datatype": _UINT32,
                   "count": 1}]
        step = 16
    else:
        data = pts
        fields = [{"name": "x", "offset": 0, "datatype": _FLOAT32,
                   "count": 1},
                  {"name": "y", "offset": 4, "datatype": _FLOAT32,
                   "count": 1},
                  {"name": "z", "offset": 8, "datatype": _FLOAT32,
                   "count": 1}]
        step = 12
    blob = data.tobytes()
    header = json.dumps({
        "frame_id": frame_id, "stamp": stamp,
        "height": 1, "width": n, "fields": fields,
        "is_bigendian": False, "point_step": step,
        "row_step": step * n, "is_dense": True,
    }).encode()
    return _MAGIC + struct.pack("<I", len(header)) + header + blob


def decode_pointcloud2(buf: bytes):
    """Inverse of :func:`encode_pointcloud2`.

    Returns ``(points (N,3) f32, colors (N,3) u8 | None, header dict)``.
    """
    if buf[:4] != _MAGIC:
        raise ValueError("not a GSPC point-cloud message")
    (hlen,) = struct.unpack_from("<I", buf, 4)
    header = json.loads(buf[8:8 + hlen].decode())
    blob = buf[8 + hlen:]
    n = header["width"] * header["height"]
    step = header["point_step"]
    raw = np.frombuffer(blob, np.uint8)[:n * step].reshape(n, step)
    offs = {f["name"]: f["offset"] for f in header["fields"]}
    pts = np.stack([raw[:, offs[k]:offs[k] + 4].copy().view(np.float32)[:, 0]
                    for k in ("x", "y", "z")], axis=1)
    colors = None
    if "rgb" in offs:
        o = offs["rgb"]
        rgb = raw[:, o:o + 4].copy().view(np.uint32)[:, 0]
        colors = np.stack([(rgb >> 16) & 255, (rgb >> 8) & 255, rgb & 255],
                          axis=1).astype(np.uint8)
    return pts, colors, header


def serve_pointcloud(points, colors=None, host: str = "127.0.0.1",
                     port: int = 0, rate_hz: float = 1.0,
                     max_cycles: int | None = None,
                     frame_id: str = "map",
                     ready: "threading.Event | None" = None,
                     stop: "threading.Event | None" = None,
                     port_out: list | None = None) -> int:
    """Publish loop (pub_pcd.cpp:52-59): send the encoded cloud to every
    connected subscriber once per ``1/rate_hz`` seconds.

    Blocks until ``max_cycles`` publishes have happened (or ``stop`` is
    set); returns the bound port (useful with ``port=0``). The bound port
    is appended to ``port_out`` (if given) before ``ready`` is set, so a
    thread running the loop can hand the ephemeral port to a subscriber.
    Subscribers may connect and disconnect at any time; each frame is
    length-prefixed with a u32 so readers can stream.
    """
    period = 1.0 / max(rate_hz, 1e-6)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(8)
    srv.settimeout(0.05)
    bound = srv.getsockname()[1]
    if port_out is not None:
        port_out.append(bound)
    if ready is not None:
        ready.set()
    # Non-blocking sends with a per-subscriber byte queue: a stalled
    # subscriber cannot head-of-line-block the publish loop for the
    # others. A subscriber whose backlog exceeds MAX_BACKLOG_FRAMES
    # unsent frames is dropped.
    MAX_BACKLOG_FRAMES = 4
    subs: dict = {}               # socket -> bytearray (unsent backlog)
    cycles = 0
    next_pub = time.monotonic()

    def _flush(frame_len: int) -> None:
        for s in list(subs):
            q = subs[s]
            if not q:
                continue
            if frame_len and len(q) > MAX_BACKLOG_FRAMES * frame_len:
                s.close()
                del subs[s]
                continue
            try:
                sent = s.send(q)    # bytearray rides the buffer protocol
                del q[:sent]
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                s.close()
                del subs[s]

    frame_len = 0
    try:
        while (max_cycles is None or cycles < max_cycles) and (
                stop is None or not stop.is_set()):
            try:
                conn, _ = srv.accept()
                conn.setblocking(False)
                subs[conn] = bytearray()
            except socket.timeout:
                pass
            now = time.monotonic()
            if now < next_pub:
                _flush(frame_len)  # drain partial sends between publishes
                continue
            next_pub = now + period
            msg = encode_pointcloud2(points, colors, frame_id=frame_id,
                                     stamp=time.time())
            framed = struct.pack("<I", len(msg)) + msg
            frame_len = len(framed)
            for q in subs.values():
                q += framed
            _flush(frame_len)
            cycles += 1
    finally:
        # bounded drain so an exiting loop does not truncate the final
        # frame(s) still queued for live-but-slow subscribers; a
        # stop-triggered shutdown returns promptly instead
        if stop is None or not stop.is_set():
            deadline = time.monotonic() + 5.0
            while any(subs.values()) and time.monotonic() < deadline:
                _flush(frame_len)
                if any(subs.values()):
                    time.sleep(0.02)
        for s in subs:
            s.close()
        srv.close()
    return bound


def read_published(host: str, port: int, n_messages: int = 1,
                   timeout: float = 10.0):
    """Subscribe and read ``n_messages`` frames; returns the decoded list
    of ``(points, colors, header)`` tuples."""
    out = []
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.settimeout(timeout)
        buf = b""

        def read_exact(k):
            nonlocal buf
            while len(buf) < k:
                chunk = s.recv(65536)
                if not chunk:
                    raise ConnectionError("publisher closed")
                buf += chunk
            out, buf2 = buf[:k], buf[k:]
            buf = buf2
            return out

        for _ in range(n_messages):
            (mlen,) = struct.unpack("<I", read_exact(4))
            out.append(decode_pointcloud2(read_exact(mlen)))
    return out


def publish_pcd(pcd_path: str, host: str = "127.0.0.1", port: int = 7100,
                rate_hz: float = 1.0, max_cycles: int | None = None,
                frame_id: str = "map",
                ready: "threading.Event | None" = None,
                port_out: list | None = None) -> int:
    """The ``pub_pcd`` executable: load a PCD and republish it
    (mapping/pub_pcd.cpp:33-62). Returns the bound port."""
    from .pointcloud import read_pcd

    points, colors = read_pcd(pcd_path)
    return serve_pointcloud(points, colors, host=host, port=port,
                            rate_hz=rate_hz, max_cycles=max_cycles,
                            frame_id=frame_id, ready=ready,
                            port_out=port_out)
