"""Streaming SLAM service: RGB-D frames in over TCP, poses out (port of
``graph_slam_tpu/serving.py``; the wire protocol is the same, so a client
of either package talks to a server of the other).

The reference's online drivers are ROS nodes fed by a live camera
(``test_gt_graph.cpp:38-130`` reading SR4000 frames in a loop, the g2o
twin, and ``main_rgbdslam_offline.cpp`` for RealSense). This module plays
that role headlessly: a TCP server drives ``OnlineSlam`` — feature
frontend, keyframe gates, fake odometry on failure, vmapped loop
closures, periodic batch optimize — one message per frame, answering
each with the frame's status and the current pose estimate.

Wire protocol (shared framing with ``mapping.publish``): every message is
``u32 total_len | u32 header_len | header JSON | payload bytes``.

Client -> server messages:
- ``{"type": "frame", "seq": int}`` with a ``.gsf`` image as payload
  (``io.frames.encode_frame``) — process one RGB-D frame;
- ``{"type": "end"}`` — final batch optimize; server replies with a
  summary (chi2, keyframe count, full trajectory) and closes.

Server -> client replies (JSON, empty payload):
- per frame: ``{"type": "pose", "seq", "status", "keyframes", "t", "q"}``
  (pose = the CURRENT estimate of the latest keyframe, world frame);
- final: ``{"type": "summary", "chi2", "keyframes", "ids", "t", "q"}``.

One client at a time (the reference's mains are single-camera loops); the
estimator state persists across connections, so a dropped client can
reconnect and continue the same session. The estimator runs on
``device`` (``None``: the CUDA card); each reply reads its pose back in
one copy.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Optional

import numpy as np

from .config import CameraIntrinsics, SlamParams
from .core import so3
from .device import to_host
from .io.frames import decode_frame
from .pipelines.online_slam import OnlineSlam

__all__ = ["serve_slam", "SlamClient", "send_msg", "recv_msg"]

_U32 = struct.Struct("<I")


def send_msg(sock: socket.socket, header: dict, payload: bytes = b""):
    hdr = json.dumps(header).encode()
    body = _U32.pack(len(hdr)) + hdr + payload
    sock.sendall(_U32.pack(len(body)) + body)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def recv_msg(sock: socket.socket):
    (total,) = _U32.unpack(_read_exact(sock, 4))
    body = _read_exact(sock, total)
    (hlen,) = _U32.unpack(body[:4])
    header = json.loads(body[4:4 + hlen].decode())
    return header, body[4 + hlen:]


def _pose_reply(slam: OnlineSlam, seq: int, status: str) -> dict:
    gi = len(slam.frames) - 1
    pose = slam.og.pose(gi)
    t, q = to_host((pose.t, so3.matrix_to_quat(pose.R[None])[0]))
    return {"type": "pose", "seq": seq, "status": status,
            "keyframes": slam.num_keyframes,
            "t": t.tolist(), "q": q.tolist()}


def serve_slam(cam: CameraIntrinsics, params: Optional[SlamParams] = None,
               host: str = "127.0.0.1", port: int = 0,
               ready=None, port_out: Optional[list] = None,
               max_messages: Optional[int] = None,
               slam_kwargs: Optional[dict] = None,
               on_bound=None, *, device=None) -> int:
    """Run the SLAM service until an ``end`` message (or ``max_messages``).

    Returns the bound port (appended to ``port_out`` before ``ready`` is
    set, so a thread can hand an ephemeral port to its client;
    ``on_bound(port)`` is called at the same moment — the single-threaded
    way to learn an ephemeral port, e.g. the CLI's startup print).
    The session's ``OnlineSlam`` runs on ``device`` (``None``: the card).
    """
    slam = OnlineSlam(cam=cam, params=params or SlamParams(),
                      device=device, **(slam_kwargs or {}))
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(1)
    bound = srv.getsockname()[1]
    if port_out is not None:
        port_out.append(bound)
    if on_bound is not None:
        on_bound(bound)
    if ready is not None:
        ready.set()

    def _reply(conn, header_dict) -> bool:
        """Send a reply; a client that vanished mid-reply is not fatal
        (the estimator session persists across reconnects)."""
        try:
            send_msg(conn, header_dict)
            return True
        except OSError:
            return False

    n_msgs = 0
    done = False
    try:
        while not done and (max_messages is None or n_msgs < max_messages):
            conn, _ = srv.accept()
            try:
                while max_messages is None or n_msgs < max_messages:
                    try:
                        header, payload = recv_msg(conn)
                    except (struct.error, ValueError, OSError):
                        break           # client gone/garbled; await a
                        #                 reconnect — estimator state lives
                    n_msgs += 1
                    if header.get("type") == "frame":
                        # a malformed message must not kill the session:
                        # reply with an error and keep serving
                        try:
                            inten, depth = decode_frame(payload)
                            seq = int(header["seq"])
                        except (KeyError, ValueError, TypeError,
                                struct.error) as e:
                            if not _reply(conn, {"type": "error",
                                                 "error": f"bad frame: {e}"}):
                                break
                            continue
                        try:
                            status = slam.process_frame(inten, depth,
                                                        seq_id=seq)
                        except (ValueError, TypeError) as e:
                            # decodable but degenerate (e.g. tiny dims the
                            # feature frontend rejects): error reply, the
                            # session stays alive
                            if not _reply(conn, {"type": "error",
                                                 "error": f"bad frame: {e}"}):
                                break
                            continue
                        if not _reply(conn, _pose_reply(slam, seq, status)):
                            break
                    elif header.get("type") == "end":
                        chi2 = slam.optimize()
                        ids, t, q, seq = slam.trajectory()
                        # only finish if the summary actually landed: a
                        # client that drops right before its result can
                        # reconnect and re-request 'end'
                        done = _reply(conn, {
                            "type": "summary", "chi2": float(chi2),
                            "keyframes": slam.num_keyframes,
                            "ids": np.asarray(ids).tolist(),
                            "seq": np.asarray(seq).tolist(),
                            "t": np.asarray(t).tolist(),
                            "q": np.asarray(q).tolist()})
                        if done:
                            break
                    else:
                        if not _reply(conn, {"type": "error",
                                             "error": "unknown message "
                                                      "type"}):
                            break
            finally:
                conn.close()
    finally:
        srv.close()
    return bound


class SlamClient:
    """Convenience client for the streaming service."""

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(timeout)

    def send_frame(self, seq: int, intensity, depth_m) -> dict:
        from .io.frames import encode_frame

        send_msg(self.sock, {"type": "frame", "seq": int(seq)},
                 encode_frame(intensity, depth_m))
        header, _ = recv_msg(self.sock)
        return header

    def finish(self) -> dict:
        send_msg(self.sock, {"type": "end"})
        header, _ = recv_msg(self.sock)
        self.sock.close()
        return header
