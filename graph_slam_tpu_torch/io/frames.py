"""RGB-D frame storage: binary intensity+depth files + batch loading — a
copy of ``graph_slam_tpu/io/frames.py`` (numpy only; copied, not
imported, because importing any ``graph_slam_tpu`` module imports jax).

Plays the role of the external camera readers the reference links against
(``SR_reader_cv.h`` for SR4000 ``.bdat`` files, ``rs_r200_wrapper.h`` for
RealSense — SURVEY.md §0): a simple documented binary format plus a batch
loader, ``load_batch``, which reads through the native runtime's threaded
loader (``native.read_frames_u16``) when it is built and file by file with
numpy otherwise.

Format (``.gsf``, graph-slam frame): little-endian, a 16-byte header
``GSF1`` + u32 width + u32 height + u32 depth_scale_um, followed by
h*w u16 intensity then h*w u16 depth (raw units; meters = raw *
depth_scale_um * 1e-6).
"""

from __future__ import annotations

import os
import struct

import numpy as np

__all__ = ["encode_frame", "decode_frame", "save_frame", "load_frame",
           "FrameStore"]

_MAGIC = b"GSF1"
_HDR = struct.Struct("<4sIII")


def encode_frame(intensity, depth_m, depth_scale_um: int = 1000) -> bytes:
    """Serialize a frame to .gsf bytes (also the wire format of the
    streaming SLAM service); depth given in meters, stored u16 raw."""
    inten = np.asarray(intensity)
    h, w = inten.shape
    raw_i = np.clip(np.asarray(inten), 0, 65535).astype("<u2")
    raw_d = np.clip(np.asarray(depth_m) / (depth_scale_um * 1e-6),
                    0, 65535).astype("<u2")
    return (_HDR.pack(_MAGIC, w, h, depth_scale_um)
            + raw_i.tobytes() + raw_d.tobytes())


def decode_frame(blob: bytes):
    """Parse .gsf bytes -> (intensity f32, depth_m f32)."""
    magic, w, h, scale_um = _HDR.unpack(blob[:_HDR.size])
    if magic != _MAGIC:
        raise ValueError("not a GSF frame")
    data = np.frombuffer(blob, dtype="<u2",
                         offset=_HDR.size, count=2 * h * w)
    inten = data[: h * w].reshape(h, w).astype(np.float32)
    depth = data[h * w:].reshape(h, w).astype(np.float32) * (scale_um * 1e-6)
    return inten, depth


def save_frame(path: str, intensity, depth_m, depth_scale_um: int = 1000):
    """Write a .gsf frame; depth given in meters, stored as u16 raw units."""
    with open(path, "wb") as f:
        f.write(encode_frame(intensity, depth_m, depth_scale_um))


def load_frame(path: str):
    """Read a .gsf frame -> (intensity f32, depth_m f32)."""
    with open(path, "rb") as f:
        return decode_frame(f.read())


class FrameStore:
    """Directory of per-sequence-id frames with optional batch prefetch.

    File naming follows the reference's zero-padded scheme
    (``mapping_PCD.cpp:110``): ``{seq_id:07d}.gsf``.
    """

    def __init__(self, directory: str, pattern: str = "{seq:07d}.gsf"):
        self.dir = directory
        self.pattern = pattern

    def path(self, seq: int) -> str:
        return os.path.join(self.dir, self.pattern.format(seq=seq))

    def __call__(self, seq: int):
        p = self.path(seq)
        if not os.path.exists(p):
            return None
        return load_frame(p)

    def save(self, seq: int, intensity, depth_m, depth_scale_um=1000):
        os.makedirs(self.dir, exist_ok=True)
        save_frame(self.path(seq), intensity, depth_m, depth_scale_um)

    def load_batch(self, seqs, w: int, h: int, depth_scale_um: int = 1000):
        """Batch-load frames with the native pthread loader when available.

        Returns (intensity (N,h,w) f32, depth_m (N,h,w) f32).
        """
        from .. import native

        paths = [self.path(s) for s in seqs]
        words = 8 + 2 * h * w  # 16-byte header = 8 u16 words + payload
        # read each file as one flat u16 row; slice off the header
        raw = native.read_frames_u16(paths, words, 1, n_threads=8)
        if raw is not None:
            raw = raw.reshape(len(seqs), words)
            inten = raw[:, 8:8 + h * w].reshape(-1, h, w).astype(np.float32)
            depth_raw = raw[:, 8 + h * w:].reshape(-1, h, w)
            depth = depth_raw.astype(np.float32) * (depth_scale_um * 1e-6)
            return inten, depth
        intens = np.empty((len(seqs), h, w), np.float32)
        depths = np.empty((len(seqs), h, w), np.float32)
        for k, p in enumerate(paths):
            i, d = load_frame(p)
            intens[k], depths[k] = i, d
        return intens, depths
