"""PNG-pair RGB-D frame source (RealSense / TUM-style recordings) — a copy
of ``graph_slam_tpu/io/rgbd_png.py`` (numpy; PIL imported at first read).

The reference's RealSense drivers read a custom stream through the external
``rs_r200_wrapper.h`` (absent sibling repo, SURVEY §0); the portable form
of those recordings is per-frame PNG pairs — a color (or infrared) image
plus a 16-bit depth image in millimeters. ``PngFrameStore`` exposes them
through the same ``seq -> (intensity, depth_m)`` callable contract as
``FrameStore``, so every pipeline and CLI tool ingests them directly.

``open_frame_source`` auto-detects a directory's format (.gsf native store
vs PNG pairs) — used by the CLI ``--frames`` arguments.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .frames import FrameStore

__all__ = ["PngFrameStore", "open_frame_source"]


class PngFrameStore:
    """Directory of ``color_*.png`` + ``depth_*.png`` (u16 mm) pairs.

    Patterns are ``str.format`` templates over ``seq``; common alternates
    (``rgb_*``, bare ``{seq}.png`` + ``{seq}_depth.png``) are probed when
    the default misses.
    """

    _COLOR_PATTERNS = ("color_{seq:06d}.png", "rgb_{seq:06d}.png",
                       "color_{seq:07d}.png", "{seq:07d}.png",
                       "{seq:06d}.png")
    _DEPTH_PATTERNS = ("depth_{seq:06d}.png", "depth_{seq:07d}.png",
                       "{seq:07d}_depth.png", "{seq:06d}_depth.png")

    def __init__(self, directory: str, color_pattern: str | None = None,
                 depth_pattern: str | None = None,
                 depth_scale: float = 0.001):
        self.dir = directory
        self.color_pattern = color_pattern
        self.depth_pattern = depth_pattern
        self.depth_scale = depth_scale

    def _find(self, seq: int, patterns, fixed):
        if fixed is not None:
            p = os.path.join(self.dir, fixed.format(seq=seq))
            return p if os.path.exists(p) else None
        for pat in patterns:
            p = os.path.join(self.dir, pat.format(seq=seq))
            if os.path.exists(p):
                return p
        return None

    def __call__(self, seq: int):
        from PIL import Image

        cp = self._find(seq, self._COLOR_PATTERNS, self.color_pattern)
        dp = self._find(seq, self._DEPTH_PATTERNS, self.depth_pattern)
        if cp is None or dp is None:
            return None
        col = np.asarray(Image.open(cp))
        if col.ndim == 3:      # RGB -> luminance
            col = (0.299 * col[..., 0] + 0.587 * col[..., 1]
                   + 0.114 * col[..., 2])
        inten = col.astype(np.float32)
        depth = np.asarray(Image.open(dp)).astype(np.float32) \
            * self.depth_scale
        return inten, depth


def open_frame_source(directory: str):
    """Auto-detect a frame directory: .gsf store, TUM sequence, or PNG
    pairs."""
    from .tum import TumDataset, is_tum_dir

    if glob.glob(os.path.join(directory, "*.gsf")):
        return FrameStore(directory)
    if is_tum_dir(directory):
        return TumDataset(directory)
    if glob.glob(os.path.join(directory, "*.png")):
        return PngFrameStore(directory)
    return FrameStore(directory)   # empty dir: default to the native store
