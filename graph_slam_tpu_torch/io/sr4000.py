"""SR4000 ``.bdat`` frame ingestion + conversion to ``.gsf`` — a copy of
``graph_slam_tpu/io/sr4000.py`` (numpy only).

Plays the role of the external ``SR_reader_cv.h`` the reference links
against (``readOneFrameCV`` in every driver, e.g. test_vro_imu_graph.cpp:172;
the decoder itself lives in a sibling repo and is NOT part of the reference,
SURVEY.md §0). The reference's datasets are per-frame binary dumps named
``{seq:07d}.bdat`` (gtsam_graph.cpp:1890) holding the SwissRanger SR4000's
176x144 range + amplitude images.

Because the exact field layout is defined outside the reference, this
reader supports the plausible SR4000 dump layouts and auto-detects by file
size (explicit ``layout=`` overrides):

- ``"zxyi"``: float32 z, x, y arrays then uint16 amplitude (full cartesian
  dump; 14 B/px);
- ``"zf_i"``: float32 z then uint16 amplitude (6 B/px);
- ``"z_i"``:  uint16 range (mm) then uint16 amplitude (4 B/px).

Any fixed-size header is inferred from the residual bytes. Amplitude maps
to intensity with the SR library's sqrt equalization (optional) — raw
SR4000 amplitude is roughly signal-squared, and the frontend expects a
camera-like intensity image.

``convert_bdat_dir`` rewrites a dataset directory into the documented
``.gsf`` format so every pipeline/tool (FrameStore consumers) can replay
reference datasets directly.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

from .frames import FrameStore

__all__ = ["read_bdat", "convert_bdat_dir", "SR4000_SHAPE"]

SR4000_SHAPE = (144, 176)   # (height, width)

_LAYOUT_BYTES_PER_PX = {"zxyi": 14, "zf_i": 6, "z_i": 4}


def _detect_layout(n_bytes: int, n_px: int):
    """(layout, header_bytes) from the file size, smallest header wins."""
    best = None
    for layout, bpp in _LAYOUT_BYTES_PER_PX.items():
        hdr = n_bytes - bpp * n_px
        if hdr >= 0 and (best is None or hdr < best[1]):
            best = (layout, hdr)
    if best is None:
        raise ValueError(
            f"file too small for a {n_px}-pixel SR4000 frame ({n_bytes} B)")
    return best


def read_bdat(path: str, shape=SR4000_SHAPE, layout: str | None = None,
              header_bytes: int | None = None, sqrt_intensity: bool = True,
              z_unit_mm: bool = True):
    """Read one .bdat frame -> (intensity f32 (H, W), depth_m f32 (H, W)).

    ``layout``/``header_bytes`` default to auto-detection; see module
    docstring for the supported layouts.
    """
    h, w = shape
    n_px = h * w
    raw = np.fromfile(path, np.uint8)
    if layout is None and header_bytes is None:
        layout, header_bytes = _detect_layout(raw.size, n_px)
    elif layout is None:
        # header pinned: pick the layout whose pixel payload fits exactly
        layout = next((lo for lo, bpp in _LAYOUT_BYTES_PER_PX.items()
                       if raw.size - header_bytes == bpp * n_px), None)
        if layout is None:
            layout, _ = _detect_layout(raw.size - header_bytes, n_px)
    elif header_bytes is None:
        # layout pinned: the header is whatever precedes ITS payload (the
        # best-fit layout's header would mis-align an explicit override)
        header_bytes = raw.size - _LAYOUT_BYTES_PER_PX[layout] * n_px
        if header_bytes < 0:
            raise ValueError(
                f"file too small for layout {layout!r}: {raw.size} B < "
                f"{_LAYOUT_BYTES_PER_PX[layout] * n_px} B payload")
    buf = raw[header_bytes:]

    if layout == "zxyi":
        z = buf[:4 * n_px].view("<f4")[:n_px].reshape(h, w)
        amp = buf[12 * n_px:12 * n_px + 2 * n_px].view("<u2")[:n_px] \
            .reshape(h, w)
        depth = z.astype(np.float32)
    elif layout == "zf_i":
        z = buf[:4 * n_px].view("<f4")[:n_px].reshape(h, w)
        amp = buf[4 * n_px:4 * n_px + 2 * n_px].view("<u2")[:n_px] \
            .reshape(h, w)
        depth = z.astype(np.float32)
    elif layout == "z_i":
        z = buf[:2 * n_px].view("<u2")[:n_px].reshape(h, w)
        amp = buf[2 * n_px:4 * n_px].view("<u2")[:n_px].reshape(h, w)
        depth = z.astype(np.float32) * (1e-3 if z_unit_mm else 1.0)
    else:
        raise ValueError(f"unknown .bdat layout {layout!r}")

    inten = amp.astype(np.float32)
    if sqrt_intensity:
        # SR amplitude ~ signal^2; sqrt-equalize into a camera-like image
        inten = np.sqrt(np.maximum(inten, 0.0))
        peak = float(inten.max()) or 1.0
        inten = inten * (255.0 / peak)
    return inten, np.nan_to_num(depth, nan=0.0, posinf=0.0, neginf=0.0)


def convert_bdat_dir(src_dir: str, dst_dir: str, suffix: str = "bdat",
                     shape=SR4000_SHAPE, layout: str | None = None,
                     sqrt_intensity: bool = True) -> int:
    """Convert every ``*.{suffix}`` frame into ``dst_dir`` as ``.gsf``.

    File stems must contain the sequence id (the reference's zero-padded
    ``{seq:07d}.bdat`` scheme); returns the number of converted frames.
    """
    store = FrameStore(dst_dir)
    n = 0
    for path in sorted(glob.glob(os.path.join(src_dir, f"*.{suffix}"))):
        stem = os.path.splitext(os.path.basename(path))[0]
        m = re.search(r"(\d+)$", stem)
        if not m:
            continue
        seq = int(m.group(1))
        inten, depth = read_bdat(path, shape=shape, layout=layout,
                                 sqrt_intensity=sqrt_intensity)
        store.save(seq, inten, depth)
        n += 1
    return n
