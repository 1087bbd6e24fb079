"""Headless viewer equivalents of the reference's VTK/Qt visualizers (port
of ``graph_slam_tpu/mapping/viewers.py``).

The reference ships interactive inspection executables
(``gtsam/test/view_registration_results.cpp`` / ``_list`` / ``_range``:
overlay two registered frame clouds in a VTK window;
``display_many_imgs.cpp``: a Qt image montage). This package is headless,
so the same inspection artifacts are written to disk instead:

- ``write_registration_ply``: backproject a frame pair, transform frame j
  through the edge ``T_ij``, and write one two-color PLY — a correct
  registration shows the clouds coinciding; the clouds are built on the
  device of ``T_ij``'s tensors;
- ``write_image_grid``: a PNG montage of intensity frames (PIL, imported
  at the call).
"""

from __future__ import annotations

import numpy as np

from ..config import CameraIntrinsics
from ..core import se3
from ..device import to_host
from ..io.trajectory import write_ply_points
from ..vision.camera import cloud_from_images

__all__ = ["write_registration_ply", "write_image_grid"]


def write_registration_ply(path: str, K: CameraIntrinsics, frame_i,
                           frame_j, T_ij: se3.Pose, skip: int = 3,
                           color_i=(230, 60, 60), color_j=(60, 200, 60)):
    """Overlay frame i (red) and frame j transformed by ``T_ij`` (green).

    ``T_ij`` is the frontend edge convention — the pose of frame j in
    frame i (``p_i = T_ij p_j``). Returns the number of points written.
    """
    dev = T_ij.t.device
    pi, _, vi = cloud_from_images(K, frame_i[0], frame_i[1], skip=skip,
                                  device=dev)
    pj, _, vj = cloud_from_images(K, frame_j[0], frame_j[1], skip=skip,
                                  device=dev)
    pj_in_i = se3.transform_from(T_ij, pj.to(T_ij.t.dtype))
    pi, vi, pj_in_i, vj = to_host((pi, vi, pj_in_i, vj))
    pts = np.concatenate([pi[vi], pj_in_i[vj]])
    cols = np.concatenate([
        np.tile(np.asarray(color_i, np.uint8), (int(vi.sum()), 1)),
        np.tile(np.asarray(color_j, np.uint8), (int(vj.sum()), 1)),
    ])
    write_ply_points(path, pts, cols)
    return len(pts)


def write_image_grid(path: str, images, cols: int = 4, pad: int = 2):
    """PNG montage of 2-D intensity arrays (display_many_imgs role)."""
    from PIL import Image

    imgs = [np.asarray(im) for im in images]
    h = max(im.shape[0] for im in imgs)
    w = max(im.shape[1] for im in imgs)
    n = len(imgs)
    rows = (n + cols - 1) // cols
    canvas = np.zeros((rows * (h + pad), cols * (w + pad)), np.uint8)
    for k, im in enumerate(imgs):
        r, c = divmod(k, cols)
        lo = im.min()
        hi = im.max()
        scaled = np.zeros_like(im, np.uint8) if hi <= lo else \
            ((im - lo) * (255.0 / (hi - lo))).astype(np.uint8)
        y = r * (h + pad)
        x = c * (w + pad)
        canvas[y:y + im.shape[0], x:x + im.shape[1]] = scaled
    Image.fromarray(canvas).save(path)
    return canvas.shape
