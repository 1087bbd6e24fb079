"""Color table for trajectory / PLY output — a copy of
``graph_slam_tpu/utils/colors.py`` (numpy only).

Role of the reference's 7-color table (``gtsam/color.h``):
named colors indexed by enum for coloring trajectories and clouds.
"""

from __future__ import annotations

import numpy as np

__all__ = ["COLORS", "color"]

COLORS = {
    "red": (230, 30, 30),
    "green": (40, 180, 60),
    "blue": (40, 80, 230),
    "yellow": (240, 200, 40),
    "purple": (150, 60, 200),
    "cyan": (50, 200, 210),
    "white": (250, 250, 250),
}

_ORDER = list(COLORS)


def color(key) -> np.ndarray:
    """Color by name or index (wraps around)."""
    if isinstance(key, str):
        return np.asarray(COLORS[key], np.uint8)
    return np.asarray(COLORS[_ORDER[int(key) % len(_ORDER)]], np.uint8)
