"""VRO results log IO — a copy of ``graph_slam_tpu/io/vro_log.py`` (numpy).

Format (one edge per line, whitespace separated):

    id_to id_from xi0..xi5 info(0,0) info(0,1) ... info(5,5)

- ``xi`` is the SE(3) log of the relative camera-frame transform,
  rotation first (``core.se3.logmap``);
- the information matrix is stored as its 21 upper-triangular entries,
  row-major;
- a *failed* match is encoded with ``info(0,0) == 10000``.

``read_vro_log`` parses with the native runtime (``native.parse_vro_log``,
strtod) when it is built, else with numpy, as the reference does. Floats
round-trip with ``repr`` precision.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["VROLog", "read_vro_log", "write_vro_log", "failed_edge",
           "FAILED_INFO_SENTINEL"]

FAILED_INFO_SENTINEL = 10000.0

_TRIU = np.triu_indices(6)


@dataclasses.dataclass
class VROLog:
    """Columnar edge records: ``id_to`` observed-at frame, ``id_from`` base."""

    id_to: np.ndarray    # (E,) int
    id_from: np.ndarray  # (E,) int
    xi: np.ndarray       # (E, 6) se3 log of relative pose (camera frame)
    info: np.ndarray     # (E, 6, 6) symmetric information

    def __len__(self) -> int:
        return len(self.id_to)

    @property
    def valid(self) -> np.ndarray:
        """Mask of successful matches (sentinel check)."""
        return self.info[:, 0, 0] != FAILED_INFO_SENTINEL

    def sorted_by_target(self) -> "VROLog":
        order = np.argsort(self.id_to, kind="stable")
        return VROLog(self.id_to[order], self.id_from[order],
                      self.xi[order], self.info[order])


def read_vro_log(path: str) -> VROLog:
    from .. import native

    rows = native.parse_vro_log(path)
    if rows is None:
        with open(path) as f:
            tokens = f.read().split()
        # 2 ids + 6 pose + 21 info = 29 tokens per record
        nrec = len(tokens) // 29
        rows = np.asarray(tokens[:29 * nrec],
                          dtype=np.float64).reshape(nrec, 29)
    nrec = len(rows)
    if not nrec:
        return VROLog(np.zeros(0, int), np.zeros(0, int),
                      np.zeros((0, 6)), np.zeros((0, 6, 6)))
    info = np.zeros((nrec, 6, 6))
    info[:, _TRIU[0], _TRIU[1]] = rows[:, 8:29]
    info = info + np.swapaxes(info, 1, 2)
    diag = np.arange(6)
    info[:, diag, diag] *= 0.5
    return VROLog(rows[:, 0].astype(int), rows[:, 1].astype(int),
                  rows[:, 2:8].copy(), info)


def write_vro_log(path: str, log: VROLog) -> None:
    with open(path, "w") as f:
        for k in range(len(log)):
            parts = [str(log.id_to[k]), str(log.id_from[k])]
            parts += [repr(float(v)) for v in log.xi[k]]
            parts += [repr(float(v)) for v in log.info[k][_TRIU]]
            f.write(" ".join(parts) + " \n")


def failed_edge(id_to: int, id_from: int) -> tuple:
    """An identity edge row with the failure sentinel information."""
    info = np.eye(6) * FAILED_INFO_SENTINEL
    return id_to, id_from, np.zeros(6), info
