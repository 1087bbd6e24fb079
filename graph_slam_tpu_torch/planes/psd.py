"""Plane-covariance PSD repair — a copy of ``graph_slam_tpu/planes/psd.py``
(numpy only).

Copied rather than imported: importing ``graph_slam_tpu.planes.psd`` runs
``graph_slam_tpu/__init__.py``, which imports jax.

The reference hand-repairs plane observation covariances before building
factors (``addPlaneFactor``): symmetry/PSD check with a ``regularizeCOV``
retry, diagonal dominance, zeroing the off-diagonal of the normal block,
and flooring + quantizing the diagonal at 1e-8. This module reproduces
those outcomes with an eigenvalue clamp followed by the reference's exact
final normalization, so factor gating decisions match.

The quantization ``floor(d * 1e8) * 1e-8`` is a step function: two
covariances that differ by rounding can land one 1e-8 step apart, and the
factor's sqrt-information then differs by far more than the rounding.
"""

from __future__ import annotations

import numpy as np

__all__ = ["repair_plane_cov", "inflate_if_uncertain", "TRACE_REJECT"]

TRACE_REJECT = 1.0   # trace(S_NV) > 1 on an existing landmark -> reject obs
_DIAG_FLOOR = 1e-8


def repair_plane_cov(S) -> np.ndarray:
    """(3,3) tangent covariance -> repaired covariance, reference semantics.

    1. symmetrize + eigenvalue clamp (principled stand-in for the
       MatrixCheck/regularizeCOV retry loop);
    2. diagonal dominance (TriangleMatrix role) via the clamp;
    3. zero the (0,1)/(1,0) normal-block off-diagonals (gtsam_graph.cpp:1262);
    4. quantize diagonals to 1e-8 steps and floor at 1e-8 (``:1263-1264``).
    """
    S = np.asarray(S, np.float64)
    S = 0.5 * (S + S.T)
    w, V = np.linalg.eigh(S)
    w = np.clip(w, _DIAG_FLOOR, None)
    S = (V * w) @ V.T
    S[0, 1] = S[1, 0] = 0.0
    S[0, 2] = S[2, 0] = 0.0
    S[1, 2] = S[2, 1] = 0.0
    d = np.diag(S).copy()
    d = np.floor(d * 1e8) * 1e-8 + _DIAG_FLOOR
    return np.diag(d)


def inflate_if_uncertain(S, trace_snv: float, is_new_landmark: bool):
    """Reference gating on the raw normal-covariance trace
    (gtsam_graph.cpp:1196-1233):

    - new landmark with trace > 1: inflate to a fixed 1e-4 diagonal;
    - existing landmark with trace > 1: reject the observation.

    Returns (S', accept).
    """
    S = np.asarray(S, np.float64)
    if trace_snv > TRACE_REJECT:
        if is_new_landmark:
            return np.diag([1e-4, 1e-4, 1e-4]), True
        return S, False
    return S, True
