"""Carry state between the JAX package and the port, as numpy arrays.

The JAX package's pytrees go in as any object with the same field names
whose leaves are array-likes (``jax.tree.map(np.asarray, graph)`` for
example), so this module needs no jax. ``graph_from_numpy`` carries every
table (the IMU, plane, projection and point-prior tables included) and
``arena_from_numpy`` an arena with its velocities, biases, plane and point
landmarks; ``cal3ds2_from_numpy`` a camera's Cal3DS2 intrinsics;
``feature_frame_from_numpy`` a frame's keypoints, descriptors and 3D lift
(so matching can be held to JAX on the same features);
``imu_params_from_numpy`` and ``preint_from_numpy`` carry the IMU noise
model and a preintegration state, ``plane_node_from_numpy`` a frame's
plane set (``PlaneNodeDetection``, numpy on both sides). Integer fields become int64 (torch's
index type), bool fields bool, floating fields the requested ``dtype``.
``to_numpy`` goes the other way for tensors, NamedTuples and sequences.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .core import se3
from .device import resolve
from .graph.factors import TABLE_TYPES, FactorGraph
from .graph.variables import VariableArena
from .imu import ImuParams, PreintState
from .planes.plane_node import PlaneNodeDetection
from .vision.cal3ds2 import Cal3DS2
from .vision.features import FeatureFrame

__all__ = ["tensor", "graph_from_numpy", "arena_from_numpy",
           "cal3ds2_from_numpy", "feature_frame_from_numpy",
           "imu_params_from_numpy", "preint_from_numpy",
           "plane_node_from_numpy",
           "PropagationInputs", "propagation_inputs", "to_numpy"]



def tensor(x, *, device=None, dtype=torch.float64):
    """One array-like -> tensor on ``device``: ints int64, bools bool,
    floats ``dtype``."""
    a = np.array(x)
    if a.dtype == np.bool_:
        dt = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dt = torch.int64
    else:
        dt = dtype
    return torch.as_tensor(a, device=resolve(device)).to(dt)


def _convert(typ, obj, device, dtype):
    return typ(**{f: tensor(getattr(obj, f), device=device, dtype=dtype)
                  for f in typ._fields})


def graph_from_numpy(graph, *, device=None,
                     dtype=torch.float64) -> FactorGraph:
    """A JAX ``FactorGraph`` (numpy leaves) -> the port's ``FactorGraph``."""
    device = resolve(device)
    return FactorGraph(**{
        name: _convert(typ, getattr(graph, name), device, dtype)
        for name, typ in TABLE_TYPES.items()})


def arena_from_numpy(values, *, device=None,
                     dtype=torch.float64) -> VariableArena:
    """A JAX ``VariableArena`` (numpy leaves) -> the port's arena."""
    device = resolve(device)
    return _convert(VariableArena, values, device, dtype)


def cal3ds2_from_numpy(cal, *, device=None,
                       dtype=torch.float64) -> Cal3DS2:
    """A JAX ``Cal3DS2`` (numpy leaves) -> the port's ``Cal3DS2``."""
    return _convert(Cal3DS2, cal, resolve(device), dtype)


def feature_frame_from_numpy(frame, *, device=None) -> FeatureFrame:
    """A JAX ``FeatureFrame`` (numpy leaves) -> the port's: ``uv``,
    ``desc`` and ``pts3`` float32 as the extractors make them, ``valid``
    bool."""
    device = resolve(device)
    return FeatureFrame(*(tensor(getattr(frame, f), device=device,
                                 dtype=torch.float32)
                          for f in FeatureFrame._fields))


def imu_params_from_numpy(params, *, device=None,
                          dtype=torch.float64) -> ImuParams:
    """A JAX ``ImuParams`` (numpy leaves) -> the port's ``ImuParams``."""
    return _convert(ImuParams, params, resolve(device), dtype)


def preint_from_numpy(state, *, device=None,
                      dtype=torch.float64) -> PreintState:
    """A JAX ``PreintState`` (numpy leaves) -> the port's ``PreintState``."""
    return _convert(PreintState, state, resolve(device), dtype)


def plane_node_from_numpy(det) -> PlaneNodeDetection:
    """A JAX ``PlaneNodeDetection`` -> the port's, its arrays copied with
    their dtypes."""
    return PlaneNodeDetection(**{
        f.name: np.array(getattr(det, f.name))
        for f in dataclasses.fields(PlaneNodeDetection)})


class PropagationInputs(NamedTuple):
    """Per-plane propagation inputs of ``propagate_planes``."""

    planes_i: torch.Tensor    # (P, 4)
    S_ni: torch.Tensor        # (P, 3, 3)
    S_di: torch.Tensor        # (P,)
    prev_masks: torch.Tensor  # (P, H, W) bool
    prev_counts: torch.Tensor  # (P,)
    T_ij: se3.Pose            # (3, 3), (3,)
    S_tij: torch.Tensor       # (3, 3)
    intensity: torch.Tensor   # (H, W)
    depth: torch.Tensor       # (H, W)


def propagation_inputs(planes_i, S_ni, S_di, prev_masks, prev_counts, T_R,
                       T_t, S_tij, intensity, depth, *, device=None,
                       dtype=torch.float64) -> PropagationInputs:
    """numpy propagation inputs -> tensors; ``intensity`` and ``depth``
    take ``dtype`` too (the propagation computes in ``depth.dtype``)."""
    device = resolve(device)

    def t(x):
        return tensor(x, device=device, dtype=dtype)

    return PropagationInputs(
        t(planes_i), t(S_ni), t(S_di), t(np.asarray(prev_masks, bool)),
        t(prev_counts), se3.Pose(t(T_R), t(T_t)), t(S_tij),
        t(np.asarray(intensity, np.float64)), t(np.asarray(depth, np.float64)))


def to_numpy(x):
    """Tensors -> numpy arrays, recursively through NamedTuples, tuples,
    lists and dicts; other leaves unchanged."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return x
