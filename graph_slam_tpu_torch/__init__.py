"""graph_slam_tpu_torch — the PyTorch/CUDA port of ``graph_slam_tpu``.

The JAX package ``graph_slam_tpu`` is the reference; this package mirrors
its module paths and public names so each counterpart sits at the same
relative path. It imports torch and numpy, never jax or ``graph_slam_tpu``
(importing any ``graph_slam_tpu.*`` module imports jax), so the numpy-only
pieces it needs are copied, with their source named in each docstring.

Ported so far: the pose-graph backend (``core``, ``noise``, ``graph``,
``datasets.synthetic``, ``pipelines.posegraph``, ``io.vro_log``), the
plane-rescue propagation (``planes``) with its hand-written CUDA region
grow (``csrc/region_grow.cu``, built by ``kernels.build``), and IMU
preintegration with the VIO scan engine without planes (``imu``,
``core.extrinsics``, ``graph.online``, ``pipelines.vio``).

Numerics set on import, mirroring ``graph_slam_tpu/__init__.py`` (which
forces full-precision matmuls because reduced precision diverges the
estimator) and ``tests/conftest.py`` (x64):

- the default floating dtype is float64;
- TF32 is off for CUDA matmuls and cuDNN convolutions.
"""

__version__ = "0.1.0"

import torch as _torch

_torch.set_default_dtype(_torch.float64)
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import core
from .core import se3, so3, Pose

__all__ = ["core", "se3", "so3", "Pose", "__version__"]
