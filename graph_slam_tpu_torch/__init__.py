"""graph_slam_tpu_torch — the PyTorch/CUDA port of ``graph_slam_tpu``.

The JAX package ``graph_slam_tpu`` is the reference; this package mirrors
its module paths and public names so each counterpart sits at the same
relative path. It imports torch and numpy, never jax or ``graph_slam_tpu``
(importing any ``graph_slam_tpu.*`` module imports jax), so the numpy-only
pieces it needs are copied, with their source named in each docstring.

Ported so far:

- the pose-graph backend: ``core``, ``noise``, the factor arenas, dense,
  PCG and gather-PCG LM/GN, g2o's chunked LM (``graph.lm``), chordal
  initialization (``graph.init``), PCM loop gating (``graph.pcm``), GNC
  (``graph.gnc``), the banded solvers (``graph.banded``), fleet GN
  (``graph.batch``), pose marginalization (``graph.sparsify``),
  ``pipelines.posegraph`` with ``run_g2o_file``, ``io.vro_log`` and
  ``io.trajectory``;
- IMU preintegration (``imu``, ``core.extrinsics``) and both VIO engines
  (``pipelines.vio``: the online engine, the default, and the scan
  engine), with the fixed-lag and incremental optimizers
  (``graph.online``);
- the plane stack (``planes``): extraction, association, plane nodes and
  the plane rescue, whose region grow is a hand-written CUDA kernel
  (``csrc/region_grow.cu``, built by ``kernels.build``);
- bundle adjustment: the Cal3DS2 projection and point-prior tables
  (``graph.factors``), the normal-equations and square-root Schur
  eliminations (``graph.ba_solve``), marginal covariances
  (``graph.marginals``), ``vision`` (Cal3DS2, depth backprojection,
  two-frame BA, ``TrackBook``), ``datasets.make_ba_graph`` and
  ``pipelines.run_ba_imu``;
- the visual frontend and online SLAM: Harris and SIFT extraction,
  descriptor matching, batched RANSAC and PnP, the VRO frontend and place
  recognition (``vision``), ``pipelines.OnlineSlam``, ``plane_check``,
  ``features_from_store``, ``imu.euler``, ``tools`` (the VRO-log tools),
  ``io.frames`` and ``utils.metrics``;
- the command line (``cli``, ``python -m graph_slam_tpu_torch``, all 26
  subcommands, ``--device`` choosing where they run), mapping (point
  clouds and their filters, grid meshes, TSDF fusion on the device with
  marching tetrahedra, map-video snapshots, headless viewers, the
  PointCloud2-layout publisher: ``mapping``), the SLAM service
  (``serving``), the launch-file presets (``config``, ``configs/``), the
  RGB-D readers (``io.rgbd_png``, ``io.sr4000``, ``io.tum``),
  ``utils.colors`` and the native IO runtime (``native``, C++ over
  ctypes, with numpy fallbacks);
- multi-device solving over ``torch.distributed`` (``parallel``): one
  process a rank (``parallel.launch``), factor-sharded dense and
  matrix-free PCG GN, landmark-sharded square-root BA, the sharded fleet
  (``graph.sharded_gn_many``), ``BaImuConfig.sharded``, ``g2o --sharded
  N``, ``ba-imu --sharded N`` and the multi-device dry run
  (``parallel.dryrun``).

Every module of the JAX package has its counterpart here but
``core/trig.py``, dropped with a parity test (``core/so3.py``).

Importing the package changes no process-wide torch setting: tensors
default to whatever dtype the caller has set (entry points take
``dtype=``, float64 by default, as the reference's tests run x64), and
float32 matmuls keep torch's default full precision, TF32 off, unless the
application has chosen otherwise (``torch.set_float32_matmul_precision``).
The reference forces full-precision matmuls because reduced precision
diverges the estimator (``graph_slam_tpu/__init__.py``).
"""

__version__ = "0.1.0"

from . import core
from .core import se3, so3, Pose

__all__ = ["core", "se3", "so3", "Pose", "__version__"]
