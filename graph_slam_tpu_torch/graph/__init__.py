"""Factor graph, arenas and optimizers of the port (``graph_slam_tpu/graph``
counterpart): every factor table (prior/between/velocity/bias/IMU/plane/
projection/point prior), dense, PCG and gather-PCG LM/GN with the GTSAM
and g2o schedules, assembly, the Schur landmark eliminations of bundle
adjustment, marginal covariances, chordal initialization, PCM loop gating,
GNC, the banded solvers, fleet GN, pose marginalization, the online arenas
with the incremental optimizer and the fixed-lag windowed GN."""

from .assemble import assemble_dense, diag_precond, gradient, hvp_fn
from .ba_solve import (ba_gn_optimize, ba_gn_optimize_sqrt, build_point_obs,
                       landmark_classes, schur_gn_step, sqrt_schur_gn_step)
from .banded import (band_halfwidth, banded_direct_gn_optimize,
                     banded_gn_optimize)
from .batch import (gn_optimize_many, sharded_gn_many, solve_many,
                    stack_pytrees, unstack_pytree)
from .builder import GraphBuilder, round_up
from .factors import (BetweenPoseTable, FactorGraph, ImuTable, PlaneTable,
                      PriorPointTable, PriorPoseTable, PriorVec3Table,
                      PriorVec6Table, ProjectionTable, empty_graph,
                      empty_table, linearize_blocks, total_error)
from .gnc import GncResult, gnc_optimize
from .init import chordal_initialize, project_so3
from .lm import LMParams, LMResult, gn_optimize, lm_optimize, lm_optimize_g2o
from .marginals import (joint_marginal, marginal_covariance_cols,
                        plane_marginal, pose_marginal, pose_marginals_all)
from .online import IncrementalOptimizer, OnlineGraph
from .pcm import (PcmResult, max_clique, odometry_consistency,
                  pairwise_consistency, pcm_mask)
from .solve import inv33, solve_dense, solve_pcg, solve_pcg_precond
from .sparsify import chow_liu_tree, marginalize_poses
from .sparsity import Incidence, build_incidence, gather_sum
from .variables import (TangentLayout, VariableArena, empty_arena, layout_of,
                        retract_all, used_slot_mask)

__all__ = [
    "GraphBuilder", "round_up",
    "FactorGraph", "PriorPoseTable", "BetweenPoseTable", "PriorVec3Table",
    "PriorVec6Table", "ImuTable", "PlaneTable", "ProjectionTable",
    "PriorPointTable", "empty_table", "empty_graph",
    "total_error", "linearize_blocks",
    "LMParams", "LMResult", "lm_optimize", "lm_optimize_g2o", "gn_optimize",
    "assemble_dense", "gradient", "hvp_fn", "diag_precond",
    "schur_gn_step", "ba_gn_optimize", "build_point_obs",
    "landmark_classes", "sqrt_schur_gn_step", "ba_gn_optimize_sqrt",
    "marginal_covariance_cols", "pose_marginal", "plane_marginal",
    "joint_marginal", "pose_marginals_all",
    "Incidence", "build_incidence", "gather_sum",
    "gn_optimize_many", "solve_many", "stack_pytrees", "unstack_pytree",
    "sharded_gn_many",
    "band_halfwidth", "banded_gn_optimize", "banded_direct_gn_optimize",
    "chordal_initialize", "project_so3",
    "GncResult", "gnc_optimize",
    "PcmResult", "pcm_mask", "pairwise_consistency",
    "odometry_consistency", "max_clique",
    "marginalize_poses", "chow_liu_tree",
    "IncrementalOptimizer", "OnlineGraph",
    "solve_dense", "solve_pcg", "solve_pcg_precond", "inv33",
    "VariableArena", "TangentLayout", "layout_of", "used_slot_mask",
    "retract_all", "empty_arena",
]
