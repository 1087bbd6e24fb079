"""Factor graph, arenas and optimizers of the port (``graph_slam_tpu/graph``
counterpart): prior/between/velocity/bias/IMU tables, dense and PCG
LM/GN, the online arenas with the incremental optimizer and the fixed-lag
windowed GN."""

from .builder import GraphBuilder, round_up
from .factors import (BetweenPoseTable, FactorGraph, ImuTable,
                      PriorPoseTable, PriorVec3Table, PriorVec6Table,
                      empty_graph, empty_table, linearize_blocks, total_error)
from .lm import LMParams, LMResult, gn_optimize, lm_optimize
from .online import IncrementalOptimizer, OnlineGraph
from .solve import inv33, solve_dense, solve_pcg, solve_pcg_precond
from .variables import (TangentLayout, VariableArena, empty_arena, layout_of,
                        retract_all, used_slot_mask)

__all__ = [
    "GraphBuilder", "round_up",
    "FactorGraph", "PriorPoseTable", "BetweenPoseTable", "PriorVec3Table",
    "PriorVec6Table", "ImuTable", "empty_table", "empty_graph",
    "total_error", "linearize_blocks",
    "LMParams", "LMResult", "lm_optimize", "gn_optimize",
    "IncrementalOptimizer", "OnlineGraph",
    "solve_dense", "solve_pcg", "solve_pcg_precond", "inv33",
    "VariableArena", "TangentLayout", "layout_of", "used_slot_mask",
    "retract_all", "empty_arena",
]
