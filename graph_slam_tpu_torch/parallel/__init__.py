"""Multi-device solving over a ``torch.distributed`` process group (port of
``parallel/``): ``launch`` starts the ranks (one process each), and the
sharded solvers run on every rank of it."""

from .launch import launch
from .sharding import (
    make_mesh,
    pad_graph_for_mesh,
    shard_graph,
    sharded_ba_sqrt,
    sharded_gn,
    sharded_gn_pcg_step,
    sharded_gn_step,
)

__all__ = ["make_mesh", "pad_graph_for_mesh", "shard_graph",
           "sharded_ba_sqrt", "sharded_gn", "sharded_gn_pcg_step",
           "sharded_gn_step", "launch"]
