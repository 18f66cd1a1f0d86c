"""The multi-rank layer (port of lidar_slam_tpu/parallel/): SPMD over the
ranks of a torch.distributed process group, one process each (NCCL on
the cards, gloo on the CPU or for ranks that share a card), started by
`launch.launch`."""

from .mesh import Mesh, device_count, distributed_init_from_env, make_mesh, process_count
from .sharded_graph import optimize_pose_graph_sharded
from .sharded_ndt import (
    sharded_build_local_map,
    sharded_build_ndt_map,
    sharded_ndt_align,
    sharded_ndt_derivatives,
)
from .sharded_schur import SchurGraph, optimize_pose_graph_schur, schur_prepare

__all__ = [
    "Mesh",
    "make_mesh",
    "device_count",
    "distributed_init_from_env",
    "process_count",
    "sharded_build_local_map",
    "sharded_build_ndt_map",
    "sharded_ndt_align",
    "sharded_ndt_derivatives",
    "optimize_pose_graph_sharded",
    "SchurGraph",
    "optimize_pose_graph_schur",
    "schur_prepare",
]
