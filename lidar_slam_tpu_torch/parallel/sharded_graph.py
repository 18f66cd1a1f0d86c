"""Edge-sharded pose-graph optimization over a rank mesh (port of
lidar_slam_tpu/parallel/sharded_graph.py).

The EDGE and PRIOR arrays are split over the ranks in contiguous chunks;
node state stays replicated. Each rank linearizes its own edges, and every
node-indexed sum meets in one `all_sum`: the chi2, the gradient, the
diagonal blocks and each PCG matvec ([N, 6]). The LM loop and the PCG are
the single-rank optimizer's (`models/graph_optimizer.py`): the PCG runs
all its `pcg_iters` steps under `torch.where` and reads nothing on the
host, and the LM loop reads the host once an iteration, on every rank the
same replicated values, so the ranks stay in lockstep.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..models.graph_optimizer import (
    GraphOptimizerConfig,
    PoseGraph,
    _assemble,
    _gradient,
    _solve_pcg,
    graph_chi2,
    levenberg_marquardt,
)
from .collectives import all_sum
from .mesh import Mesh

EDGE_FIELDS = ("edge_ij", "edge_meas", "edge_info", "edge_valid")
PRIOR_FIELDS = ("prior_node", "prior_xyz", "prior_info", "prior_valid", "prior_quat", "prior_type")


def _chunk(x: torch.Tensor, mesh: Mesh, what: str) -> torch.Tensor:
    if x.shape[0] % mesh.size:
        raise ValueError(f"{what} {x.shape[0]} must divide mesh size {mesh.size}")
    k = x.shape[0] // mesh.size
    return x[mesh.rank * k:(mesh.rank + 1) * k]


def edge_shard(graph: PoseGraph, mesh: Mesh) -> PoseGraph:
    """`graph` with this rank's contiguous chunk of the edges and of the
    priors (both capacities must divide the mesh size) and every node.
    Contiguous, because schur_prepare lays the edges out by owner block."""
    return dataclasses.replace(
        graph,
        **{f: _chunk(getattr(graph, f), mesh, "edge capacity") for f in EDGE_FIELDS},
        **{f: _chunk(getattr(graph, f), mesh, "prior capacity") for f in PRIOR_FIELDS},
    )


def optimize_pose_graph_sharded(graph: PoseGraph, cfg: GraphOptimizerConfig, mesh: Mesh) -> Tuple[PoseGraph, dict]:
    """LM + PCG with the edges and priors sharded over the mesh: the same
    semantics as optimize_pose_graph(solver="pcg"). Returns (graph with the
    optimized poses, stats as host numbers), the same on every rank."""
    g = edge_shard(graph, mesh)

    def reduce(t):
        return all_sum(t, mesh)

    def step(poses, lam):
        asm = _assemble(dataclasses.replace(g, poses=poses), cfg)
        return _solve_pcg(asm, lam, reduce(_gradient(asm)), cfg, reduce=reduce)

    poses, stats = levenberg_marquardt(
        g.poses, g.node_valid & ~g.node_fixed, step,
        lambda poses: reduce(graph_chi2(dataclasses.replace(g, poses=poses), cfg)), cfg,
    )
    return dataclasses.replace(graph, poses=poses), stats
