"""Node-sharded pose-graph solve by Schur complement over a rank mesh
(port of lidar_slam_tpu/parallel/sharded_schur.py).

NODES are split into contiguous blocks, one a rank, and each LM iteration
solves the damped normal equations EXACTLY by two-level domain
decomposition:

  1. every rank assembles and Cholesky-factors its own interior system
     H_II (dense [6m, 6m]; the interiors of different blocks are
     independent);
  2. the SEPARATOR system (nodes on cross-block edges, a small set found on
     the host) is reduced: S = C_SS - sum_b F_b^T H_II^-1 F_b and its
     right-hand side meet in one `all_sum`, and the [6S, 6S] system is
     Cholesky-solved on every rank;
  3. the interiors back-substitute locally, d_I = H_II^-1 (b_I - F d_S),
     and one more `all_sum` assembles the [N, 6] update.

The same damped system as the single-rank LM (g2o `lm_var`), solved
exactly, with the same accept/reject schedule (graph_optimizer.
levenberg_marquardt: one host read an iteration). `schur_prepare` lays the
graph out on the host. Blocks are assembled by fixed-order block sums
(no float atomics), so a solve repeats to the bit.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..models.graph_optimizer import (
    GraphOptimizerConfig,
    PoseGraph,
    _assemble,
    _segment_sum,
    graph_chi2,
    levenberg_marquardt,
)
from .collectives import all_sum
from .mesh import Mesh
from .sharded_graph import EDGE_FIELDS, PRIOR_FIELDS, edge_shard


@dataclasses.dataclass
class SchurGraph:
    """A PoseGraph laid out for the node-sharded Schur solve. Node arrays
    are whole; the edge and prior arrays are grouped so that the d-th
    contiguous chunk holds exactly the elements OWNED by rank d (an edge by
    the block of its node i, a prior by the block of its node)."""

    graph: PoseGraph  # edge / prior arrays grouped by owner, padded per rank
    sep_pos: torch.Tensor  # [N] int32: separator slot of a node, or -1
    sep_nodes: torch.Tensor  # [S_cap] int32 node of each separator slot (0-pad)
    sep_valid: torch.Tensor  # [S_cap] bool
    n_blocks: int
    block_size: int  # nodes per block
    sep_cap: int


def _owner_order(node, valid, block, n_devices, per, what):
    """Indices that group the valid elements by owner block, each group
    padded to `per` with invalid slots."""
    order = []
    for d in range(n_devices):
        idx = np.where(valid & (block(node) == d))[0]
        if len(idx) > per:
            raise ValueError(f"device {d} owns {len(idx)} {what}s > {per} capacity")
        pad = np.where(~valid)[0][: per - len(idx)]
        if len(pad) < per - len(idx):
            raise ValueError(f"not enough invalid {what} slots to pad device shares")
        order.append(np.concatenate([idx, pad]))
    return np.concatenate(order)


def schur_prepare(graph: PoseGraph, n_devices: int, sep_cap: int = 256) -> SchurGraph:
    """Host-side layout: partition the nodes, find the separators, group
    the edges and priors by owner. Raises ValueError if the separator set
    exceeds sep_cap, a capacity does not divide n_devices, or a rank's share
    of edges or priors exceeds capacity / n_devices."""
    n = graph.poses.shape[0]
    if n % n_devices:
        raise ValueError(f"node capacity {n} must divide n_devices {n_devices}")
    m = n // n_devices
    dev = graph.poses.device

    def block(node):
        return node // m

    eij = graph.edge_ij.cpu().numpy()
    evalid = graph.edge_valid.cpu().numpy()
    cross = evalid & (block(eij[:, 0]) != block(eij[:, 1]))
    sep_set = np.unique(np.concatenate([eij[cross, 0], eij[cross, 1]]))
    if len(sep_set) > sep_cap:
        raise ValueError(f"{len(sep_set)} separators exceed sep_cap {sep_cap}")
    sep_pos = np.full(n, -1, np.int32)
    sep_pos[sep_set] = np.arange(len(sep_set), dtype=np.int32)
    sep_nodes = np.zeros(sep_cap, np.int32)
    sep_nodes[: len(sep_set)] = sep_set
    sep_valid = np.arange(sep_cap) < len(sep_set)

    e_cap, p_cap = eij.shape[0], graph.prior_node.shape[0]
    if e_cap % n_devices:
        raise ValueError(f"edge capacity {e_cap} must divide n_devices {n_devices}")
    if p_cap % n_devices:
        raise ValueError(f"prior capacity {p_cap} must divide n_devices {n_devices}")
    eorder = _owner_order(eij[:, 0], evalid, block, n_devices, e_cap // n_devices, "edge")
    porder = _owner_order(graph.prior_node.cpu().numpy(), graph.prior_valid.cpu().numpy(), block, n_devices,
                          p_cap // n_devices, "prior")
    eo, po = torch.as_tensor(eorder, device=dev), torch.as_tensor(porder, device=dev)
    g = dataclasses.replace(
        graph,
        **{f: getattr(graph, f)[eo] for f in EDGE_FIELDS},
        **{f: getattr(graph, f)[po] for f in PRIOR_FIELDS},
    )
    return SchurGraph(
        graph=g,
        sep_pos=torch.as_tensor(sep_pos, device=dev),
        sep_nodes=torch.as_tensor(sep_nodes, device=dev),
        sep_valid=torch.as_tensor(sep_valid, device=dev),
        n_blocks=n_devices,
        block_size=m,
        sep_cap=sep_cap,
    )


def _block_matrix(rows: int, cols: int, terms) -> torch.Tensor:
    """The [6 rows, 6 cols] matrix of the 6x6 blocks of `terms`, each
    (blocks [K, 6, 6], block row [K], block col [K], weight [K]), summed per
    cell in a fixed order."""
    blocks = torch.cat([b * w[:, None, None] for b, _, _, w in terms])
    cells = torch.cat([r * cols + c for _, r, c, _ in terms])
    out = _segment_sum(blocks, cells, rows * cols)
    return out.reshape(rows, cols, 6, 6).permute(0, 2, 1, 3).reshape(rows * 6, cols * 6)


def _block_vector(rows: int, terms) -> torch.Tensor:
    """The [6 rows] vector of the 6-blocks of `terms` (blocks [K, 6], row
    [K], weight [K]), summed per row in a fixed order."""
    blocks = torch.cat([b * w[:, None] for b, _, w in terms])
    return _segment_sum(blocks, torch.cat([r for _, r, _ in terms]), rows).reshape(rows * 6)


def _damped(M, act6, lam):
    """Inactive rows / columns replaced by the identity, lam on the active
    diagonal."""
    return M * act6[:, None] * act6[None, :] + torch.diag(1.0 - act6) + lam * torch.diag(act6)


def optimize_pose_graph_schur(sg: SchurGraph, cfg: GraphOptimizerConfig, mesh: Mesh) -> Tuple[PoseGraph, dict]:
    """LM with the exact two-level Schur solve, node block `mesh.rank` on
    this rank (`sg` from schur_prepare(graph, mesh.size)). The same
    accept/reject schedule as optimize_pose_graph. Returns (graph with the
    optimized poses, stats as host numbers), the same on every rank."""
    if sg.n_blocks != mesh.size:
        raise ValueError(f"SchurGraph of {sg.n_blocks} blocks on a mesh of {mesh.size}")
    m, s_cap = sg.block_size, sg.sep_cap
    g = edge_shard(sg.graph, mesh)
    dev = g.poses.device
    n = g.poses.shape[0]
    base = mesh.rank * m
    free = g.node_valid & ~g.node_fixed
    sep_pos = sg.sep_pos.long()
    sep_nodes = sg.sep_nodes.long()
    own_nodes = base + torch.arange(m, device=dev)
    act_I = (free[own_nodes] & (sep_pos[own_nodes] < 0)).to(torch.float32)
    act_S = (sg.sep_valid & free[sep_nodes]).to(torch.float32)
    act_I6, act_S6 = act_I.repeat_interleave(6), act_S.repeat_interleave(6)

    def local_slot(node):  # 0..m-1 for this block's interior nodes, m = trash
        own = (node >= base) & (node < base + m) & (sep_pos[node] < 0) & free[node]
        return torch.where(own, node - base, m), own.to(torch.float32)

    def sep_slot(node):  # separator slot, s_cap = trash
        is_sep = (sep_pos[node] >= 0) & free[node]
        return torch.where(is_sep, sep_pos[node], s_cap), is_sep.to(torch.float32)

    def step(poses, lam):
        asm = _assemble(dataclasses.replace(g, poses=poses), cfg)
        Hii, Hjj, Hij, Hji = asm["Hii"], asm["Hjj"], asm["Hij"], asm["Hij"].transpose(1, 2)
        li, own_i = local_slot(asm["i"])
        lj, own_j = local_slot(asm["j"])
        lp, own_p = local_slot(asm["pn"])
        si, is_si = sep_slot(asm["i"])
        sj, is_sj = sep_slot(asm["j"])
        sp, is_sp = sep_slot(asm["pn"])
        # the interior system (m + 1 slots, the last a trash slot), the
        # interior-separator coupling F and this block's share of C_SS
        A = _block_matrix(m + 1, m + 1, [
            (Hii, li, li, own_i), (Hjj, lj, lj, own_j), (asm["Hp"], lp, lp, own_p),
            (Hij, li, lj, own_i * own_j), (Hji, lj, li, own_i * own_j),
        ])[: m * 6, : m * 6]
        F = _block_matrix(m + 1, s_cap + 1, [
            (Hij, li, sj, own_i * is_sj), (Hji, lj, si, is_si * own_j),
        ])[: m * 6, : s_cap * 6]
        C = _block_matrix(s_cap + 1, s_cap + 1, [
            (Hii, si, si, is_si), (Hjj, sj, sj, is_sj), (asm["Hp"], sp, sp, is_sp),
            (Hij, si, sj, is_si * is_sj), (Hji, sj, si, is_si * is_sj),
        ])[: s_cap * 6, : s_cap * 6]
        b_I = _block_vector(m + 1, [(asm["bi"], li, own_i), (asm["bj"], lj, own_j), (asm["bp"], lp, own_p)])[: m * 6]
        b_S = _block_vector(s_cap + 1, [(asm["bi"], si, is_si), (asm["bj"], sj, is_sj),
                                        (asm["bp"], sp, is_sp)])[: s_cap * 6]

        A = _damped(A, act_I6, lam)
        b_I = b_I * act_I6
        L, info = torch.linalg.cholesky_ex(A)
        AinvF = torch.cholesky_solve(F, L)
        Ainvb = torch.cholesky_solve(b_I[:, None], L)[:, 0]
        # the reduced separator system: S and its right-hand side in one sum
        reduced = all_sum(torch.cat([C - F.T @ AinvF, (b_S - F.T @ Ainvb)[:, None]], dim=1), mesh)
        S = _damped(reduced[:, :-1], act_S6, lam)
        rhs = reduced[:, -1] * act_S6
        Ls, info_s = torch.linalg.cholesky_ex(S)
        d_S = torch.cholesky_solve(rhs[:, None], Ls)[:, 0]
        d_I = Ainvb - AinvF @ d_S
        # a failed factorization gives a non-finite step, which LM rejects
        d_I = torch.where(info == 0, d_I, torch.nan)
        delta = torch.zeros((n, 6), dtype=torch.float32, device=dev)
        delta[own_nodes] = d_I.reshape(m, 6) * act_I[:, None]
        delta = all_sum(delta, mesh)
        d_S = torch.where(info_s == 0, d_S.reshape(s_cap, 6) * act_S[:, None], torch.nan)
        return delta + _segment_sum(d_S * sg.sep_valid[:, None], sep_nodes, n)

    poses, stats = levenberg_marquardt(
        g.poses, free, step, lambda poses: all_sum(graph_chi2(dataclasses.replace(g, poses=poses), cfg), mesh), cfg,
    )
    return dataclasses.replace(sg.graph, poses=poses), stats
