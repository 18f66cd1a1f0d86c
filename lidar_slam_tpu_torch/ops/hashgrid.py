"""Fixed-shape uniform bucket grid for nearest-neighbour search (port of
lidar_slam_tpu/ops/hashgrid.py).

Points are binned into a dense regular grid in CSR layout: one stable sort
of the flat cell ids, per-cell counts and exclusive-prefix starts. A query
reads the 3x3x3 cell stencil around its cell. With cell_size >= the gate
radius, the stencil covers every in-gate neighbour, so gated k-NN over the
stencil is exact gated k-NN (the only way the reference uses its kd-trees).

`knn_query` is the JAX package's gather-and-select form, with its `bucket_k`
cut per cell; kernel K2 (`ops/cuda/knn_fused.py`) is the exact form the
A-LOAM path runs on the card. Nothing here synchronises with the host.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .pointcloud import PointCloud


@dataclasses.dataclass
class BucketGrid:
    points: torch.Tensor  # [N, 3] points sorted by cell id
    point_idx: torch.Tensor  # [N] int32 original index of each sorted point
    valid: torch.Tensor  # [N] bool (sorted; the valid rows come first)
    cell_starts: torch.Tensor  # [V] int32 start row of each cell
    cell_counts: torch.Tensor  # [V] int32 number of valid points in each cell
    origin: torch.Tensor  # [3] float32 grid min corner, on the points' device
    cell_size: float
    dims: Tuple[int, int, int]


def _flat_cell_id(coords, dims):
    return (coords[..., 0] * dims[1] + coords[..., 1]) * dims[2] + coords[..., 2]


def in_bounds(coords, dims):
    """[..., 3] int cell coordinates inside the grid. Python-int bounds: no
    host-to-device copy of a constant on the per-sweep path."""
    return torch.all(coords >= 0, dim=-1) & (coords[..., 0] < dims[0]) & (coords[..., 1] < dims[1]) & (
        coords[..., 2] < dims[2]
    )


def clip_to_grid(coords, dims):
    """[..., 3] cell coordinates clamped into the grid."""
    return torch.stack([torch.clamp(coords[..., i], 0, dims[i] - 1) for i in range(3)], dim=-1)


def build_bucket_grid(cloud: PointCloud, cell_size: float, dims: Tuple[int, int, int], origin=None) -> BucketGrid:
    """Build the CSR bucket grid over a cloud.

    Args:
      cloud: target points [N].
      cell_size: cell edge length; choose >= the query gate radius.
      dims: grid dimensions (cells per axis). Points outside
        origin + dims * cell_size are dropped (marked invalid).
      origin: [3] grid min corner. Default: centre the grid on the masked
        centroid of the cloud (computed on the device, no host sync).
    """
    pts, mask = cloud.points, cloud.mask
    dev = pts.device
    dims = tuple(int(d) for d in dims)
    v = dims[0] * dims[1] * dims[2]
    cs = float(np.float32(cell_size))

    if origin is None:
        denom = torch.clamp(torch.sum(mask.to(torch.int32)), min=1)
        centroid = torch.sum(torch.where(mask[:, None], pts, 0.0), dim=0) / denom
        # the half extent in float32, as the reference computes it; one
        # scalar op per axis, so no constant is copied to the device
        half = np.float32(0.5) * np.float32(cs) * np.asarray(dims, np.float32)
        origin = torch.stack([centroid[i] - float(half[i]) for i in range(3)])
    else:
        origin = torch.as_tensor(origin, dtype=torch.float32).to(dev, non_blocking=True)

    coords = torch.floor((pts - origin) / cs).to(torch.int32)
    ok = mask & in_bounds(coords, dims)
    cid = torch.where(ok, _flat_cell_id(coords, dims), v)  # invalid -> sentinel cell v (sorts last)

    # one stable sort of the cell ids, then permutation gathers of the payload
    sorted_cid, order = torch.sort(cid, stable=True)
    # integer per-cell counts (exact; the sentinel cell v is sliced off)
    counts = torch.zeros(v + 1, dtype=torch.int32, device=dev).scatter_add_(
        0, sorted_cid.long(), torch.ones_like(sorted_cid)
    )[:v]
    starts = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts

    return BucketGrid(
        points=pts[order],
        point_idx=order.to(torch.int32),
        valid=ok[order],
        cell_starts=starts,
        cell_counts=counts,
        origin=origin,
        cell_size=cs,
        dims=dims,
    )


def stencil_offsets(device=None) -> torch.Tensor:
    """The 3x3x3 stencil, x-major (meshgrid indexing="ij"): [27, 3] int32."""
    axis = torch.arange(-1, 2, dtype=torch.int32, device=device)
    ox, oy, oz = torch.meshgrid(axis, axis, axis, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1), oz.reshape(-1)], dim=-1)


def sq_dist(a, b):
    """|a - b|^2 over the last axis as (dx*dx + dy*dy) + dz*dz, one rounding
    per operation (the order kernel K2 computes, without FMA)."""
    d = a - b
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def knn_query(grid: BucketGrid, queries, k: int, max_radius: float, bucket_k: int = 16, chunk: int = 4096):
    """k nearest neighbours of each query within max_radius.

    At most `bucket_k` candidates are read per stencil cell (cells holding
    more are truncated, as in the JAX package). Ties in distance keep the
    lower candidate position first, as `lax.top_k` does: a stable sort.

    Returns (idx [Q, k] int32 original-cloud indices, dist [Q, k] float32
    Euclidean distances, valid [Q, k] bool). Invalid slots have dist = +inf.
    """
    dev = queries.device
    dims = grid.dims
    v = dims[0] * dims[1] * dims[2]
    offsets = stencil_offsets(dev)
    max_r2 = float(np.float32(float(max_radius) ** 2))
    n_t = grid.points.shape[0]
    j = torch.arange(bucket_k, dtype=torch.int32, device=dev)

    out_idx, out_dist, out_ok = [], [], []
    for s in range(0, queries.shape[0], chunk):
        qc = queries[s:s + chunk]
        qcoords = torch.floor((qc - grid.origin) / grid.cell_size).to(torch.int32)
        cand = qcoords[:, None, :] + offsets[None, :, :]  # [C, S, 3]
        in_b = in_bounds(cand, dims)
        flat = torch.clamp(_flat_cell_id(cand, dims), 0, v - 1).long()
        starts = grid.cell_starts[flat]
        counts = torch.where(in_b, grid.cell_counts[flat], 0)

        slot_ok = j[None, None, :] < counts[:, :, None]  # [C, S, K]
        sidx = torch.clamp(starts[:, :, None] + j[None, None, :], 0, n_t - 1).long()
        d2 = sq_dist(grid.points[sidx], qc[:, None, None, :])  # [C, S, K]
        ok = slot_ok & (d2 <= max_r2)
        d2 = torch.where(ok, d2, torch.inf).reshape(qc.shape[0], -1)
        top_d2, top_pos = torch.sort(d2, dim=-1, stable=True)
        top_d2, top_pos = top_d2[:, :k], top_pos[:, :k]
        top_ok = torch.isfinite(top_d2)
        out_idx.append(torch.gather(grid.point_idx[sidx].reshape(qc.shape[0], -1), 1, top_pos))
        out_dist.append(torch.sqrt(top_d2))
        out_ok.append(top_ok)
    return torch.cat(out_idx), torch.cat(out_dist), torch.cat(out_ok)
