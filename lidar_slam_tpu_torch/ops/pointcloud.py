"""Masked point-cloud primitives over padded fixed-shape tensors (port of
lidar_slam_tpu/ops/pointcloud.py).

Clouds are `[N, 3]` float32 with a `[N]` bool validity mask; removal ops
keep shapes fixed and flip mask bits instead of compacting, so nothing on
the per-frame path waits on the device for a data-dependent size.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class PointCloud:
    """Padded point cloud. `points[i]` is meaningful iff `mask[i]`.

    `weights` is the per-point static weight, default 1.0.
    """

    points: torch.Tensor  # [N, 3] float32
    mask: torch.Tensor  # [N] bool
    weights: Optional[torch.Tensor] = None  # [N] float32

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def num_valid(self):
        return torch.sum(self.mask.to(torch.int32), dim=-1)

    def get_weights(self):
        if self.weights is None:
            return torch.ones(self.points.shape[:-1], dtype=self.points.dtype, device=self.points.device)
        return self.weights

    @staticmethod
    def from_points(points, weights=None, capacity: Optional[int] = None, device=None):
        points = torch.as_tensor(points, dtype=torch.float32, device=device)
        n = points.shape[0]
        cap = capacity if capacity is not None else n
        if cap < n:
            raise ValueError(f"capacity {cap} < n points {n}")
        pts = torch.zeros((cap, 3), dtype=torch.float32, device=points.device)
        pts[:n] = points
        mask = torch.zeros(cap, dtype=torch.bool, device=points.device)
        mask[:n] = True
        w = None
        if weights is not None:
            w = torch.zeros(cap, dtype=torch.float32, device=points.device)
            w[:n] = torch.as_tensor(weights, dtype=torch.float32, device=points.device)
        return PointCloud(points=pts, mask=mask, weights=w)


def finite_mask(points):
    """True where all three coordinates are finite."""
    return torch.all(torch.isfinite(points), dim=-1)


def scatter_sum(target, index, values, keep):
    """A copy of `target` with the rows of `values` added at `index` [N]
    (index_add along dim 0) where `keep` [N] holds; other rows are dropped.

    The sums are taken in the same order on every run: on CUDA, index_put_
    with accumulate sorts the indices and adds each index's values in
    sequence, where index_add uses float atomics whose order, and thus
    rounding, changes from run to run. That sequence is serial per index,
    so each dropped row gets a scratch row of its own past the end (one
    shared row would gather every padded row into one serial run of ~1e5
    adds, ~10 ms on an H100)."""
    n, rows = index.shape[0], target.shape[0]
    idx = torch.where(keep, index, rows + torch.arange(n, device=index.device))
    out = torch.cat([target, target.new_zeros((n, *target.shape[1:]))])
    return out.index_put_((idx,), values, accumulate=True)[:rows]


def voxel_downsample(cloud: PointCloud, leaf_size, out_capacity: Optional[int] = None) -> PointCloud:
    """Exact voxel-grid centroid downsampling with fixed shapes.

    Groups valid points by integer voxel coordinate through one sort of a
    packed key, then reduces each group to its centroid (weights average per
    voxel). Output voxels come in key order: x-major, matching the JAX
    package's order exactly (the keys are unique per voxel).

    Key packing as in the reference: cells shifted to the cloud's min
    corner, x/y get 11 bits, z 9 bits (clipped to 510 so the invalid
    sentinel int32 max sorts strictly last).
    """
    n = cloud.capacity
    out_cap = out_capacity if out_capacity is not None else n
    pts = cloud.points
    mask = cloud.mask
    w = cloud.get_weights()
    dev = pts.device

    leaf = torch.as_tensor(leaf_size, dtype=torch.float32)
    leaf = float(leaf) if leaf.ndim == 0 else leaf.to(dev, non_blocking=True)
    coords = torch.floor(pts / leaf).to(torch.int32)
    cmin = torch.where(mask[:, None], coords, 2**20).amin(dim=0)
    rel = coords - cmin
    rel = torch.stack(
        [rel[:, 0].clamp(0, 2047), rel[:, 1].clamp(0, 2047), rel[:, 2].clamp(0, 510)], dim=-1
    )
    key = (rel[:, 0] << 20) | (rel[:, 1] << 9) | rel[:, 2]
    key = torch.where(mask, key, _INT32_MAX)

    # one stable sort + one permutation gather of the payload channels
    sk, perm = torch.sort(key, stable=True)
    sp = pts[perm]
    sm = mask[perm]
    sw = w[perm]

    new_group = torch.ones_like(sk, dtype=torch.bool)
    new_group[1:] = sk[1:] != sk[:-1]
    seg = torch.cumsum(new_group.to(torch.int32), dim=0, dtype=torch.int32).long() - 1
    # segment ids >= out_cap are dropped (segment_sum semantics), and so are
    # the masked rows, which add nothing
    keep = sm & (seg < out_cap)

    zeros = torch.zeros(out_cap, dtype=torch.float32, device=dev)
    counts = scatter_sum(zeros, seg, torch.ones_like(sw), keep)
    sums = scatter_sum(torch.zeros((out_cap, 3), device=dev), seg, sp, keep)
    wsums = scatter_sum(zeros, seg, sw, keep)

    denom = torch.clamp(counts, min=1.0)
    centroids = sums / denom[:, None]
    wmeans = wsums / denom
    out_mask = counts > 0
    return PointCloud(
        points=torch.where(out_mask[:, None], centroids, 0.0), mask=out_mask, weights=wmeans
    )


def rotated_box_mask(points, boxes):
    """Membership of points in yaw-rotated 3-D boxes.

    points [N, 3]; boxes [B, 7] rows (cx, cy, cz, dx, dy, dz, heading).
    Returns a [B, N] bool mask; row b marks the points inside box b.
    """
    centers = boxes[:, :3]
    half = boxes[:, 3:6] * 0.5
    heading = boxes[:, 6]
    d = points[None, :, :] - centers[:, None, :]  # [B, N, 3]
    c, s = torch.cos(heading), torch.sin(heading)
    lx = c[:, None] * d[..., 0] + s[:, None] * d[..., 1]
    ly = -s[:, None] * d[..., 0] + c[:, None] * d[..., 1]
    lz = d[..., 2]
    local = torch.stack([lx, ly, lz], dim=-1)
    return torch.all(torch.abs(local) <= half[:, None, :], dim=-1)
