"""Masked point-cloud primitives over padded fixed-shape tensors (port of
lidar_slam_tpu/ops/pointcloud.py).

Clouds are `[N, 3]` float32 with a `[N]` bool validity mask; removal ops
keep shapes fixed and flip mask bits instead of compacting, so nothing on
the per-frame path waits on the device for a data-dependent size.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Tuple

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

    def permute(self, order) -> "PointCloud":
        """Reorder all channels (incl. weights) by an index tensor."""
        return PointCloud(
            points=self.points[order],
            mask=self.mask[order],
            weights=None if self.weights is None else self.weights[order],
        )

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


def range_mask(points, min_range: float = 0.0, max_range: float = math.inf):
    """True where min_range <= |p| <= max_range."""
    r2 = torch.sum(points * points, dim=-1)
    return (r2 >= min_range * min_range) & (r2 <= max_range * max_range)


def box_crop_mask(points, min_corner, max_corner):
    """True where points lie inside the axis-aligned box [min_corner,
    max_corner] (the reference's BoxFilter with its edges derived from
    origin and size at the call site)."""
    lo = torch.as_tensor(min_corner, dtype=points.dtype).to(points.device, non_blocking=True)
    hi = torch.as_tensor(max_corner, dtype=points.dtype).to(points.device, non_blocking=True)
    return torch.all((points >= lo) & (points <= hi), dim=-1)


def scatter_sum(target, index, values, keep):
    """A copy of `target` with the rows of `values` added at `index` [N]
    (index_add along dim 0) where `keep` [N] holds; other rows are dropped.

    The sums are taken in the same order on every run, each row as
    target[i] + v_first + ... + v_last in input order. On CUDA, index_put_
    with accumulate sorts the indices and adds each index's values in
    sequence, where index_add uses float atomics whose order, and thus
    rounding, changes from run to run. That sequence is serial per index,
    so each dropped row gets a scratch row of its own past the end (one
    shared row would gather every padded row into one serial run of ~1e5
    adds, ~10 ms on an H100). On the CPU, index_put_ adds in thread order,
    so there a stable sort of the kept indices lays each row out as its
    target value followed by its values in input order, and a segment sum
    adds them in that sequence: the one-thread index_put_'s result at any
    thread count."""
    if target.device.type == "cpu":
        return _scatter_sum_cpu(target, index, values, keep)
    n, rows = index.shape[0], target.shape[0]
    idx = torch.where(keep, index, rows + torch.arange(n, device=index.device))
    out = torch.cat([target, target.new_zeros((n, *target.shape[1:]))])
    return out.index_put_((idx,), values, accumulate=True)[:rows]


def _scatter_sum_cpu(target, index, values, keep):
    idx, perm = torch.sort(index[keep], stable=True)
    out = target.clone()
    if idx.numel() == 0:
        return out
    rows, counts = torch.unique_consecutive(idx, return_counts=True)
    lengths = counts + 1  # each segment: the target row, then its values
    starts = torch.cumsum(lengths, 0) - lengths
    data = values.new_empty((idx.numel() + rows.numel(), *values.shape[1:]))
    data[starts] = target[rows]
    segment = torch.repeat_interleave(torch.arange(rows.numel()), counts)
    data[torch.arange(idx.numel()) + segment + 1] = values[keep][perm]
    out[rows] = torch.segment_reduce(data, "sum", lengths=lengths, axis=0)
    return out


@contextlib.contextmanager
def one_torch_thread():
    """Torch's CPU ops on one thread while the block runs (yields the thread
    count before it). torch's CPU sums, matmuls and LAPACK factorizations
    split their work among its threads, so their float rounding follows
    torch.get_num_threads(); on one thread it follows the data's shape."""
    threads = torch.get_num_threads()
    if threads > 1:
        torch.set_num_threads(1)
    try:
        yield threads
    finally:
        if threads > 1:
            torch.set_num_threads(threads)


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


def voxel_downsample_dense(
    cloud: PointCloud,
    leaf_size,
    out_capacity: int,
    dims: Tuple[int, int, int] = (352, 352, 96),
) -> PointCloud:
    """Sort-free voxel-grid centroid downsampling over a bounded dense grid
    `dims` anchored at the cloud's min corner: per-voxel sums into the
    dense grid (`scatter_sum`), then the occupied cells compacted by
    cumsum + searchsorted, in flat-id (x-major) order, the order of
    `voxel_downsample`. Points outside origin + dims * leaf are dropped.
    Centroids match `voxel_downsample` to float32 summation order."""
    pts = cloud.points
    mask = cloud.mask
    w = cloud.get_weights()
    dev = pts.device
    leaf = torch.as_tensor(leaf_size, dtype=torch.float32)
    leaf = float(leaf) if leaf.ndim == 0 else leaf.to(dev, non_blocking=True)
    v = dims[0] * dims[1] * dims[2]

    coords = torch.floor(pts / leaf).to(torch.int32)
    cmin = torch.where(mask[:, None], coords, 2**20).amin(dim=0)
    rel = coords - cmin
    dims_t = torch.as_tensor(dims, dtype=torch.int32).to(dev, non_blocking=True)
    ok = mask & torch.all((rel >= 0) & (rel < dims_t), dim=-1)
    rel = rel.long()
    vid = torch.where(ok, (rel[:, 0] * dims[1] + rel[:, 1]) * dims[2] + rel[:, 2], v)

    zeros = torch.zeros(v, dtype=torch.float32, device=dev)
    counts = scatter_sum(zeros, vid, torch.ones_like(w), ok)
    sums = scatter_sum(torch.zeros((v, 3), device=dev), vid, pts, ok)
    wsums = scatter_sum(zeros, vid, w, ok)

    csum = torch.cumsum((counts > 0.0).to(torch.int32), dim=0, dtype=torch.int32)
    total = torch.clamp(csum[-1], max=out_capacity)
    j = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    keys = torch.searchsorted(csum, j + 1, side="left", out_int32=True)
    has = j < total
    kv = torch.where(has, keys, 0).long()

    cnt = torch.where(has, counts[kv], 0.0)
    denom = torch.clamp(cnt, min=1.0)
    centroids = torch.where(has[:, None], sums[kv] / denom[:, None], 0.0)
    wmeans = torch.where(has, wsums[kv] / denom, 1.0)
    return PointCloud(points=centroids, mask=has & (cnt > 0), weights=wmeans)


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
