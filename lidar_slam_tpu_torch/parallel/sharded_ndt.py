"""Point-sharded NDT registration and sharded map builds over a rank mesh
(port of lidar_slam_tpu/parallel/sharded_ndt.py).

Alignment: each rank reduces its strided shard of the padded source
points (rows rank, rank + W, ...) against the replicated map, one
`_reduce` per derivative evaluation (on the card kernel K1, `csrc/ndt_fused.cu`; K3 inside it under
gather="onehot"), the [32] sums meet in one `all_sum` on the device, and
one host copy feeds the host Newton loop (`newton_align`), which every
rank runs in lockstep on the same summed derivatives. A collective cannot
sit inside `ndt_newton`'s one cooperative launch, so the sharded path is
the K1-per-evaluation loop; single-rank paths keep `ndt_newton`. The
points are not sorted by voxel id before they are split (the JAX package
sorts for its TPU kernel's tiles; K1 gathers directly). The split is
strided, not contiguous as the JAX package's: a preprocessed frame holds its
valid rows first, so contiguous shards would leave the last ranks only
padding. Only the order of the sums differs.

Map builds: each rank scatters its points (or its keyframes) into
full-grid moment sums; `sum_scatter` adds them and leaves each rank one
contiguous slab of voxels, on which the moments and the covariance
conditioning run; the finished rows are gathered and packed (`_pack_rows`)
into the replicated map every rank then holds.

Per-rank work scales 1/N; the collectives carry 32 floats an evaluation,
and V x 11 (sums) plus V x 16 or 19 (rows) floats a map build.
"""

from __future__ import annotations

import torch

from ..models.registration.ndt import (
    NDTConfig,
    NDTMap,
    NDTResult,
    _condition_rows,
    _moments_from_sums,
    _pack_rows,
    _reduce,
    _to,
    empty_ndt_sums,
    newton_align,
    scatter_to_sums,
)
from ..ops.cuda.ndt_fused import unpack_results
from ..ops.pointcloud import PointCloud
from .collectives import all_gather, all_sum, sum_scatter
from .mesh import Mesh


def shard(x: torch.Tensor, mesh: Mesh, what: str) -> torch.Tensor:
    """This rank's strided share of `x` along dim 0 (rows rank, rank + W,
    ...), contiguous in memory; dim 0 must divide the mesh size."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"{what} {x.shape[0]} must divide mesh size {mesh.size}")
    return x[mesh.rank::mesh.size].contiguous()


def _voxel_count(config: NDTConfig, mesh: Mesh) -> int:
    v = config.grid_dims[0] * config.grid_dims[1] * config.grid_dims[2]
    if v % mesh.size:
        raise ValueError(f"voxel count {v} must divide mesh size {mesh.size}")
    return v


def _shards(source: PointCloud, mesh: Mesh):
    """This rank's strided (points, mask, weights) shard of a source cloud."""
    return tuple(shard(t, mesh, "point capacity") for t in (source.points, source.mask, source.get_weights()))


def _derivs(ndt_map: NDTMap, shards, config: NDTConfig, mesh: Mesh):
    """derivs(pose6, need_hessian) for newton_align: this rank's [32] sums,
    summed over the ranks on the device, then one host copy."""
    pts, msk, w = shards

    def derivs(pose, need_hessian):
        sums = _reduce(ndt_map, pts, msk, w, pose, config, need_hessian)
        return unpack_results(all_sum(sums, mesh).cpu().numpy())

    return derivs


def sharded_ndt_derivatives(ndt_map: NDTMap, source: PointCloud, pose, config: NDTConfig, mesh: Mesh):
    """One derivative evaluation at `pose` [6] with the points sharded over
    the mesh: (score, grad [6], hess [6, 6], unresolved) as host tensors.
    The point capacity must divide the mesh size."""
    if isinstance(pose, torch.Tensor):
        pose = pose.detach().cpu().numpy()
    out = _derivs(ndt_map, _shards(source, mesh), config, mesh)(pose, True)
    return tuple(torch.as_tensor(v) for v in out)


def sharded_ndt_align(ndt_map: NDTMap, source: PointCloud, init_pose, config: NDTConfig, mesh: Mesh) -> NDTResult:
    """ndt_align with the per-point reduction sharded over the mesh: the
    host Newton loop (newton_align, or lm_align for solver="lm") over
    sharded evaluations, in lockstep on every rank. The point capacity must
    divide the mesh size (padded points are masked and add zeros)."""
    derivs = _derivs(ndt_map, _shards(source, mesh), config, mesh)
    return newton_align(derivs, init_pose, config, source.num_valid())


def _slab_reduce_and_pack(sums, config: NDTConfig, mesh: Mesh) -> NDTMap:
    """Shared tail of the sharded map builders: this rank's full-grid partial
    sums -> the summed slab -> moments and conditioning on the slab -> the
    gathered rows packed into the replicated map."""
    v = _voxel_count(config, mesh)
    stacked = torch.cat([sums.count[:, None], sums.psum, sums.ppsum, sums.wsum[:, None]], dim=1)
    slab = sum_scatter(stacked, mesh)
    count, mean, cov, sv = _moments_from_sums(
        sums.origin, slab[:, 0], slab[:, 1:4], slab[:, 4:10], slab[:, 10], sums.dims, sums.resolution,
        vid_start=mesh.rank * (v // mesh.size),
    )
    rows, icov, _ = _condition_rows(count, mean, cov, sv, config)
    if config.dense_stats:
        rows = torch.cat([rows, icov[:, 1, 0:1], icov[:, 2, 0:2]], dim=1)
    rows = all_gather(rows, mesh)
    return _pack_rows(sums.origin, rows[:, :16], sums.dims, config, icov_lower=rows[:, 16:])


def sharded_build_ndt_map(cloud: PointCloud, origin, config: NDTConfig, mesh: Mesh) -> NDTMap:
    """build_ndt_map with the points sharded over the mesh and the
    per-voxel finalization over voxel slabs; every rank returns the whole
    map. The point capacity and the voxel count must divide the mesh size."""
    _voxel_count(config, mesh)
    pts, msk, wts = _shards(cloud, mesh)
    sums = empty_ndt_sums(origin, config, device=pts.device)
    return _slab_reduce_and_pack(scatter_to_sums(sums, pts, msk, wts), config, mesh)


def sharded_build_local_map(kf_points, kf_masks, kf_weights, kf_poses, kf_valid, origin, config: NDTConfig,
                            mesh: Mesh) -> NDTMap:
    """The front end's keyframe local map with the KEYFRAMES sharded over
    the mesh (strided, as the points are): each rank transforms and
    scatters its keyframes ([K, P, 3] sensor-frame clouds, [K, P] masks and
    weights, [K, 4, 4] poses, [K] valid flags); the voxel sums meet in the slab reduction. K and the
    voxel count must divide the mesh size."""
    _voxel_count(config, mesh)
    dev = kf_points.device
    pts_k = shard(kf_points, mesh, "keyframe count")
    poses = _to(shard(torch.as_tensor(kf_poses, dtype=torch.float32), mesh, "keyframe count"), dev)
    valid = _to(shard(torch.as_tensor(kf_valid, dtype=torch.bool), mesh, "keyframe count"), dev)
    world = torch.einsum("kij,kpj->kpi", poses[:, :3, :3], pts_k) + poses[:, None, :3, 3]
    k, p, _ = world.shape
    msk = (shard(kf_masks, mesh, "keyframe count") & valid[:, None]).reshape(k * p)
    wts = shard(kf_weights, mesh, "keyframe count").reshape(k * p)
    sums = empty_ndt_sums(origin, config, device=dev)
    return _slab_reduce_and_pack(scatter_to_sums(sums, world.reshape(k * p, 3), msk, wts), config, mesh)
