"""A-LOAM scan-to-map refinement, in PyTorch (port of
lidar_slam_tpu/pipeline/aloam/mapping.py; see there for the mapping to
laserMapping.cpp).

The corner/surf feature maps are flat fixed-capacity world-frame clouds,
voxel-downsampled and box-cropped around the sensor on every fold. Corner
factors come from a 5-NN line test (closed-form 3x3 eigendecomposition),
surf factors from a 5-NN plane fit (adjugate 3x3 solve); Gauss-Newton with
Huber weights refines the pose. As in odometry, nothing here synchronises
with the host, and `knn="auto"` runs kernel K2 on CUDA tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ... import device as _default_device
from ...geom.se3 import so3_hat, transform_points
from ...ops.cuda.knn_fused import window_knn
from ...ops.eigh3 import sym_eigh3
from ...ops.hashgrid import build_bucket_grid, knn_query
from ...ops.linalg3 import solve3
from ...ops.pointcloud import PointCloud, voxel_downsample
from .feature_extraction import ScanFeatures
from .odometry import _norm, _use_fused, gauss_newton_update, normal_equations, sort_by_cell


@dataclasses.dataclass(frozen=True)
class AloamMappingConfig:
    """The same fields and defaults as the JAX package's config (the Hopper
    kernel reads neither `knn_window` nor `knn_tile`)."""

    line_res: float = 0.4  # mapping_line_resolution (HDL-64 launch)
    plane_res: float = 0.8  # mapping_plane_resolution
    corner_map_capacity: int = 65536
    surf_map_capacity: int = 131072
    crop_radius: float = 150.0  # keep map points within this box of the pose
    nn_radius: float = 1.0  # 5-NN gate: sqDist[4] < 1.0 (laserMapping.cpp:575,645)
    outer_iters: int = 2
    gn_iters: int = 4
    huber_delta: float = 0.1
    eig_ratio: float = 3.0  # line test (:594)
    plane_tol: float = 0.2  # plane validity (:672)
    grid_cell: float = 1.0
    grid_dims: Tuple[int, int, int] = (192, 192, 32)
    knn_k: int = 5
    bucket_k: int = 16
    chunk: int = 2048
    # correspondence search backend: 'xla' | 'fused' | 'auto' (K2 on CUDA)
    knn: str = "auto"
    knn_window: int = 2048
    knn_tile: int = 128
    # incoming feature stacks are voxel-downsampled at line/plane res before
    # matching and folding (downSizeFilterCorner/Surf, laserMapping.cpp:556-566)
    stack_corner_capacity: int = 8192
    stack_surf_capacity: int = 16384


def _unweighted(cloud: PointCloud) -> PointCloud:
    return PointCloud(points=cloud.points, mask=cloud.mask)


def downsample_stacks(cur_corner: PointCloud, cur_surf: PointCloud, cfg: AloamMappingConfig):
    """The corner/surf *stacks* — current features voxel-downsampled at the
    map resolutions — are what both scan-to-map matching and the map fold
    consume (laserCloudCornerStack/SurfStack, laserMapping.cpp:556-566)."""
    c = voxel_downsample(cur_corner, cfg.line_res, out_capacity=cfg.stack_corner_capacity)
    s = voxel_downsample(cur_surf, cfg.plane_res, out_capacity=cfg.stack_surf_capacity)
    return _unweighted(c), _unweighted(s)


def mapping_step(
    corner_map: PointCloud,
    surf_map: PointCloud,
    cur_corner: PointCloud,
    cur_surf: PointCloud,
    T_init,
    cfg: AloamMappingConfig = AloamMappingConfig(),
):
    """Refine T (sensor->map) [4, 4] against the feature maps."""
    dev = cur_corner.points.device
    corner_grid = build_bucket_grid(corner_map, cfg.grid_cell, cfg.grid_dims)
    surf_grid = build_bucket_grid(surf_map, cfg.grid_cell, cfg.grid_dims)
    k = cfg.knn_k
    use_fused = _use_fused(cfg, dev)
    T = torch.as_tensor(T_init, dtype=torch.float32).to(dev)

    if use_fused:
        cur_corner = cur_corner.permute(sort_by_cell(corner_grid, transform_points(T, cur_corner.points), cur_corner.mask))
        cur_surf = cur_surf.permute(sort_by_cell(surf_grid, transform_points(T, cur_surf.points), cur_surf.mask))

    def nn5(grid_, map_, queries, qmask):
        """(nn [N,k,3], ok [N,k]) via the configured backend."""
        if use_fused:
            r = window_knn(grid_, queries, qmask, k=k, max_radius=cfg.nn_radius)
            return r["pts"], r["ok"]
        idx, _, ok = knn_query(grid_, queries, k=k, max_radius=cfg.nn_radius, bucket_k=cfg.bucket_k, chunk=cfg.chunk)
        return map_.points[idx.long()], ok

    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    for _ in range(cfg.outer_iters):
        # corner: line fit over 5-NN (laserMapping.cpp:571-621)
        nn, ok = nn5(corner_grid, corner_map, transform_points(T, cur_corner.points), cur_corner.mask)
        all5 = torch.all(ok, dim=-1) & cur_corner.mask
        cen = torch.mean(nn, dim=1)
        d = nn - cen[:, None, :]
        cov = torch.einsum("nki,nkj->nij", d, d) / k
        evals, evecs = sym_eigh3(cov)
        is_line = evals[:, 2] > cfg.eig_ratio * evals[:, 1]
        dirv = evecs[:, :, 2]
        a_e = cen + 0.1 * dirv
        b_e = cen - 0.1 * dirv
        v_e = (all5 & is_line).to(torch.float32)

        # surf: plane fit A n = -1 over 5-NN (:643-688)
        nns, ok_s = nn5(surf_grid, surf_map, transform_points(T, cur_surf.points), cur_surf.mask)
        all5_s = torch.all(ok_s, dim=-1) & cur_surf.mask
        AtA = torch.einsum("nki,nkj->nij", nns, nns) + 1e-6 * eye3
        Atb = -torch.sum(nns, dim=1)  # A^T * (-1 vector)
        n_raw = solve3(AtA, Atb)
        n_norm = _norm(n_raw, keepdim=True)
        n_hat = n_raw / torch.clamp(n_norm, min=1e-9)
        d_plane = 1.0 / torch.clamp(n_norm[:, 0], min=1e-9)
        fit_ok = torch.all(
            torch.abs(torch.einsum("nki,ni->nk", nns, n_hat) + d_plane[:, None]) <= cfg.plane_tol, dim=-1
        )
        v_p = (all5_s & fit_ok).to(torch.float32)

        for _ in range(cfg.gn_iters):
            xe = transform_points(T, cur_corner.points)
            ab = b_e - a_e
            ab_n = torch.clamp(_norm(ab, keepdim=True), min=1e-9)
            r_e = torch.linalg.cross(xe - a_e, xe - b_e) / ab_n
            H1, g1 = normal_equations(xe, so3_hat(ab) / ab_n[..., None], r_e, v_e, cfg.huber_delta)

            xf = transform_points(T, cur_surf.points)
            r_p = (torch.sum(n_hat * xf, dim=-1) + d_plane)[:, None]
            H2, g2 = normal_equations(xf, n_hat[:, None, :], r_p, v_p, cfg.huber_delta)
            T = gauss_newton_update(H1 + H2, g1 + g2, T)
    return T


def map_update(
    corner_map: PointCloud,
    surf_map: PointCloud,
    cur_corner: PointCloud,
    cur_surf: PointCloud,
    T,
    cfg: AloamMappingConfig = AloamMappingConfig(),
):
    """Fold the registered features into the maps: transform, append,
    voxel-downsample at lineRes/planeRes, crop around the pose
    (laserMapping.cpp:737-800, 905-910)."""
    pos = T[:3, 3]

    def fold(m: PointCloud, cur: PointCloud, leaf: float, cap: int) -> PointCloud:
        pts = torch.cat([m.points, transform_points(T, cur.points)], dim=0)
        msk = torch.cat([m.mask, cur.mask], dim=0)
        inside = torch.all(torch.abs(pts - pos) <= cfg.crop_radius, dim=-1)
        return _unweighted(voxel_downsample(PointCloud(points=pts, mask=msk & inside), leaf, out_capacity=cap))

    new_corner = fold(corner_map, cur_corner, cfg.line_res, cfg.corner_map_capacity)
    new_surf = fold(surf_map, cur_surf, cfg.plane_res, cfg.surf_map_capacity)
    return new_corner, new_surf


class AloamMapping:
    """Host wrapper: map state + map->odom correction (transformAssociateToMap).
    Each update copies the refined pose to the host (one sync)."""

    def __init__(self, config: AloamMappingConfig = AloamMappingConfig(), device=None):
        self.cfg = config
        dev = _default_device(device)
        self.corner_map = PointCloud(
            points=torch.zeros((config.corner_map_capacity, 3), device=dev),
            mask=torch.zeros(config.corner_map_capacity, dtype=torch.bool, device=dev),
        )
        self.surf_map = PointCloud(
            points=torch.zeros((config.surf_map_capacity, 3), device=dev),
            mask=torch.zeros(config.surf_map_capacity, dtype=torch.bool, device=dev),
        )
        self.T_map_odom = np.eye(4, dtype=np.float32)  # wmap_T_wodom
        self._initialized = False

    def update(self, features: ScanFeatures, T_odom) -> np.ndarray:
        """Refine the odometry pose against the map; returns the map-frame
        pose. `features`: the sweep's less_sharp/less_flat clouds."""
        T_odom = np.asarray(T_odom, np.float32)
        guess = self.T_map_odom @ T_odom  # transformAssociateToMap
        cur_corner, cur_surf = downsample_stacks(features.less_sharp, features.less_flat, self.cfg)
        if self._initialized:
            T_map = mapping_step(self.corner_map, self.surf_map, cur_corner, cur_surf, guess, self.cfg)
            T_map = T_map.cpu().numpy()
        else:
            T_map = guess
            self._initialized = True
        dev = self.corner_map.points.device
        self.corner_map, self.surf_map = map_update(
            self.corner_map, self.surf_map, cur_corner, cur_surf, torch.as_tensor(T_map).to(dev), self.cfg
        )
        self.T_map_odom = (T_map @ np.linalg.inv(T_odom)).astype(np.float32)  # transformUpdate
        return T_map
