"""A-LOAM frame-to-frame laser odometry, in PyTorch (port of
lidar_slam_tpu/pipeline/aloam/odometry.py; see there for the mapping to
laserOdometry.cpp and lidarFactor.hpp).

Per sweep: outer correspondence rounds, each followed by Gauss-Newton
iterations on the point-to-line (corner) and point-to-plane (flat)
residuals with Huber weights. The loops are Python loops over device ops
with no host synchronisation: the 6x6 solve is `torch.linalg.solve_ex`
(which does not check for errors on the host) and the finite-step guard is
a `torch.where` on the device.

Correspondence search: `knn="auto"` runs kernel K2 (`window_knn`) on CUDA
tensors and the bucket-grid `knn_query` on CPU tensors; `"fused"` always
takes `window_knn` (its plain version on the CPU), `"xla"` always
`knn_query`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ...geom.se3 import se3_exp, so3_hat, transform_points
from ...ops.cuda.knn_fused import window_knn
from ...ops.hashgrid import _flat_cell_id, build_bucket_grid, clip_to_grid, knn_query
from ...ops.pointcloud import PointCloud
from .feature_extraction import ScanFeatures


@dataclasses.dataclass(frozen=True)
class AloamOdometryConfig:
    """The same fields and defaults as the JAX package's config. The
    Hopper kernel reads neither `knn_window` nor `knn_tile` (they size the
    TPU kernel's windows); they stay so configurations carry over."""

    dist_sq_threshold: float = 25.0  # DISTANCE_SQ_THRESHOLD
    nearby_scan: float = 2.5  # NEARBY_SCAN
    outer_iters: int = 3
    gn_iters: int = 6
    huber_delta: float = 0.1  # ceres HuberLoss(0.1) (:300)
    grid_cell: float = 5.0
    grid_dims: Tuple[int, int, int] = (48, 48, 8)
    knn_k: int = 8
    bucket_k: int = 32
    chunk: int = 2048
    # correspondence search backend: 'xla' = stencil-gather knn_query;
    # 'fused' = kernel K2 (window_knn); 'auto' = K2 on CUDA, xla elsewhere
    knn: str = "auto"
    knn_window: int = 2048
    knn_tile: int = 128


def _use_fused(cfg, device) -> bool:
    if cfg.knn not in ("auto", "fused", "xla"):
        raise ValueError(f"unknown knn backend {cfg.knn!r}")
    return cfg.knn == "fused" or (cfg.knn == "auto" and torch.device(device).type == "cuda")


def _norm(x, keepdim: bool = False):
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def _take(a, j):
    """a[n, j[n]] for a [N, K, ...] and j [N]."""
    idx = j.reshape(-1, 1, *([1] * (a.ndim - 2))).expand(-1, 1, *a.shape[2:])
    return torch.gather(a, 1, idx)[:, 0]


def _neighbour_features(grid, tgt_pts, tgt_ring, query_pts, query_mask, cfg):
    """(cand_pts [N,k,3], cand_ring [N,k], dist [N,k], ok [N,k]) via the
    configured backend. K2 returns neighbour rows directly and is exact
    (no bucket_k truncation)."""
    if _use_fused(cfg, query_pts.device):
        r = window_knn(
            grid, query_pts, query_mask, k=cfg.knn_k,
            max_radius=float(np.sqrt(cfg.dist_sq_threshold)), extras=tgt_ring,
        )
        return r["pts"], r["extras"][..., 0], r["dist"], r["ok"]
    idx, dist, ok = knn_query(
        grid, query_pts, k=cfg.knn_k, max_radius=float(np.sqrt(np.float32(cfg.dist_sq_threshold))),
        bucket_k=cfg.bucket_k, chunk=cfg.chunk,
    )
    idx = idx.long()
    return tgt_pts[idx], tgt_ring[idx], dist, ok


def sort_by_cell(grid, points, mask):
    """Order that sorts points by their bucket-grid cell id (masked last),
    as a stable sort: it fixes the order of the normal-equation sums."""
    dims = grid.dims
    coords = clip_to_grid(torch.floor((points - grid.origin) / grid.cell_size).to(torch.int32), dims)
    cid = torch.where(mask, _flat_cell_id(coords, dims), 2**30)
    return torch.sort(cid, stable=True).indices


def _corner_correspondences(grid, tgt_pts, tgt_ring, query_pts, query_mask, cfg):
    """For each query corner: (a, b, valid) — NN + best adjacent-ring point
    (laserOdometry.cpp:299-384)."""
    cand_pts, cand_ring, dist, ok = _neighbour_features(grid, tgt_pts, tgt_ring, query_pts, query_mask, cfg)
    d2 = dist**2

    nn_ok = ok[:, 0] & (d2[:, 0] < cfg.dist_sq_threshold) & query_mask
    a = cand_pts[:, 0]
    ring_a = cand_ring[:, 0]

    ring_diff = torch.abs(cand_ring - ring_a[:, None]).to(torch.float32)
    second_ok = ok & (d2 < cfg.dist_sq_threshold) & (cand_ring != ring_a[:, None]) & (ring_diff <= cfg.nearby_scan)
    second_ok[:, 0] = False
    d2_second = torch.where(second_ok, d2, torch.inf)
    jbest = torch.argmin(d2_second, dim=-1)
    has_second = torch.isfinite(torch.amin(d2_second, dim=-1))
    b = _take(cand_pts, jbest)
    return a, b, nn_ok & has_second


def _plane_correspondences(grid, tgt_pts, tgt_ring, query_pts, query_mask, cfg):
    """For each query flat point: (a, b, c, valid) — NN + same-ring +
    adjacent-ring points (laserOdometry.cpp:387-482)."""
    cand_pts, cand_ring, dist, ok = _neighbour_features(grid, tgt_pts, tgt_ring, query_pts, query_mask, cfg)
    d2 = dist**2

    nn_ok = ok[:, 0] & (d2[:, 0] < cfg.dist_sq_threshold) & query_mask
    a = cand_pts[:, 0]
    ring_a = cand_ring[:, 0]

    gate = ok & (d2 < cfg.dist_sq_threshold)
    gate[:, 0] = False

    same = gate & (cand_ring == ring_a[:, None])
    d2_same = torch.where(same, d2, torch.inf)
    has_b = torch.isfinite(torch.amin(d2_same, dim=-1))
    b = _take(cand_pts, torch.argmin(d2_same, dim=-1))

    ring_diff = torch.abs(cand_ring - ring_a[:, None]).to(torch.float32)
    adj = gate & (cand_ring != ring_a[:, None]) & (ring_diff <= cfg.nearby_scan)
    d2_adj = torch.where(adj, d2, torch.inf)
    has_c = torch.isfinite(torch.amin(d2_adj, dim=-1))
    c = _take(cand_pts, torch.argmin(d2_adj, dim=-1))

    return a, b, c, nn_ok & has_b & has_c


def _huber_w(rnorm, delta):
    return torch.where(rnorm <= delta, 1.0, delta / torch.clamp(rnorm, min=1e-12))


def normal_equations(xp, J_r_about_p, r, valid, delta):
    """H, g from per-point residual Jacobians; J wrt twist = Jp @ [I, -hat(xp)]."""
    eye = torch.eye(3, dtype=xp.dtype, device=xp.device).expand(xp.shape[0], 3, 3)
    body = torch.cat([eye, -so3_hat(xp)], dim=-1)  # [N, 3, 6]
    J = J_r_about_p @ body  # [N, R, 6]  (R = residual dim)
    w = _huber_w(_norm(r), delta) * valid
    H = torch.einsum("n,nri,nrj->ij", w, J, J)
    g = torch.einsum("n,nri,nr->i", w, J, r)
    return H, g


def gauss_newton_update(H, g, T):
    """One damped step: T <- exp(-(H + 1e-4 I)^-1 g) T, with a non-finite
    step replaced by zero on the device (no host sync)."""
    H = H + 1e-4 * torch.eye(6, dtype=H.dtype, device=H.device)
    delta = -torch.linalg.solve_ex(H, g).result
    delta = torch.where(torch.all(torch.isfinite(delta)), delta, 0.0)
    return se3_exp(delta) @ T


def odometry_step(
    prev_sharp: PointCloud,
    prev_sharp_ring,
    prev_flat: PointCloud,
    prev_flat_ring,
    cur_sharp: PointCloud,
    cur_flat: PointCloud,
    T_rel_init,
    cfg: AloamOdometryConfig = AloamOdometryConfig(),
):
    """Estimate the current->previous relative transform [4, 4] (on the
    clouds' device)."""
    dev = cur_sharp.points.device
    corner_grid = build_bucket_grid(prev_sharp, cfg.grid_cell, cfg.grid_dims)
    surf_grid = build_bucket_grid(prev_flat, cfg.grid_cell, cfg.grid_dims)
    T = torch.as_tensor(T_rel_init, dtype=torch.float32).to(dev)

    if _use_fused(cfg, dev):
        # queries sorted by target cell at the initial estimate: the order of
        # every per-point sum below then matches the JAX package's K2 path
        cur_sharp = cur_sharp.permute(sort_by_cell(corner_grid, transform_points(T, cur_sharp.points), cur_sharp.mask))
        cur_flat = cur_flat.permute(sort_by_cell(surf_grid, transform_points(T, cur_flat.points), cur_flat.mask))

    for _ in range(cfg.outer_iters):
        # correspondences at the current estimate (TransformToStart)
        pc = transform_points(T, cur_sharp.points)
        a_e, b_e, v_e = _corner_correspondences(corner_grid, prev_sharp.points, prev_sharp_ring, pc, cur_sharp.mask, cfg)
        pf = transform_points(T, cur_flat.points)
        a_p, b_p, c_p, v_p = _plane_correspondences(surf_grid, prev_flat.points, prev_flat_ring, pf, cur_flat.mask, cfg)
        # plane normals fixed per outer round (as the factor precomputes them)
        n_raw = torch.linalg.cross(a_p - b_p, a_p - c_p)
        n_norm = _norm(n_raw, keepdim=True)
        n_hat = n_raw / torch.clamp(n_norm, min=1e-9)
        v_p2 = (v_p & (n_norm[:, 0] > 1e-9)).to(torch.float32)
        v_e = v_e.to(torch.float32)

        for _ in range(cfg.gn_iters):
            xe = transform_points(T, cur_sharp.points)
            ab = b_e - a_e
            ab_norm = torch.clamp(_norm(ab, keepdim=True), min=1e-9)
            r_e = torch.linalg.cross(xe - a_e, xe - b_e) / ab_norm  # [N, 3] (LidarEdgeFactor)
            H1, g1 = normal_equations(xe, so3_hat(ab) / ab_norm[..., None], r_e, v_e, cfg.huber_delta)

            xf = transform_points(T, cur_flat.points)
            r_p = torch.sum(n_hat * (xf - a_p), dim=-1, keepdim=True)  # [N, 1]
            H2, g2 = normal_equations(xf, n_hat[:, None, :], r_p, v_p2, cfg.huber_delta)
            T = gauss_newton_update(H1 + H2, g1 + g2, T)
    return T


class AloamOdometry:
    """Host wrapper holding the previous frame's features and world pose.
    Each update copies the relative pose to the host (one sync)."""

    def __init__(self, config: AloamOdometryConfig = AloamOdometryConfig()):
        self.cfg = config
        self.T_world = np.eye(4, dtype=np.float32)
        self.T_rel = np.eye(4, dtype=np.float32)  # constant-velocity warm start
        self._prev: Optional[ScanFeatures] = None

    def update(self, features: ScanFeatures) -> np.ndarray:
        """Feed one sweep's features; returns the world pose of this sweep."""
        if self._prev is not None:
            T_rel = odometry_step(
                self._prev.less_sharp,
                self._prev.less_sharp_ring,
                self._prev.less_flat,
                self._prev.less_flat_ring,
                features.sharp,
                features.flat,
                self.T_rel,
                self.cfg,
            )
            self.T_rel = T_rel.cpu().numpy()
            self.T_world = (self.T_world @ self.T_rel).astype(np.float32)
        self._prev = features
        return self.T_world.copy()
