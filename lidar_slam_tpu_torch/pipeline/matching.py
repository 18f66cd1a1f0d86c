"""Map-matching localization against a prebuilt map, in PyTorch (port of
lidar_slam_tpu/pipeline/matching.py; Matching, matching.cpp:19-455, and
matching_flow.cpp:12-125).

Scans are localized in a prebuilt global map: GPF ground removal, a 0.5 m
voxel filter, then coarse-to-fine NDT against a box-cropped local map that
is re-cropped on the host when the pose nears the crop's edge. GNSS
initialization has two modes: FullPose (the GNSS pose is the first guess)
and OnlyPosition (the position, and the yaw of an exhaustive search over a
2-D Gaussian height map, matching.cpp:197-242, 267-308, 344-394).

On the card each NDT alignment of a frame is one `ndt_newton` launch and
one copy of its result (two a frame, coarse then fine). The yaw search
scores all `yaw_samples` rotations of the scan at once as [Y, N] tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import device as _default_device
from ..models.ground_seg import GroundSegConfig, segment_ground
from ..models.registration import NDTConfig, build_ndt_map, ndt_align
from ..models.registration.ndt import _to
from ..ops.pointcloud import PointCloud, finite_mask, scatter_sum, voxel_downsample

_f32 = np.float32


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    """Operating point of config/matching/matching.yaml; the same fields
    and defaults as the JAX package's MatchingConfig (see there for the
    reasoning behind each)."""

    ndt: NDTConfig = NDTConfig(resolution=1.0, grid_dims=(224, 224, 48), point_chunk=8192, gather="auto")
    frame_leaf: float = 0.5
    local_map_leaf: float = 0.3
    box_size: float = 200.0  # local map crop edge length
    refresh_margin: float = 50.0  # re-crop when this close to the edge
    local_map_capacity: int = 1 << 18
    frame_capacity: int = 32768
    raw_capacity: int = 131072
    # yaw-init height map (matching.cpp:344-394)
    cell_size: float = 0.8
    height_map_dim: int = 256  # cells per axis over the local map
    yaw_samples: int = 270
    yaw_agree_tol: float = 0.03  # two consecutive estimates must agree [rad]
    init_mode: str = "full_pose"  # 'full_pose' | 'only_position'
    coarse_to_fine: bool = True
    # GPF ground removal before matching: the reference's matching flow
    # consumes the GroundPlaneFit node's no-ground cloud (matching_flow.cpp:14)
    use_ground_seg: bool = True


def _frame(raw_pts, raw_msk, cfg: MatchingConfig) -> PointCloud:
    """A raw scan's finite points, less the ground (use_ground_seg), voxel
    filtered at frame_leaf into frame_capacity rows."""
    m = raw_msk & finite_mask(raw_pts)
    if cfg.use_ground_seg:
        _, nonground = segment_ground(
            PointCloud(points=torch.where(m[:, None], raw_pts, 0.0), mask=m), GroundSegConfig()
        )
        m = m & nonground
    return voxel_downsample(
        PointCloud(points=torch.where(m[:, None], raw_pts, 0.0), mask=m),
        cfg.frame_leaf,
        out_capacity=cfg.frame_capacity,
    )


def _match_step(fine_map, coarse_map, raw_pts, raw_msk, predict, cfg: MatchingConfig,
                coarse_cfg: Optional[NDTConfig]):
    """One localization frame (Matching::Update, matching.cpp:185-265):
    ground removal -> voxel filter -> coarse-to-fine NDT from `predict`
    [4, 4]. Returns (frame points, frame mask, pose [4, 4] host,
    unresolved)."""
    frame = _frame(raw_pts, raw_msk, cfg)
    guess, unresolved = predict, 0.0
    if coarse_cfg is not None:
        rc = ndt_align(coarse_map, frame, guess, coarse_cfg)
        guess, unresolved = rc.pose, rc.unresolved
    r = ndt_align(fine_map, frame, guess, cfg.ndt)
    return frame.points, frame.mask, r.pose, unresolved + r.unresolved


def matching_drive(fine_map, coarse_map, pts_seq, msk_seq, init_pose, cfg: MatchingConfig,
                   coarse_cfg: Optional[NDTConfig]):
    """Whole-sequence localization: _match_step frame after frame with the
    constant-velocity prediction, one host copy an alignment. Valid between
    local-map refreshes (the re-crop is a host decision: callers drive in
    chunks and refresh between them). Returns (poses [T, 4, 4] host,
    unresolved [T])."""
    cur = torch.as_tensor(np.asarray(init_pose, _f32))
    step = torch.eye(4)
    poses, unres = [], []
    for i in range(pts_seq.shape[0]):
        _, _, pose, u = _match_step(fine_map, coarse_map, pts_seq[i], msk_seq[i], cur @ step, cfg, coarse_cfg)
        step = torch.linalg.solve(cur, pose)
        cur = pose
        poses.append(pose)
        unres.append(u)
    return torch.stack(poses), torch.as_tensor(unres, dtype=torch.float32)


def _height_map(points, mask, origin, dim: int, cell: float):
    """Per-cell mean and standard deviation of z over the local map, and
    which cells are occupied (generateGauss2DMapCells); `origin` [2] is the
    map's corner on the points' device."""
    xy = torch.floor((points[:, :2] - origin) / cell).to(torch.int32)
    inb = torch.all((xy >= 0) & (xy < dim), dim=-1) & mask
    cid = torch.where(inb, xy[:, 0] * dim + xy[:, 1], 0).long()
    z = points[:, 2]
    zeros = torch.zeros(dim * dim, dtype=torch.float32, device=points.device)
    cnt = scatter_sum(zeros, cid, torch.ones_like(z), inb)
    sz = scatter_sum(zeros, cid, z, inb)
    szz = scatter_sum(zeros, cid, z**2, inb)
    n = torch.clamp(cnt, min=1.0)
    mu = sz / n
    var = torch.clamp(szz / n - mu * mu, min=1e-4)
    return mu, torch.sqrt(var), cnt > 0


def _yaw_search(scan_pts, scan_mask, position, mu, sigma, occ, origin, dim: int, cell: float, n_yaw: int):
    """Score every one of `n_yaw` yaw rotations of the scan against the
    height map at once (getInitialYawAngle, matching.cpp:267-308).
    Returns (best yaw, scores [n_yaw]) on the scan's device; the first of
    equal best scores wins, as in the JAX package."""
    dev = scan_pts.device
    yaws = torch.arange(n_yaw, dtype=torch.float32, device=dev) * (2.0 * math.pi / n_yaw)
    c, s = torch.cos(yaws), torch.sin(yaws)  # [Y]
    x, y, z = scan_pts[:, 0], scan_pts[:, 1], scan_pts[:, 2]
    # rotated world coordinates for every yaw: [Y, N]
    wx = c[:, None] * x[None, :] - s[:, None] * y[None, :] + position[0]
    wy = s[:, None] * x[None, :] + c[:, None] * y[None, :] + position[1]
    wz = z[None, :] + position[2]
    cx = torch.floor((wx - origin[0]) / cell).to(torch.int32)
    cy = torch.floor((wy - origin[1]) / cell).to(torch.int32)
    inb = (cx >= 0) & (cx < dim) & (cy >= 0) & (cy < dim) & scan_mask[None, :]
    cid = torch.where(inb, cx * dim + cy, 0).long()
    m = mu[cid]
    sd = sigma[cid]
    ok = inb & occ[cid]
    sc = torch.where(ok, torch.exp(-((wz - m) ** 2) / (2.0 * sd * sd)), 0.0)
    scores = torch.sum(sc, dim=-1)
    return yaws[torch.argmax(scores)], scores


class Matching:
    """Localization in a prebuilt map (the reference's Matching API)."""

    def __init__(self, config: MatchingConfig, global_map_points, device=None):
        """`global_map_points` [M, 3] (numpy) replaces InitGlobalMap's PCD
        load (matching.cpp:148-164): pass the viewer's filtered map. It
        stays on the host, where each refresh crops it."""
        self.cfg = config
        self.device = _default_device(device)
        self.global_map = np.asarray(global_map_points, _f32)
        self.local_map_origin: Optional[np.ndarray] = None
        self.crop_points = 0  # points inside the last crop box, before the capacity cut
        self.ndt_map = None
        self.coarse_ndt_map = None
        self._local_cloud = None
        self._pending_scan = None
        self.current_pose: Optional[np.ndarray] = None
        self.predict_step = np.eye(4, dtype=_f32)
        self._init = False
        self._last_yaw_estimate: Optional[float] = None
        self.reset_local_map(np.zeros(3, _f32))

    # -- local map ----------------------------------------------------------
    def reset_local_map(self, center: np.ndarray) -> None:
        """ResetLocalMap (matching.cpp:166-183): crop a box_size cube around
        `center` on the host, voxel filter it on the device and rebuild the
        fine and coarse NDT maps (no dense stats: only the align path reads
        them). Like the JAX package, a crop holding more than
        local_map_capacity points keeps the first local_map_capacity of them
        (`crop_points` says how many the box held)."""
        cfg = self.cfg
        half = cfg.box_size / 2.0
        center = np.asarray(center, _f32)
        sel = np.all((self.global_map >= center - half) & (self.global_map <= center + half), axis=1)
        self.crop_points = int(np.count_nonzero(sel))
        pts = self.global_map[sel][: cfg.local_map_capacity]
        cloud = PointCloud.from_points(pts, capacity=cfg.local_map_capacity, device=self.device)
        cloud = voxel_downsample(cloud, cfg.local_map_leaf, out_capacity=cfg.local_map_capacity)
        self._local_cloud = cloud
        self.ndt_map = build_ndt_map(cloud, dataclasses.replace(cfg.ndt, dense_stats=False))
        self.coarse_ndt_map = None
        if cfg.coarse_to_fine:
            self.coarse_ndt_map = build_ndt_map(cloud, dataclasses.replace(self._coarse_cfg(), dense_stats=False))
        self.local_map_origin = center.copy()

    def _coarse_cfg(self) -> NDTConfig:
        c = self.cfg.ndt
        return dataclasses.replace(
            c,
            resolution=c.resolution * 2.0,
            grid_dims=(c.grid_dims[0] // 2, c.grid_dims[1] // 2, c.grid_dims[2] // 2),
            max_iter=max(5, c.max_iter // 3),
            fused_window=min(c.fused_window, 1024),
        )

    def _maybe_refresh_local_map(self, position: np.ndarray) -> None:
        half = self.cfg.box_size / 2.0
        if np.any(np.abs(position - self.local_map_origin) > half - self.cfg.refresh_margin):
            self.reset_local_map(position)

    # -- initialization -----------------------------------------------------
    def set_gnss_pose(self, pose_or_position) -> bool:
        """SetGNSSPose (matching.cpp:310-342). FullPose takes a [4, 4]
        guess; OnlyPosition takes a [3] position (or a pose's) and estimates
        the yaw from the buffered scan, accepting it once two consecutive
        estimates agree within yaw_agree_tol."""
        arr = np.asarray(pose_or_position, _f32)
        if self.cfg.init_mode == "full_pose":
            if arr.shape != (4, 4):
                raise ValueError(f"full_pose initialization takes a [4, 4] pose, got shape {arr.shape}")
            self.current_pose = arr.copy()
            self._init = True
            return True

        position = arr[:3, 3] if arr.shape == (4, 4) else arr[:3]
        self.reset_local_map(position)
        yaw = self._initial_yaw(position)
        if self._last_yaw_estimate is not None and abs(yaw - self._last_yaw_estimate) < self.cfg.yaw_agree_tol:
            c, s = np.cos(yaw), np.sin(yaw)
            T = np.eye(4, dtype=_f32)
            T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], _f32)
            T[:3, 3] = position
            self.current_pose = T
            self._init = True
            self._pending_scan = None
            return True
        self._last_yaw_estimate = yaw
        return False

    def _initial_yaw(self, position) -> float:
        cfg = self.cfg
        cloud = self._local_cloud
        extent = cfg.height_map_dim * cfg.cell_size
        origin = _to(np.asarray(position[:2] - extent / 2.0, _f32), self.device)
        mu, sigma, occ = _height_map(cloud.points, cloud.mask, origin, cfg.height_map_dim, cfg.cell_size)
        scan = self._pending_scan
        if scan is None:
            return 0.0
        yaw, _ = _yaw_search(
            scan.points, scan.mask, _to(np.asarray(position, _f32), self.device), mu, sigma, occ, origin,
            cfg.height_map_dim, cfg.cell_size, cfg.yaw_samples,
        )
        return float(yaw)

    # -- per-frame update ---------------------------------------------------
    def preload(self, points, mask=None):
        """Pad to raw capacity and upload to the device."""
        cfg = self.cfg
        points = np.asarray(points, _f32)
        mask = np.ones(len(points), bool) if mask is None else np.asarray(mask, bool)
        n = min(len(points), cfg.raw_capacity)
        pts_fixed = np.zeros((cfg.raw_capacity, 3), _f32)
        msk_fixed = np.zeros(cfg.raw_capacity, bool)
        pts_fixed[:n] = points[:n]
        msk_fixed[:n] = mask[:n]
        return torch.from_numpy(pts_fixed).to(self.device), torch.from_numpy(msk_fixed).to(self.device)

    def update(self, points, mask=None, preloaded=None):
        """Matching::Update (matching.cpp:185-265). Returns the pose [4, 4]
        (numpy float32), or None while uninitialized (the scan is then
        buffered for the yaw search)."""
        cfg = self.cfg
        if preloaded is None:
            if isinstance(mask, torch.Tensor):
                mask = mask.cpu().numpy()
            preloaded = self.preload(points, mask)
        pj, mj = preloaded

        if not self._init:
            self._pending_scan = _frame(pj, mj, cfg)
            return None

        predict = self.current_pose @ self.predict_step
        use_coarse = cfg.coarse_to_fine and self.coarse_ndt_map is not None
        coarse_cfg = self._coarse_cfg() if use_coarse else None
        coarse_map = self.coarse_ndt_map if use_coarse else self.ndt_map
        _, _, pose, unresolved = _match_step(self.ndt_map, coarse_map, pj, mj, predict, cfg, coarse_cfg)
        # the kernels gather directly: the JAX package's exact-path redo of a
        # frame with dropped derivative terms can never trigger, so a
        # non-zero count is a bug, not a condition to handle
        if unresolved != 0.0:
            raise RuntimeError(f"NDT reduction dropped derivative terms (unresolved={unresolved})")
        pose = pose.numpy()
        self.predict_step = (np.linalg.inv(self.current_pose) @ pose).astype(_f32)
        self.current_pose = pose
        self._maybe_refresh_local_map(pose[:3, 3])
        return pose

    def has_inited(self) -> bool:
        return self._init
