"""The A-LOAM pipeline step, in PyTorch (port of
lidar_slam_tpu/pipeline/aloam/pipeline.py): feature extraction ->
frame-to-frame odometry -> scan-to-map refinement -> map fold, over an
explicit device-resident state.

The JAX package compiles a sweep into one device program and a batch into
one `lax.scan`. Here a sweep is a stream of device ops and kernel launches
that never waits for the device: the first-sweep and has-map selections are
`torch.where`s on device flags, and the 4x4 inverse is `inv_ex`. So the
only synchronisations are the pose copies: one per sweep in `update`, one
per batch in `update_batch`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ... import device as _default_device
from ...ops.pointcloud import PointCloud
from .feature_extraction import FeatureExtractionConfig, ScanFeatures, extract_features
from .mapping import AloamMappingConfig, downsample_stacks, map_update, mapping_step
from .odometry import AloamOdometryConfig, odometry_step


@dataclasses.dataclass
class AloamState:
    """Cross-sweep state of the pipeline (device tensors). A step returns a
    new state and never modifies the tensors of the one it was given."""

    prev_less_sharp: PointCloud
    prev_less_sharp_ring: torch.Tensor
    prev_less_flat: PointCloud
    prev_less_flat_ring: torch.Tensor
    T_rel: torch.Tensor  # [4, 4] constant-velocity warm start
    T_world: torch.Tensor  # [4, 4] odometry world pose (q_w_curr/t_w_curr)
    T_map_odom: torch.Tensor  # [4, 4] wmap_T_wodom (transformAssociateToMap)
    corner_map: PointCloud
    surf_map: PointCloud
    has_prev: torch.Tensor  # [] bool — odometry valid from the 2nd sweep
    map_init: torch.Tensor  # [] bool — mapping valid once the map has content


def init_aloam_state(fe_cfg: FeatureExtractionConfig, map_cfg: AloamMappingConfig, device=None) -> AloamState:
    dev = _default_device(device)
    eye = torch.eye(4, dtype=torch.float32, device=dev)

    def empty(cap):
        return PointCloud(
            points=torch.zeros((cap, 3), dtype=torch.float32, device=dev),
            mask=torch.zeros(cap, dtype=torch.bool, device=dev),
        )

    return AloamState(
        prev_less_sharp=empty(fe_cfg.max_less_sharp),
        prev_less_sharp_ring=torch.zeros(fe_cfg.max_less_sharp, dtype=torch.int32, device=dev),
        prev_less_flat=empty(fe_cfg.max_less_flat),
        prev_less_flat_ring=torch.zeros(fe_cfg.max_less_flat, dtype=torch.int32, device=dev),
        T_rel=eye,
        T_world=eye,
        T_map_odom=eye,
        corner_map=empty(map_cfg.corner_map_capacity),
        surf_map=empty(map_cfg.surf_map_capacity),
        has_prev=torch.zeros((), dtype=torch.bool, device=dev),
        map_init=torch.zeros((), dtype=torch.bool, device=dev),
    )


def aloam_step(
    state: AloamState,
    points,  # [capacity, 3] padded sweep
    mask,  # [capacity]
    fe_cfg: FeatureExtractionConfig,
    odo_cfg: AloamOdometryConfig,
    map_cfg: AloamMappingConfig,
) -> Tuple[AloamState, torch.Tensor, torch.Tensor]:
    """One sweep end-to-end. Returns (new state, T_map [4,4], T_odom [4,4])."""
    f: ScanFeatures = extract_features(points, mask, fe_cfg)

    # frame-to-frame odometry vs the previous sweep's less-sharp/less-flat
    # features (laserOdometry.cpp:278-506). The first sweep has no previous
    # features: the step still runs (masked empty clouds give no
    # correspondences) and the identity is selected on the device.
    T_rel = odometry_step(
        state.prev_less_sharp,
        state.prev_less_sharp_ring,
        state.prev_less_flat,
        state.prev_less_flat_ring,
        f.sharp,
        f.flat,
        state.T_rel,
        odo_cfg,
    )
    eye = torch.eye(4, dtype=torch.float32, device=T_rel.device)
    T_rel = torch.where(state.has_prev, T_rel, eye)
    T_world = state.T_world @ T_rel

    # scan-to-map refinement (laserMapping.cpp:571-727) on the res-matched
    # feature stacks (downSizeFilterCorner/Surf, :556-566)
    guess = state.T_map_odom @ T_world
    stack_corner, stack_surf = downsample_stacks(f.less_sharp, f.less_flat, map_cfg)
    T_map = mapping_step(state.corner_map, state.surf_map, stack_corner, stack_surf, guess, map_cfg)
    T_map = torch.where(state.map_init, T_map, guess)
    corner_map, surf_map = map_update(state.corner_map, state.surf_map, stack_corner, stack_surf, T_map, map_cfg)
    # transformUpdate (laserMapping.cpp:148-152): wmap_T_wodom correction
    T_map_odom = T_map @ torch.linalg.inv_ex(T_world).inverse

    done = torch.ones((), dtype=torch.bool, device=T_rel.device)
    new_state = AloamState(
        prev_less_sharp=f.less_sharp,
        prev_less_sharp_ring=f.less_sharp_ring,
        prev_less_flat=f.less_flat,
        prev_less_flat_ring=f.less_flat_ring,
        T_rel=T_rel,
        T_world=T_world,
        T_map_odom=T_map_odom,
        corner_map=corner_map,
        surf_map=surf_map,
        has_prev=done,
        map_init=done,
    )
    return new_state, T_map, T_world


def aloam_drive(
    state: AloamState,
    points_seq,  # [T, capacity, 3]
    mask_seq,  # [T, capacity]
    fe_cfg: FeatureExtractionConfig,
    odo_cfg: AloamOdometryConfig,
    map_cfg: AloamMappingConfig,
) -> Tuple[AloamState, torch.Tensor]:
    """Chain a sweep sequence through `aloam_step`, sweep after sweep, with
    no host synchronisation. Returns (final state, T_map poses [T, 4, 4] on
    the device)."""
    poses = []
    for pts, msk in zip(points_seq, mask_seq):
        state, T_map, _ = aloam_step(state, pts, msk, fe_cfg, odo_cfg, map_cfg)
        poses.append(T_map)
    return state, torch.stack(poses)


class AloamPipeline:
    """Host wrapper over the step — the one-process form of the three-node
    A-LOAM launch graph (mapping_with_aloam.launch)."""

    def __init__(
        self,
        fe_cfg: FeatureExtractionConfig = FeatureExtractionConfig(),
        odo_cfg: AloamOdometryConfig = AloamOdometryConfig(),
        map_cfg: AloamMappingConfig = AloamMappingConfig(),
        device=None,
    ):
        self.fe_cfg = fe_cfg
        self.odo_cfg = odo_cfg
        self.map_cfg = map_cfg
        self.device = _default_device(device)
        self.state = init_aloam_state(fe_cfg, map_cfg, self.device)
        self.T0 = np.eye(4, dtype=np.float32)

    def set_init_pose(self, pose) -> None:
        self.T0 = np.asarray(pose, np.float32)

    def preload(self, points, mask=None):
        """Pad one sweep to capacity and start its upload. On a GPU the copy
        goes through pinned memory without blocking the host, so it can
        overlap the device work of the previous sweep."""
        cap = self.fe_cfg.capacity
        points = np.asarray(points, np.float32)
        n = min(len(points), cap)
        pts = torch.zeros((cap, 3), dtype=torch.float32)
        msk = torch.zeros(cap, dtype=torch.bool)
        pts[:n] = torch.from_numpy(points[:n])
        msk[:n] = True if mask is None else torch.from_numpy(np.asarray(mask, bool)[:n])
        if self.device.type == "cuda":
            return pts.pin_memory().to(self.device, non_blocking=True), msk.pin_memory().to(
                self.device, non_blocking=True
            )
        return pts.to(self.device), msk.to(self.device)

    def update(self, points, mask=None, bboxes=None, preloaded=None):
        """FrontEnd-compatible API: raw sweep in, world pose out (one sync)."""
        pts, msk = preloaded if preloaded is not None else self.preload(points, mask)
        self.state, T_map, _ = aloam_step(self.state, pts, msk, self.fe_cfg, self.odo_cfg, self.map_cfg)
        return (self.T0 @ T_map.cpu().numpy()).astype(np.float32), False

    def update_batch(self, frames):
        """Feed a list of (points, mask) sweeps through `aloam_drive`; returns
        world poses [T, 4, 4] with one synchronising copy. Sequential
        semantics are identical to repeated update() calls."""
        loaded = [self.preload(p, m) for p, m in frames]
        self.state, T_maps = aloam_drive(
            self.state, [p for p, _ in loaded], [m for _, m in loaded], self.fe_cfg, self.odo_cfg, self.map_cfg
        )
        return np.einsum("ij,tjk->tik", self.T0, T_maps.cpu().numpy()).astype(np.float32)
