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

A sweep is traced in the run's tracer (`utils/watchdog.py`): spans
`aloam.features`, `aloam.odometry`, `aloam.mapping` (the stacks and the
scan-to-map refinement) and `aloam.fold` (the map fold and the map->odom
correction), each with its host issue time and, on the card, the card's
time between CUDA events at its ends (nothing waits on the card before
the pose's copy, so where the host issues slower than the card runs, that
is about the issue time too); `aloam.step` from the sweep's hand-over to
its pose's copy. The counters ride on that copy, so they cost no sync of their own:
`aloam_sweeps`; `aloam_capped`, selected feature rows and stack voxels that
a cap cut off; `aloam_map_evicted` and `aloam_map_evicted_in_window`,
voxels a full map's fold evicted (`mapping.keep_near`), all and those
inside laserMapping's window; `aloam_corner_map` and `aloam_surf_map`,
counted as each fold's change, so that a run's total is the maps'
occupancy after its last fold, and `aloam_corner_map_peak` and
`aloam_surf_map_peak`, whose totals are the largest occupancy the run saw.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ... import device as _default_device
from ...ops.pointcloud import PointCloud
from ...utils import watchdog
from .feature_extraction import FeatureExtractionConfig, ScanFeatures, extract_features
from .mapping import AloamMappingConfig, downsample_stacks, map_update, mapping_step
from .odometry import AloamOdometryConfig, odometry_step


@dataclasses.dataclass(frozen=True)
class AloamConfig:
    """The `aloam` section of the CLI's YAML: a sub-section for each stage's
    own config, under its own keys. A-LOAM's launch parameters
    (aloam_velodyne_HDL_64.launch) are `features.n_scans` (scan_line),
    `features.min_range` (minimum_range), `mapping.line_res` and
    `mapping.plane_res` (mapping_line_resolution, mapping_plane_resolution);
    the port maps every sweep, the launch's skip 1. `features.capacity` is
    the padded sweep's rows. A key left out keeps the value below: the CLI's
    A-LOAM front end before the section existed."""

    features: FeatureExtractionConfig = FeatureExtractionConfig(min_range=2.5, max_less_flat=16384)
    odometry: AloamOdometryConfig = AloamOdometryConfig()
    mapping: AloamMappingConfig = AloamMappingConfig()


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
) -> Tuple[AloamState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One sweep end-to-end, traced. Returns (new state, T_map [4,4],
    T_odom [4,4], counts [5] int32 on the device: rows capped, voxels
    evicted, those inside the window, and the corner and surf maps'
    occupancy after the fold)."""
    dev = points.device
    with watchdog.span("aloam.features", device=dev):
        f: ScanFeatures = extract_features(points, mask, fe_cfg)

    # frame-to-frame odometry vs the previous sweep's less-sharp/less-flat
    # features (laserOdometry.cpp:278-506). The first sweep has no previous
    # features: the step still runs (masked empty clouds give no
    # correspondences) and the identity is selected on the device.
    with watchdog.span("aloam.odometry", device=dev):
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
    with watchdog.span("aloam.mapping", device=dev):
        guess = state.T_map_odom @ T_world
        stack_corner, stack_surf, stack_cut = downsample_stacks(f.less_sharp, f.less_flat, map_cfg)
        T_map = mapping_step(state.corner_map, state.surf_map, stack_corner, stack_surf, guess, map_cfg)
        T_map = torch.where(state.map_init, T_map, guess)
    with watchdog.span("aloam.fold", device=dev):
        corner_map, surf_map, evicted, in_window = map_update(
            state.corner_map, state.surf_map, stack_corner, stack_surf, T_map, map_cfg)
        # transformUpdate (laserMapping.cpp:148-152): wmap_T_wodom correction
        T_map_odom = T_map @ torch.linalg.inv_ex(T_world).inverse
        counts = torch.stack([f.capped + stack_cut, evicted.sum(), in_window.sum(), corner_map.num_valid(),
                              surf_map.num_valid()])

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
    return new_state, T_map, T_world, counts


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
        state, T_map, _, _ = aloam_step(state, pts, msk, fe_cfg, odo_cfg, map_cfg)
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
        self._maps = [0, 0, 0, 0]  # corner and surf occupancy after the last fold, then their peaks

    def set_init_pose(self, pose) -> None:
        self.T0 = np.asarray(pose, np.float32)

    def preload(self, points, mask=None):
        """Pad one sweep to capacity and start its upload. On a GPU the copy
        goes through pinned memory without blocking the host, so it can
        overlap the device work of the previous sweep."""
        cap = self.fe_cfg.capacity
        points = np.asarray(points, np.float32)
        n = len(points)
        if n > cap:
            raise ValueError(f"a sweep of {n} returns is over the padded sweep's {cap} rows: raise the "
                             f"configuration's aloam.features.capacity (a sweep is never cut)")
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
        """FrontEnd-compatible API: raw sweep in, world pose out (one sync:
        the pose and the sweep's counts in one copy)."""
        with watchdog.span("aloam.step"):
            pts, msk = preloaded if preloaded is not None else self.preload(points, mask)
            self.state, T_map, _, counts = aloam_step(self.state, pts, msk, self.fe_cfg, self.odo_cfg, self.map_cfg)
            out = torch.cat([T_map.reshape(-1).to(torch.float64), counts.to(torch.float64)]).cpu().numpy()
            T_map = out[:16].astype(np.float32).reshape(4, 4)
            self._count([int(c) for c in out[16:]])
        return (self.T0 @ T_map).astype(np.float32), False

    def _count(self, counts) -> None:
        capped, evicted, in_window, corner, surf = counts
        watchdog.count("aloam_sweeps")
        for name, n in (("aloam_capped", capped), ("aloam_map_evicted", evicted),
                        ("aloam_map_evicted_in_window", in_window)):
            watchdog.count(name, n)
        prev = self._maps
        self._maps = [corner, surf, max(prev[2], corner), max(prev[3], surf)]
        for name, a, b in zip(("aloam_corner_map", "aloam_surf_map", "aloam_corner_map_peak", "aloam_surf_map_peak"),
                              prev, self._maps):
            watchdog.count(name, b - a)

    def update_batch(self, frames):
        """Feed a list of (points, mask) sweeps through `aloam_drive`; returns
        world poses [T, 4, 4] with one synchronising copy. Sequential
        semantics are identical to repeated update() calls."""
        loaded = [self.preload(p, m) for p, m in frames]
        self.state, T_maps = aloam_drive(
            self.state, [p for p, _ in loaded], [m for _, m in loaded], self.fe_cfg, self.odo_cfg, self.map_cfg
        )
        return np.einsum("ij,tjk->tik", self.T0, T_maps.cpu().numpy()).astype(np.float32)
