"""Front end: scan-to-local-map odometry with static-point weighting, in
PyTorch (port of lidar_slam_tpu/pipeline/front_end.py).

  preprocess (finite mask + voxel downsample)
   -> coarse (2x resolution) then fine NDT alignment from the motion-model
      predicted pose (front_end.cpp:225-241)
   -> keyframe every `key_frame_distance` metres of L1 motion (243-245)
   -> static-point weighting of detector bboxes on new keyframes (250-327)
   -> incremental voxel-moment map maintenance (VoxelGrid.cpp:545-809), or
      (incremental_map=False) the local map rebuilt from the last
      `local_frame_num` keyframes (front_end.cpp:348-424)

The JAX package fuses each frame into one device program (`lax.scan` and
`lax.cond`); here the per-frame control is a host loop and host `if`s,
and the device work is torch ops plus one `ndt_newton` launch for each
alignment. Poses live on the host (each alignment's result is copied there
once); clouds, maps
and keyframe buffers live on the device. Incremental map maintenance is
deferred by one frame, as in the JAX package. `FrontEnd.restore` rebuilds
the tracking state from stored keyframes (session resume).

With `mesh=` (FrontEnd, front_end_drive) every alignment is point-sharded
over the mesh's ranks (parallel/sharded_ndt.py: a K1 launch an evaluation
on each rank, the sums meeting in one collective) while the map
maintenance runs replicated on every rank, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from .. import device as _default_device
from ..models.registration import (
    NDTConfig,
    build_ndt_map,
    coarsen_ndt_sums,
    empty_ndt_sums,
    finalize_ndt_sums,
    ndt_align,
    recenter_ndt_sums,
    scatter_to_sums,
)
from ..models.registration.ndt import _to
from ..ops.pointcloud import PointCloud, finite_mask, rotated_box_mask, voxel_downsample
from ..parallel.sharded_ndt import sharded_ndt_align
from ..utils import watchdog

_f32 = np.float32


@dataclasses.dataclass(frozen=True)
class FrontEndConfig:
    """Operating point of config/mapping/front_end.yaml; the same fields and
    defaults as the JAX package's FrontEndConfig. `ndt.gather="auto"` runs
    each alignment as one `ndt_newton` launch for CUDA tensors, and the host
    loop over the plain reduction for CPU tensors."""

    ndt: NDTConfig = NDTConfig(gather="auto")
    raw_capacity: int = 131072
    coarse_to_fine: bool = True
    frame_leaf: float = 0.5
    local_map_leaf: float = 0.3
    key_frame_distance: float = 2.0
    local_frame_num: int = 20
    local_map_filter_min_frames: int = 10
    frame_capacity: int = 32768
    keyframe_capacity: int = 16384
    bbox_score_thresh: float = 0.5
    bbox_match_radius: float = 3.3
    bbox_weight_base: float = 5.0 / 12.0
    max_bboxes: int = 40
    max_map_bboxes: int = 200
    incremental_map: bool = True


def _preprocess(points, mask, capacity: int, leaf: float) -> PointCloud:
    m = mask & finite_mask(points)
    cloud = PointCloud(points=torch.where(m[:, None], points, 0.0), mask=m)
    return voxel_downsample(cloud, leaf, out_capacity=capacity)


def coarse_tracking_cfg(c: NDTConfig) -> NDTConfig:
    """THE coarse-pass config for every tracking path: 2x resolution, half
    dims, full max_iter, no dense stats."""
    return dataclasses.replace(
        c,
        resolution=c.resolution * 2.0,
        grid_dims=tuple(d // 2 for d in c.grid_dims),
        dense_stats=False,
        fused_window=min(c.fused_window, 1024),
    )


def _aligner(mesh):
    """ndt_align, or its point-sharded form over `mesh` when one is given
    (the production multi-rank registration path, not a demo beside it)."""
    return ndt_align if mesh is None else functools.partial(sharded_ndt_align, mesh=mesh)


def _track_step(
    fine_map,
    coarse_map,
    points,
    mask,
    predict,
    capacity: int,
    leaf: float,
    fine_cfg: NDTConfig,
    coarse_cfg: Optional[NDTConfig],
    mesh=None,
):
    """One frame's tracking: preprocess -> optional coarse align -> fine
    align (sharded over `mesh` when given). Returns (frame points, frame
    mask, pose [4, 4] host, unresolved)."""
    align = _aligner(mesh)
    frame = _preprocess(points, mask, capacity, leaf)
    guess = predict
    if coarse_cfg is not None:
        guess = align(coarse_map, frame, guess, coarse_cfg).pose
    r = align(fine_map, frame, guess, fine_cfg)
    return frame.points, frame.mask, r.pose, r.unresolved


def _bbox_weights(
    points,  # [N, 3] keyframe cloud (sensor frame)
    boxes,  # [B, 8] current bboxes (sensor frame): cx..heading, score
    boxes_valid,  # [B] bool
    pose,  # [4, 4] sensor->world (host or device)
    map_centers,  # [M, 3] world-frame accumulated bbox centres
    map_descs,  # [M, 7] their descriptors
    map_valid,  # [M] bool
    base: float,
    radius: float,
):
    """Per-point static weights for one keyframe (front_end.cpp:261-327):
    each current bbox is matched to the most descriptor-similar map bbox
    (7-D cosine) within `radius`; with d the squared centre distance of the
    match, points inside the box get base^d if 0 < d < radius, else 0.
    Non-bbox points keep w = 1. Returns (weights [N], descriptors [B, 7])."""
    pose = _to(pose, points.device).to(torch.float32)
    centers_world = boxes[:, :3] @ pose[:3, :3].T + pose[:3, 3]
    desc_cur = torch.cat([centers_world, boxes[:, 3:7]], dim=-1)

    diff = centers_world[:, None, :] - map_centers[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    in_radius = (d2 <= radius * radius) & map_valid[None, :]

    num = desc_cur @ map_descs.T
    den = torch.linalg.norm(desc_cur, dim=-1)[:, None] * torch.linalg.norm(map_descs, dim=-1)[None, :]
    cos = num / torch.clamp(den, min=1e-9)
    cos = torch.where(in_radius, cos, -torch.inf)
    best = torch.argmax(cos, dim=-1)
    has_match = torch.any(in_radius, dim=-1)
    d_best = torch.gather(d2, 1, best[:, None])[:, 0]

    w_box = torch.where(
        has_match & (d_best > 0.0) & (d_best < radius),
        torch.pow(torch.full_like(d_best, base), d_best),
        0.0,
    )
    w_box = torch.where(boxes_valid, w_box, 1.0)

    membership = rotated_box_mask(points, boxes[:, :7]) & boxes_valid[:, None]
    w_per_box = torch.where(membership, w_box[:, None], torch.inf)
    w = torch.amin(w_per_box, dim=0)
    return torch.where(torch.isfinite(w), w, 1.0), desc_cur


def _build_local_map(
    kf_points,  # [K, P, 3] keyframe clouds (sensor frame)
    kf_masks,  # [K, P]
    kf_weights,  # [K, P]
    kf_poses,  # [K, 4, 4] host
    kf_valid,  # [K] host bool
    n_keyframes: int,
    center,  # [3] host: the newest keyframe's position, where the grid is centred
    cfg: FrontEndConfig,
):
    """Transform and concatenate the keyframes, voxel-filter them once
    `n_keyframes` reaches local_map_filter_min_frames, and build the fine
    and (coarse_to_fine) 2x-resolution NDT maps (UpdateWithNewFrame,
    front_end.cpp:348-424). Centring the grid on the newest keyframe clips
    only far-behind structure when the local map outgrows the grid.
    The coarse map's corner is the fine one rounded to the coarse lattice
    (`coarse_origin`; the JAX package's is the fine one itself). Returns
    (cloud, fine map, coarse map or None)."""
    dev = kf_points.device
    poses = _to(np.asarray(kf_poses, _f32), dev)
    world = torch.einsum("kij,kpj->kpi", poses[:, :3, :3], kf_points) + poses[:, None, :3, 3]
    k, p, _ = world.shape
    valid = _to(np.asarray(kf_valid, bool), dev)
    cloud = PointCloud(
        points=world.reshape(k * p, 3),
        mask=(kf_masks & valid[:, None]).reshape(k * p),
        weights=kf_weights.reshape(k * p),
    )
    if n_keyframes >= cfg.local_map_filter_min_frames:
        cloud = voxel_downsample(cloud, cfg.local_map_leaf, out_capacity=k * p)
    res = _f32(cfg.ndt.resolution)
    dims = np.asarray(cfg.ndt.grid_dims, _f32)
    origin = np.floor((np.asarray(center, _f32) - _f32(0.5) * dims * res) / res) * res
    ndt_map = build_ndt_map(cloud, cfg.ndt, origin=origin)
    coarse_map = None
    if cfg.coarse_to_fine:
        ccfg = dataclasses.replace(
            cfg.ndt, resolution=cfg.ndt.resolution * 2.0, grid_dims=tuple(d // 2 for d in cfg.ndt.grid_dims)
        )
        coarse_map = build_ndt_map(cloud, ccfg, origin=coarse_origin(origin, ccfg.resolution))
    return cloud, ndt_map, coarse_map


def coarse_origin(origin, resolution: float) -> np.ndarray:
    """The rebuilt coarse map's grid corner: the fine grid's corner rounded
    to the coarse lattice (a multiple of `resolution`), the corner
    scatter_to_sums places the sums at. The JAX package gives its coarse
    map the fine corner itself: where that lies off the coarse lattice, the
    alignment looks cells up one fine cell away from where the sums are,
    and tracking at the NDT operating point diverges once a keyframe's
    corner falls there. With the rounded corner the map holds the same sums
    and keys as the JAX package's, looked up where they were put."""
    r = _f32(resolution)
    return (np.round(np.asarray(origin, _f32) / r) * r).astype(_f32)


# the grid is only rolled once the requested origin has drifted more than
# this share of the grid extent: the grid is far larger than the sensor
# radius, so the window can lag the vehicle by tens of metres
_RECENTER_SLACK_FRAC = 0.1


def _incremental_map_update(
    fine_sums,
    old_world,  # [P, 3] evicted keyframe's world points
    old_mask,  # [P] (all False when the slot was empty)
    old_weights,  # [P]
    kf_points,  # [P, 3] new keyframe (sensor frame)
    kf_mask,  # [P]
    kf_weights,  # [P]
    pose,  # [4, 4] host
    new_origin,  # [3] host, grid corner on the coarse (2x res) lattice
    fine_cfg: NDTConfig,
    coarse_cfg: NDTConfig,
):
    """One keyframe's map maintenance: recenter (past the slack) -> evict
    outgoing + add incoming in one signed scatter -> recondition the fine
    grid, then derive the coarse grid from the fine sums and recondition it.
    Returns (fine sums, the keyframe's world points, fine map, coarse map).
    The JAX package also threads coarse sums and a coarse origin through;
    both are implied by the fine ones, so the port keeps neither."""
    dev = kf_points.device
    T = _to(pose, dev).to(torch.float32)
    world = kf_points @ T[:3, :3].T + T[:3, 3]
    world = torch.where(kf_mask[:, None], world, 0.0)

    both_pts = torch.cat([old_world, world], dim=0)
    both_mask = torch.cat([old_mask, kf_mask], dim=0)
    both_w = torch.cat([old_weights, kf_weights], dim=0)
    signs = torch.cat(
        [
            torch.full((old_world.shape[0],), -1.0, device=dev),
            torch.ones(world.shape[0], device=dev),
        ]
    )

    extent = np.asarray(fine_cfg.grid_dims, _f32) * _f32(fine_cfg.resolution)
    new_origin = np.asarray(new_origin, _f32)
    if np.any(np.abs(new_origin - fine_sums.origin.numpy()) > _f32(_RECENTER_SLACK_FRAC) * extent):
        fine_sums = recenter_ndt_sums(fine_sums, new_origin)
    fine_sums = scatter_to_sums(fine_sums, both_pts, both_mask, both_w, signs=signs)
    fine_map = finalize_ndt_sums(fine_sums, fine_cfg)
    coarse_map = finalize_ndt_sums(coarsen_ndt_sums(fine_sums), coarse_cfg)
    return fine_sums, world, fine_map, coarse_map


@dataclasses.dataclass
class FrontEndDriveState:
    """Front-end state of the scan-chained drive: tracking maps, keyframe
    window and bbox memory on the device; counters and poses on the host."""

    fine_sums: object
    fine_map: object
    coarse_map: object
    kf_world: torch.Tensor  # [K, P, 3] keyframe clouds in world frame
    kf_masks: torch.Tensor  # [K, P]
    kf_weights: torch.Tensor  # [K, P]
    cursor: int
    n_keyframes: int
    last_pose: torch.Tensor  # [4, 4] host
    predict_pose: torch.Tensor  # [4, 4] host
    last_kf_pose: torch.Tensor  # [4, 4] host
    map_bbox_centers: torch.Tensor  # [M, 3]
    map_bbox_descs: torch.Tensor  # [M, 7]
    map_bbox_valid: torch.Tensor  # [M] bool
    map_bbox_cursor: torch.Tensor  # [] int32 on the device (no sync to advance)
    # deferred map maintenance: the newest keyframe's update inputs, applied
    # at the next frame after its (stale-map) alignment
    pend_valid: bool
    pend_old_world: torch.Tensor  # [P, 3]
    pend_old_mask: torch.Tensor  # [P]
    pend_old_weights: torch.Tensor  # [P]
    pend_kf_points: torch.Tensor  # [P, 3]
    pend_kf_mask: torch.Tensor  # [P]
    pend_kf_weights: torch.Tensor  # [P]
    pend_pose: torch.Tensor  # [4, 4] host
    pend_origin: np.ndarray  # [3] host
    pend_slot: int


def init_front_end_drive(cfg: FrontEndConfig, init_pose=None, device=None) -> FrontEndDriveState:
    dev = _default_device(device)
    k, p = cfg.local_frame_num, cfg.keyframe_capacity
    fine_cfg = dataclasses.replace(cfg.ndt, dense_stats=False)
    coarse_cfg = coarse_tracking_cfg(cfg.ndt)
    zero3 = np.zeros(3, _f32)
    fine_sums = empty_ndt_sums(zero3, fine_cfg, device=dev)
    eye = torch.eye(4) if init_pose is None else torch.as_tensor(np.asarray(init_pose, _f32))
    m = cfg.max_map_bboxes

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return FrontEndDriveState(
        fine_sums=fine_sums,
        fine_map=finalize_ndt_sums(fine_sums, fine_cfg),
        coarse_map=finalize_ndt_sums(coarsen_ndt_sums(fine_sums), coarse_cfg),
        kf_world=zeros(k, p, 3),
        kf_masks=zeros(k, p, dtype=torch.bool),
        kf_weights=torch.ones((k, p), device=dev),
        cursor=0,
        n_keyframes=0,
        last_pose=eye.clone(),
        predict_pose=eye.clone(),
        last_kf_pose=eye.clone(),
        map_bbox_centers=zeros(m, 3),
        map_bbox_descs=zeros(m, 7),
        map_bbox_valid=zeros(m, dtype=torch.bool),
        map_bbox_cursor=zeros(dtype=torch.int32),
        pend_valid=False,
        pend_old_world=zeros(p, 3),
        pend_old_mask=zeros(p, dtype=torch.bool),
        pend_old_weights=torch.ones(p, device=dev),
        pend_kf_points=zeros(p, 3),
        pend_kf_mask=zeros(p, dtype=torch.bool),
        pend_kf_weights=torch.ones(p, device=dev),
        pend_pose=eye.clone(),
        pend_origin=zero3,
        pend_slot=0,
    )


def _ring_insert(memory, slots, rows):
    """memory[slots] = rows where slots == len(memory) marks a dropped row
    (the scatter's mode="drop"): those land in a scratch row sliced off."""
    pad = torch.cat([memory, memory[:1]], dim=0)
    pad[slots] = rows
    return pad[:-1]


def front_end_drive(
    state: FrontEndDriveState,
    points_seq,  # [T, raw_capacity, 3]
    mask_seq,  # [T, raw_capacity]
    cfg: FrontEndConfig,
    bboxes_seq=None,  # [T, B, 8] sensor-frame detector boxes
    bbox_valid_seq=None,  # [T, B] bool
    mesh=None,  # parallel.Mesh: shard every alignment's points over its ranks
):
    """Whole-sequence scan-to-map odometry: preprocess -> coarse-to-fine
    align -> motion-model update -> keyframe insertion with static-point
    weighting and (deferred) incremental map maintenance, frame after frame.
    With `mesh` each alignment is point-sharded over the ranks and the map
    maintenance runs replicated on each.

    The input state is not modified. Returns (state, poses [T, 4, 4] host,
    is_kf [T] bool, unresolved [T])."""
    align = _aligner(mesh)
    fine_cfg = dataclasses.replace(cfg.ndt, dense_stats=False)
    coarse_cfg = coarse_tracking_cfg(cfg.ndt)
    use_bboxes = bboxes_seq is not None
    if use_bboxes and bbox_valid_seq is None:
        bbox_valid_seq = torch.ones(bboxes_seq.shape[:2], dtype=torch.bool, device=bboxes_seq.device)
    k = cfg.local_frame_num
    m = cfg.max_map_bboxes
    st = dataclasses.replace(
        state,
        kf_world=state.kf_world.clone(),
        kf_masks=state.kf_masks.clone(),
        kf_weights=state.kf_weights.clone(),
    )

    poses, kfs, unres = [], [], []
    for i in range(points_seq.shape[0]):
        frame = _preprocess(points_seq[i], mask_seq[i], cfg.frame_capacity, cfg.frame_leaf)
        first = st.n_keyframes == 0
        if first:
            # no map yet: the alignment could not move the prediction
            pose, unresolved = st.predict_pose, 0.0
        else:
            guess = st.predict_pose
            if cfg.coarse_to_fine:
                guess = align(st.coarse_map, frame, guess, coarse_cfg).pose
            r = align(st.fine_map, frame, guess, fine_cfg)
            pose, unresolved = r.pose, r.unresolved

        if st.pend_valid:  # the previous keyframe's deferred maintenance
            fs, world, fm, cm = _incremental_map_update(
                st.fine_sums, st.pend_old_world, st.pend_old_mask, st.pend_old_weights,
                st.pend_kf_points, st.pend_kf_mask, st.pend_kf_weights,
                st.pend_pose, st.pend_origin, fine_cfg, coarse_cfg,
            )
            st.kf_world[st.pend_slot] = world
            st = dataclasses.replace(st, fine_sums=fs, fine_map=fm, coarse_map=cm, pend_valid=False)

        step = torch.linalg.solve(st.last_pose, pose)
        predict = pose @ step
        l1 = float(torch.sum(torch.abs(pose[:3, 3] - st.last_kf_pose[:3, 3])))
        is_kf = first or l1 > cfg.key_frame_distance
        st = dataclasses.replace(st, last_pose=pose, predict_pose=predict)

        if is_kf:
            kf = voxel_downsample(frame, cfg.frame_leaf, out_capacity=cfg.keyframe_capacity)
            weights = torch.ones(cfg.keyframe_capacity, device=kf.points.device)
            if use_bboxes:
                boxes = bboxes_seq[i]
                boxes_valid = bbox_valid_seq[i] & (boxes[:, 7] > cfg.bbox_score_thresh)
                w, desc_cur = _bbox_weights(
                    kf.points, boxes, boxes_valid, pose,
                    st.map_bbox_centers, st.map_bbox_descs, st.map_bbox_valid,
                    base=cfg.bbox_weight_base, radius=cfg.bbox_match_radius,
                )
                # weighting applies from the first keyframe on (no-match
                # boxes get w = 0), as in FrontEnd._add_keyframe
                weights = torch.where(kf.mask, w, 1.0)
                offs = torch.cumsum(boxes_valid.to(torch.int32), dim=0, dtype=torch.int32) - 1
                slots = torch.where(boxes_valid, (st.map_bbox_cursor + offs) % m, m).long()
                st = dataclasses.replace(
                    st,
                    map_bbox_centers=_ring_insert(st.map_bbox_centers, slots, desc_cur[:, :3]),
                    map_bbox_descs=_ring_insert(st.map_bbox_descs, slots, desc_cur),
                    map_bbox_valid=_ring_insert(
                        st.map_bbox_valid, slots, torch.ones_like(boxes_valid)
                    ),
                    map_bbox_cursor=st.map_bbox_cursor + boxes_valid.sum(dtype=torch.int32),
                )
            slot = st.cursor % k
            old_world = st.kf_world[slot].clone()
            old_mask = st.kf_masks[slot] & (st.cursor >= k)
            old_weights = st.kf_weights[slot].clone()
            # the fine origin snaps to the COARSE (2x res) lattice so the
            # derived coarse grid's 2x2x2 blocks match absolute coarse voxels
            origin_f = FrontEnd._lattice_origin(pose[:3, 3].numpy(), fine_cfg, snap_mult=2.0)
            st.kf_masks[slot] = kf.mask
            st.kf_weights[slot] = weights
            st = dataclasses.replace(
                st, cursor=st.cursor + 1, n_keyframes=st.n_keyframes + 1, last_kf_pose=pose
            )
            if first:
                # the very next frame needs a map to track against
                fs, world, fm, cm = _incremental_map_update(
                    st.fine_sums, old_world, old_mask, old_weights,
                    kf.points, kf.mask, weights, pose, origin_f, fine_cfg, coarse_cfg,
                )
                st.kf_world[slot] = world
                st = dataclasses.replace(st, fine_sums=fs, fine_map=fm, coarse_map=cm)
            else:
                st = dataclasses.replace(
                    st,
                    pend_valid=True,
                    pend_old_world=old_world,
                    pend_old_mask=old_mask,
                    pend_old_weights=old_weights,
                    pend_kf_points=kf.points,
                    pend_kf_mask=kf.mask,
                    pend_kf_weights=weights,
                    pend_pose=pose,
                    pend_origin=origin_f,
                    pend_slot=slot,
                )
        poses.append(pose)
        kfs.append(is_kf)
        unres.append(unresolved)
    return st, torch.stack(poses), torch.as_tensor(kfs), torch.as_tensor(unres, dtype=torch.float32)


class FrontEnd:
    """Stateful host wrapper (the reference's FrontEnd::Update API). With
    `mesh` (a parallel.Mesh; `mapping --mesh-devices N`) every alignment is
    point-sharded over its ranks, each rank updating its own replica of the
    tracking state from the same scans; the device defaults to the mesh's."""

    def __init__(self, config: FrontEndConfig = FrontEndConfig(), device=None, mesh=None):
        self.cfg = config
        self.mesh = mesh
        self.device = _default_device(mesh.device if device is None and mesh is not None else device)
        dev = self.device
        k = config.local_frame_num
        p = config.keyframe_capacity
        self.kf_points = torch.zeros((k, p, 3), device=dev)
        self.kf_masks = torch.zeros((k, p), dtype=torch.bool, device=dev)
        self.kf_weights = torch.ones((k, p), device=dev)
        self.kf_poses = np.tile(np.eye(4, dtype=_f32), (k, 1, 1))
        self.kf_valid = np.zeros(k, bool)
        self.kf_cursor = 0
        self.n_keyframes = 0

        m = config.max_map_bboxes
        self.map_bbox_centers = torch.zeros((m, 3), device=dev)
        self.map_bbox_descs = torch.zeros((m, 7), device=dev)
        self.map_bbox_valid = np.zeros(m, bool)
        self.map_bbox_cursor = 0

        self.init_pose = np.eye(4, dtype=_f32)
        self._pending_update = None  # deferred map maintenance, applied next update()
        self.last_pose: Optional[np.ndarray] = None
        self.predict_pose: Optional[np.ndarray] = None
        self.last_key_frame_pose: Optional[np.ndarray] = None
        self.ndt_map = None
        self.coarse_ndt_map = None
        self.local_map_cloud = None  # the rebuilt local map's cloud (incremental_map=False)
        self.fine_sums = None
        self.kf_world = torch.zeros((k, p, 3), device=dev)

    def _coarse_cfg(self) -> NDTConfig:
        return coarse_tracking_cfg(self.cfg.ndt)

    # -- reference API ------------------------------------------------------
    def set_init_pose(self, pose) -> None:
        self.init_pose = np.asarray(pose, _f32)

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

    def update(self, points, mask=None, bboxes=None, preloaded=None):
        """Process one scan. Returns (pose [4, 4] np float32, is_keyframe).

        `points` [N, 3]; `mask` [N] optional; `bboxes` [B, 8] optional
        detector boxes in the sensor frame (x, y, z, dx, dy, dz, heading,
        score); `preloaded` optionally carries this scan's `preload()`.
        """
        cfg = self.cfg
        if preloaded is None:
            if isinstance(mask, torch.Tensor):
                mask = mask.cpu().numpy()
            preloaded = self.preload(points, mask)
        pts_fixed, msk_fixed = preloaded

        if self.n_keyframes == 0:
            frame = _preprocess(pts_fixed, msk_fixed, cfg.frame_capacity, cfg.frame_leaf)
            pose = self.init_pose
            self.last_pose = pose.copy()
            self.predict_pose = pose.copy()
            self.last_key_frame_pose = pose.copy()
            with watchdog.span("front_end.keyframe"):
                self._add_keyframe(frame, pose, bboxes)
            return pose, True

        use_coarse = cfg.coarse_to_fine and self.coarse_ndt_map is not None
        coarse_cfg = self._coarse_cfg() if use_coarse else None
        coarse_map = self.coarse_ndt_map if use_coarse else self.ndt_map
        # track against the (possibly one-frame-stale) maps first, then run
        # the previous keyframe's deferred maintenance
        with watchdog.span("front_end.track"):
            f_pts, f_mask, pose, unresolved = _track_step(
                self.ndt_map, coarse_map, pts_fixed, msk_fixed, self.predict_pose,
                cfg.frame_capacity, cfg.frame_leaf, cfg.ndt, coarse_cfg, self.mesh,
            )
        pend = self._pending_update
        if pend is not None:
            with watchdog.span("front_end.map_update", device=self.device):
                self.fine_sums, world, self.ndt_map, self.coarse_ndt_map = _incremental_map_update(
                    *pend["args"], pend["fine_cfg"], pend["coarse_cfg"]
                )
                self.kf_world[pend["slot"]] = world
            self._pending_update = None
        # the kernels gather directly: the JAX package's exact-path fallback for
        # dropped derivative terms can never trigger, so a non-zero count is
        # a bug, not a condition to handle
        if unresolved != 0.0:
            raise RuntimeError(f"NDT reduction dropped derivative terms (unresolved={unresolved})")
        frame = PointCloud(points=f_pts, mask=f_mask)
        pose = pose.numpy()
        step = np.linalg.inv(self.last_pose) @ pose
        self.predict_pose = (pose @ step).astype(_f32)
        self.last_pose = pose

        l1 = np.abs(pose[:3, 3] - self.last_key_frame_pose[:3, 3]).sum()
        is_kf = l1 > cfg.key_frame_distance
        if is_kf:
            with watchdog.span("front_end.keyframe"):
                self._add_keyframe(frame, pose, bboxes)
            self.last_key_frame_pose = pose.copy()
        return pose, bool(is_kf)

    # -- internals ----------------------------------------------------------
    def _add_keyframe(self, frame: PointCloud, pose, bboxes):
        cfg = self.cfg
        dev = self.device
        kf = voxel_downsample(frame, cfg.frame_leaf, out_capacity=cfg.keyframe_capacity)

        # weighting runs on every new keyframe including the first: with an
        # empty bbox memory no box matches, so first-sight detections get w = 0
        desc_cur = None
        if bboxes is None or len(bboxes) == 0:
            weights = torch.ones(cfg.keyframe_capacity, device=dev)
        else:
            b = np.zeros((cfg.max_bboxes, 8), _f32)
            nb = min(len(bboxes), cfg.max_bboxes)
            b[:nb] = np.asarray(bboxes)[:nb]
            boxes_valid = (b[:, 7] > cfg.bbox_score_thresh) & (np.arange(cfg.max_bboxes) < nb)
            weights, desc_cur = _bbox_weights(
                kf.points, _to(b, dev), _to(boxes_valid, dev), pose,
                self.map_bbox_centers, self.map_bbox_descs, _to(self.map_bbox_valid, dev),
                base=cfg.bbox_weight_base, radius=cfg.bbox_match_radius,
            )
            weights = torch.where(kf.mask, weights, 1.0)

        self._insert_keyframe(kf, weights, pose, defer=True)

        # bbox memory for the next keyframe's matching (ring buffer)
        if desc_cur is not None:
            valid_rows = np.flatnonzero(boxes_valid)
            slots = (self.map_bbox_cursor + np.arange(len(valid_rows))) % cfg.max_map_bboxes
            rows = desc_cur[_to(valid_rows, dev)]
            self.map_bbox_centers[_to(slots, dev)] = rows[:, :3]
            self.map_bbox_descs[_to(slots, dev)] = rows
            self.map_bbox_valid[slots] = True
            self.map_bbox_cursor += len(valid_rows)

    def _insert_keyframe(self, kf: PointCloud, weights, pose, defer: bool = False) -> None:
        """Slot insertion + local-map maintenance for one keyframe (the live
        path and session restore). Incremental: `defer=True` (live path, not
        the first keyframe) stashes the maintenance inputs; the next
        update() applies them after its track. Otherwise the local map is
        rebuilt from the keyframe window at once."""
        cfg = self.cfg
        slot = self.kf_cursor % cfg.local_frame_num
        # snapshot the outgoing slot before overwriting it (incremental evict)
        evicting = cfg.incremental_map and bool(self.kf_valid[slot])
        old_world = self.kf_world[slot].clone()
        old_mask = (
            self.kf_masks[slot].clone() if evicting
            else torch.zeros(cfg.keyframe_capacity, dtype=torch.bool, device=self.device)
        )
        old_weights = self.kf_weights[slot].clone()

        self.kf_points[slot] = kf.points
        self.kf_masks[slot] = kf.mask
        self.kf_weights[slot] = weights
        self.kf_poses[slot] = np.asarray(pose, _f32)
        self.kf_valid[slot] = True
        self.kf_cursor += 1
        self.n_keyframes += 1

        if not cfg.incremental_map:
            self.local_map_cloud, self.ndt_map, self.coarse_ndt_map = _build_local_map(
                self.kf_points, self.kf_masks, self.kf_weights, self.kf_poses, self.kf_valid,
                min(self.n_keyframes, cfg.local_frame_num), np.asarray(pose, _f32)[:3, 3], cfg,
            )
            return
        # tracking maps feed only the align path: skip the dense stats views
        fine_cfg = dataclasses.replace(cfg.ndt, dense_stats=False)
        coarse_cfg = coarse_tracking_cfg(cfg.ndt)
        center = np.asarray(pose, _f32)[:3, 3]
        # fine origin on the COARSE lattice: the coarse grid is derived from
        # the fine sums by 2x2x2 block reduction and shares the fine origin
        origin_f = self._lattice_origin(center, fine_cfg, snap_mult=2.0)
        if self.fine_sums is None:
            self.fine_sums = empty_ndt_sums(origin_f, fine_cfg, device=self.device)
        upd_args = (
            self.fine_sums, old_world, old_mask, old_weights,
            kf.points, kf.mask, weights, np.asarray(pose, _f32), origin_f,
        )
        if defer and self.ndt_map is not None:
            self._pending_update = {
                "args": upd_args, "slot": slot, "fine_cfg": fine_cfg, "coarse_cfg": coarse_cfg,
            }
            return
        self.fine_sums, world, self.ndt_map, self.coarse_ndt_map = _incremental_map_update(
            *upd_args, fine_cfg, coarse_cfg
        )
        self.kf_world[slot] = world

    def restore(self, keyframes, total_keyframes: Optional[int] = None, last_pose=None, predict_pose=None) -> None:
        """Rebuild the tracking state from stored keyframes (session resume).

        `keyframes`: dicts {points, mask?, weights?, pose} of numpy arrays,
        the LAST `local_frame_num` keyframes of the interrupted run, oldest
        first; each is downsampled on the device and inserted at once.
        `total_keyframes` keeps the slot cursor's phase that of the original
        run, so later evictions happen in the same order."""
        cfg = self.cfg
        kfs = list(keyframes)[-cfg.local_frame_num:]
        if not kfs:
            return
        total = total_keyframes if total_keyframes is not None else len(kfs)
        self.kf_cursor = total - len(kfs)
        self.n_keyframes = self.kf_cursor
        for rec in kfs:
            pts = np.asarray(rec["points"], _f32)
            msk = np.asarray(rec.get("mask", np.ones(len(pts), bool)), bool)
            w = rec.get("weights")
            cap = max(cfg.keyframe_capacity, int(msk.sum()))
            sel = pts[msk]
            pad_p = np.zeros((cap, 3), _f32)
            pad_p[: len(sel)] = sel
            pad_w = np.ones(cap, _f32)
            if w is not None:
                pad_w[: len(sel)] = np.asarray(w, _f32)[msk]
            pad_m = np.zeros(cap, bool)
            pad_m[: len(sel)] = True
            cloud = PointCloud(points=torch.as_tensor(pad_p, device=self.device),
                               mask=torch.as_tensor(pad_m, device=self.device),
                               weights=torch.as_tensor(pad_w, device=self.device))
            kf = voxel_downsample(cloud, cfg.frame_leaf, out_capacity=cfg.keyframe_capacity)
            # the voxel means of the stored weights (1 where none were stored)
            self._insert_keyframe(PointCloud(points=kf.points, mask=kf.mask), kf.weights,
                                  np.asarray(rec["pose"], _f32))
        last_kf_pose = np.asarray(kfs[-1]["pose"], _f32)
        self.last_key_frame_pose = last_kf_pose.copy()
        self.last_pose = np.asarray(last_pose, _f32) if last_pose is not None else last_kf_pose.copy()
        self.predict_pose = np.asarray(predict_pose, _f32) if predict_pose is not None else self.last_pose.copy()

    @staticmethod
    def _lattice_origin(center, ndt_cfg: NDTConfig, snap_mult: float = 1.0) -> np.ndarray:
        """Grid corner centring `center`, snapped to the grid's own lattice
        (`snap_mult=2.0`: the 2x coarse lattice, needed by coarsen_ndt_sums)."""
        res = _f32(ndt_cfg.resolution)
        snap = _f32(ndt_cfg.resolution * snap_mult)
        dims = np.asarray(ndt_cfg.grid_dims, _f32)
        return (np.floor((np.asarray(center, _f32) - _f32(0.5) * dims * res) / snap) * snap).astype(_f32)
