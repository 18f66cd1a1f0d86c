"""Back end: keyframe management + pose-graph optimization (port of
lidar_slam_tpu/pipeline/back_end.py).

Gates keyframes on 2 m of laser-odometry motion, persists keyframe clouds
(voxel-downsampled on the device), builds the SE(3) graph (odometry edges,
optional GNSS XYZ priors, loop-closure edges), optimizes when edge-count
thresholds trip or on demand (`force_optimize`), and re-corrects the full
keyframe trajectory. The graph is solved on `device` (the card unless the
caller passes device="cpu").
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import device as _default_device
from ..io.keyframe_store import KeyframeStore
from ..io.trajectory import write_kitti_trajectory
from ..models.graph_optimizer import GraphOptimizerConfig, PoseGraphBuilder
from ..ops.pointcloud import PointCloud, voxel_downsample


@dataclasses.dataclass(frozen=True)
class BackEndConfig:
    """Thresholds of config/mapping/back_end.yaml:1-21; the JAX package's
    fields and defaults."""

    key_frame_distance: float = 2.0
    optimize_step_with_key_frame: int = 100
    optimize_step_with_gnss: int = 100
    optimize_step_with_loop: int = 10
    odom_edge_noise: Tuple[float, ...] = (0.5, 0.5, 0.5, 0.001, 0.001, 0.001)
    close_loop_noise: Tuple[float, ...] = (0.3, 0.3, 0.3, 0.001, 0.001, 0.001)
    gnss_noise: Tuple[float, ...] = (2.0, 2.0, 2.0)
    use_gnss: bool = True
    use_loop_close: bool = True
    max_nodes: int = 2048
    max_edges: int = 4096
    max_priors: int = 2048
    optimizer: GraphOptimizerConfig = GraphOptimizerConfig(max_iterations=100)
    # keyframe clouds are stored voxel-downsampled (0 stores them raw)
    store_leaf: float = 0.5
    store_capacity: int = 32768


@dataclasses.dataclass
class KeyFrame:
    """KeyFrame record (sensor_data/key_frame.hpp:13-26)."""

    index: int
    time: float
    pose: np.ndarray  # laser-odometry pose at creation


class BackEnd:
    def __init__(self, config: BackEndConfig = BackEndConfig(), store: Optional[KeyframeStore] = None,
                 device=None):
        self.cfg = config
        self.store = store
        self.device = _default_device(device)
        self.graph = PoseGraphBuilder(config.max_nodes, config.max_edges, config.max_priors, device=self.device)
        self.key_frames: List[KeyFrame] = []
        self.optimized_poses: Optional[np.ndarray] = None
        self._last_key_pose: Optional[np.ndarray] = None
        self._new_kf_cnt = 0
        self._new_gnss_cnt = 0
        self._new_loop_cnt = 0
        self._has_new_optimized = False
        self.last_stats: Optional[dict] = None
        # odom-frame -> map(GNSS)-frame re-anchor, set on the first update
        # that carries GNSS (back_end_flow.cpp:128-141): the odometry starts
        # at identity while GNSS priors live in the ENU map frame
        self._odom_to_map: Optional[np.ndarray] = None

    # -- reference API ------------------------------------------------------
    def update(self, odom_pose, time: float = 0.0, gnss_position=None, gnss_pose=None,
               cloud_points=None, cloud_mask=None, cloud_weights=None) -> bool:
        """Process one synced (cloud, laser odom [, gnss]) tuple. Returns
        True iff a new keyframe was created (BackEnd::Update).

        `gnss_pose` [4, 4] enables the exact odom re-anchor (gnss odom^-1);
        with only `gnss_position` [3] the re-anchor is translation-only."""
        odom_pose = np.asarray(odom_pose, np.float32)
        if self.cfg.use_gnss and self._odom_to_map is None:
            if gnss_pose is not None:
                self._odom_to_map = (np.asarray(gnss_pose, np.float32) @ np.linalg.inv(odom_pose)).astype(np.float32)
            elif gnss_position is not None:
                t = np.eye(4, dtype=np.float32)
                t[:3, 3] = np.asarray(gnss_position, np.float32) - odom_pose[:3, 3]
                self._odom_to_map = t
        if self._odom_to_map is not None:
            odom_pose = (self._odom_to_map @ odom_pose).astype(np.float32)
        if not self._maybe_new_keyframe(odom_pose, time):
            return False

        i = len(self.key_frames) - 1
        if self.store is not None and cloud_points is not None:
            if self.cfg.store_leaf > 0:
                cloud_points, cloud_mask, cloud_weights = self._downsample_for_store(
                    cloud_points, cloud_mask, cloud_weights
                )
            self.store.save(i, cloud_points, cloud_mask, odom_pose, cloud_weights, time, gnss=gnss_position)

        # AddNodeAndEdge (back_end.cpp:212-245); node 0 is always fixed, as
        # in the JAX package (odometry is re-anchored into the GNSS frame,
        # and position-only priors leave a rotation gauge free)
        self.graph.add_se3_node(odom_pose, fixed=(i == 0))
        if i > 0:
            prev = self.key_frames[-2].pose
            self.graph.add_se3_edge(i - 1, i, np.linalg.inv(prev) @ odom_pose, noise=self.cfg.odom_edge_noise)
        if self.cfg.use_gnss and gnss_position is not None:
            self.graph.add_se3_prior_xyz_edge(i, np.asarray(gnss_position, np.float32), noise=self.cfg.gnss_noise)
            self._new_gnss_cnt += 1
        self._new_kf_cnt += 1
        self._maybe_optimize()
        return True

    def insert_loop_pose(self, index0: int, index1: int, relative_pose) -> None:
        """Loop edge: index0 = historical keyframe, index1 = current."""
        if not self.cfg.use_loop_close:
            return
        self.graph.add_se3_edge(index0, index1, np.asarray(relative_pose, np.float32),
                                noise=self.cfg.close_loop_noise)
        self._new_loop_cnt += 1
        self._maybe_optimize()

    def force_optimize(self) -> dict:
        return self._optimize()

    def has_new_optimized(self) -> bool:
        return self._has_new_optimized

    def get_optimized_poses(self) -> Optional[np.ndarray]:
        self._has_new_optimized = False
        return self.optimized_poses

    def latest_keyframe(self) -> Optional[KeyFrame]:
        return self.key_frames[-1] if self.key_frames else None

    def restore_from_store(self, store, odom_to_map=None) -> int:
        """Rebuild the keyframe list and pose graph from a resumed store:
        nodes, odometry edges and GNSS priors from the stored records (loop
        edges come back by replaying LoopClosing over the store). Returns
        the number of restored keyframes."""
        n = len(store)
        for i in range(n):
            rec = store.load(i)
            pose = np.asarray(rec["pose"], np.float32)
            self.key_frames.append(KeyFrame(index=i, time=rec["time"], pose=pose.copy()))
            self.graph.add_se3_node(pose, fixed=(i == 0))
            if i > 0:
                prev = self.key_frames[-2].pose
                self.graph.add_se3_edge(i - 1, i, np.linalg.inv(prev) @ pose, noise=self.cfg.odom_edge_noise)
            if self.cfg.use_gnss and rec.get("gnss") is not None:
                self.graph.add_se3_prior_xyz_edge(i, np.asarray(rec["gnss"], np.float32), noise=self.cfg.gnss_noise)
                self._new_gnss_cnt += 1
            self._new_kf_cnt += 1
        if n:
            self._last_key_pose = self.key_frames[-1].pose.copy()
            # stored poses are in the re-anchored (map) frame; keep the
            # original run's anchor so the resumed odometry re-anchors alike
            self._odom_to_map = (np.eye(4, dtype=np.float32) if odom_to_map is None
                                 else np.asarray(odom_to_map, np.float32))
        return n

    # -- internals ----------------------------------------------------------
    def _downsample_for_store(self, points, mask, weights):
        """Voxel-filter a keyframe cloud on the device before persisting it;
        the result comes back in one host read."""
        dev = self.device
        n = len(points)
        pts = torch.as_tensor(np.asarray(points, np.float32)).to(dev, non_blocking=True)
        msk = torch.ones(n, dtype=torch.bool, device=dev) if mask is None else (
            torch.as_tensor(np.asarray(mask, bool)).to(dev, non_blocking=True))
        w = None if weights is None else torch.as_tensor(np.asarray(weights, np.float32)).to(dev, non_blocking=True)
        out = voxel_downsample(PointCloud(points=pts, mask=msk, weights=w), self.cfg.store_leaf,
                               out_capacity=self.cfg.store_capacity)
        host = torch.cat([out.points, out.mask[:, None].to(torch.float32), out.weights[:, None]], dim=1).cpu().numpy()
        return host[:, :3].copy(), host[:, 3] > 0.5, host[:, 4].copy()

    def _maybe_new_keyframe(self, pose, time) -> bool:
        if self._last_key_pose is None:
            new = True
        else:
            new = np.abs(pose[:3, 3] - self._last_key_pose[:3, 3]).sum() > self.cfg.key_frame_distance
        if new:
            self.key_frames.append(KeyFrame(index=len(self.key_frames), time=time, pose=pose.copy()))
            self._last_key_pose = pose.copy()
        return new

    def _maybe_optimize(self) -> None:
        c = self.cfg
        if (
            self._new_kf_cnt >= c.optimize_step_with_key_frame
            or self._new_gnss_cnt >= c.optimize_step_with_gnss
            or self._new_loop_cnt >= c.optimize_step_with_loop
        ):
            self._optimize()

    def _optimize(self) -> dict:
        self._new_kf_cnt = self._new_gnss_cnt = self._new_loop_cnt = 0
        _, stats = self.graph.optimize(self.cfg.optimizer)
        self.optimized_poses = self.graph.node_poses()
        self._has_new_optimized = True
        self.last_stats = {k: float(v) for k, v in stats.items()}
        if self.store is not None:
            write_kitti_trajectory(os.path.join(self.store.traj_dir, "optimized.txt"), self.optimized_poses)
        return self.last_stats
