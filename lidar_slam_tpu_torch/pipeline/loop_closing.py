"""Loop closing: Scan-Context / GNSS candidate detection + NDT verification
(port of lidar_slam_tpu/pipeline/loop_closing.py).

Two detectors selected by `loop_method`: 'sc', Scan Context retrieval on
each new keyframe, and 'gps', the nearest historical key-GNSS position by
L1 distance with the `diff_num` separation and `detect_area` gates. A
candidate is verified by NDT-matching the current keyframe scan against a
submap of +-`extend_frame_num` keyframes around it, accepted on the
point-NN fitness <= `fitness_score_limit`. Accepted loops yield
LoopPose(index0, index1, relative pose) records for the back end.

On the card a verification attempt is the submap and scan downsamples, the
NDT map build, one `ndt_newton` launch and the fitness, with two host reads:
the map build's grid origin and one copy of the alignment's result together
with the fitness.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from .. import device as _default_device
from ..geom.se3 import euler_xyz_to_matrix
from ..io.keyframe_store import KeyframeStore
from ..models.registration import NDTConfig, build_ndt_map, ndt_align, point_nn_fitness_score
from ..models.registration.ndt import newton_pose, newton_result, ndt_newton_align, takes_newton_kernel
from ..models.scan_context import SCManager, ScanContextConfig
from ..ops.pointcloud import PointCloud, voxel_downsample


@dataclasses.dataclass(frozen=True)
class LoopClosingConfig:
    """Operating point from config/mapping/loop_closing.yaml:1-14; the JAX
    package's fields and defaults."""

    loop_method: str = "sc"  # 'sc' | 'gps'
    loop_step: int = 3  # check every N keyframes
    diff_num: int = 100  # min keyframe separation
    detect_area: float = 10.0  # GPS candidate radius [m]
    extend_frame_num: int = 2  # submap half-width
    fitness_score_limit: float = 0.2
    ndt: NDTConfig = NDTConfig(resolution=1.0, grid_dims=(160, 160, 40), point_chunk=4096, gather="auto")
    map_filter_leaf: float = 0.3
    scan_filter_leaf: float = 0.3
    submap_capacity: int = 65536
    scan_capacity: int = 16384
    sc: ScanContextConfig = ScanContextConfig()


def _submap_ndt(sub_pts, sub_msk, cfg: LoopClosingConfig):
    """The verification target: the joint submap voxel-downsampled to
    `submap_capacity` points, and its NDT map (no dense stats: only the
    alignment reads it)."""
    submap = voxel_downsample(PointCloud(points=sub_pts, mask=sub_msk), cfg.map_filter_leaf,
                              out_capacity=cfg.submap_capacity)
    return submap, build_ndt_map(submap, dataclasses.replace(cfg.ndt, dense_stats=False))


def _verify_step(sub_pts, sub_msk, scan_pts, scan_msk, guess, cfg: LoopClosingConfig):
    """One verification attempt: downsample the submap and the scan, build
    the NDT target, align from `guess` [4, 4], and score the PCL-style
    point-NN squared fitness against the filtered submap points (the
    reference's gate, ndt_registration.cpp:63-66). Returns (pose [4, 4] host
    float32, fitness)."""
    ndt_cfg = dataclasses.replace(cfg.ndt, dense_stats=False)
    submap, ndt_map = _submap_ndt(sub_pts, sub_msk, cfg)
    scan = voxel_downsample(PointCloud(points=scan_pts, mask=scan_msk), cfg.scan_filter_leaf,
                            out_capacity=cfg.scan_capacity)
    if takes_newton_kernel(ndt_cfg, scan.points.device):
        out = ndt_newton_align(ndt_map, scan, guess, ndt_cfg)
        fit = point_nn_fitness_score(submap, scan, newton_pose(out))
        host = torch.cat([out, fit.reshape(1)]).cpu().numpy()  # the pose and the fitness in one read
        return newton_result(host).pose.numpy(), float(host[-1])
    r = ndt_align(ndt_map, scan, guess, ndt_cfg)
    return r.pose.numpy(), float(point_nn_fitness_score(submap, scan, r.pose))


@dataclasses.dataclass
class LoopPose:
    """LoopPose message (sensor_data/loop_pose.hpp:12-23)."""

    index0: int
    index1: int
    relative_pose: np.ndarray  # pose of kf index1 expressed against index0's map pose
    fitness: float = 0.0  # fitness at acceptance


class LoopClosing:
    """Candidate detection and verification over a keyframe store, on
    `device` (the card unless the caller passes device="cpu")."""

    def __init__(self, config: LoopClosingConfig, store: KeyframeStore, data_path: Optional[str] = None,
                 device=None):
        self.cfg = config
        self.store = store
        self.device = _default_device(device)
        self.sc = SCManager(config.sc, device=self.device)
        self.key_poses: List[np.ndarray] = []  # odom/map poses per keyframe
        self.key_gnss: List[np.ndarray] = []
        self._skip_cnt = 0
        self._skip_num = config.loop_step
        self.detected: List[LoopPose] = []
        self.attempts = 0  # verification attempts (_verify_step calls)
        # loop-event log, the reference's slam_data/loop_pose_<method>.txt
        self._log_path = None
        if data_path is not None:
            os.makedirs(data_path, exist_ok=True)
            self._log_path = os.path.join(data_path, f"loop_pose_{config.loop_method}.txt")
            open(self._log_path, "w").close()

    def update(self, kf_index: int, kf_pose, gnss_position=None) -> Optional[LoopPose]:
        """Called once per new keyframe (LoopClosing::Update). Returns an
        accepted LoopPose or None."""
        cfg = self.cfg
        kf_pose = np.asarray(kf_pose, np.float32)
        self.key_poses.append(kf_pose)
        self.key_gnss.append(
            kf_pose[:3, 3].copy() if gnss_position is None else np.asarray(gnss_position, np.float32)
        )

        rec = self.store.load(kf_index)
        if cfg.loop_method == "sc":
            self.sc.add(rec["points"], rec["mask"])

        # adaptive skip counter (loop_closing.cpp:152-168)
        self._skip_cnt += 1
        if self._skip_cnt < self._skip_num:
            return None

        if cfg.loop_method == "sc":
            cand, yaw = self._detect_scan_context(kf_index)
        else:
            cand, yaw = self._detect_gnss(kf_index)
        if cand < 0:
            return None
        self._skip_cnt = 0
        self._skip_num = cfg.loop_step

        loop = self._verify(cand, kf_index, yaw)
        if loop is not None:
            self.detected.append(loop)
            if self._log_path is not None:
                with open(self._log_path, "a") as f:
                    f.write(
                        f"loop {len(self.detected)}: frame {loop.index0} ------> "
                        f"frame {loop.index1}\nfitness score: {loop.fitness:.6f}\n\n"
                    )
        return loop

    # -- detectors ----------------------------------------------------------
    def _detect_gnss(self, cur: int):
        """DetectNearestKeyFrame (loop_closing.cpp:152-200)."""
        cfg = self.cfg
        if cur < cfg.diff_num:
            return -1, 0.0
        cur_p = self.key_gnss[cur]
        hist = np.asarray(self.key_gnss[: cur - cfg.diff_num + 1])
        if len(hist) == 0:
            return -1, 0.0
        d = np.abs(hist - cur_p).sum(axis=1)
        best = int(np.argmin(d))
        if d[best] > cfg.detect_area:
            # candidate too far: grow the skip window and restart the counter
            # (loop_closing.cpp:219)
            self._skip_cnt = 0
            self._skip_num = max(cfg.loop_step, int(d[best] / 2.0 / self.cfg.detect_area * cfg.loop_step))
            return -1, 0.0
        return best, 0.0

    def _detect_scan_context(self, cur: int):
        """DetectNearestKeyFrameScanContext (loop_closing.cpp:202-231): SC
        retrieval, then the candidate must be at least extend_frame_num old
        and within detect_area of the current pose, the skip window backing
        off when it is far away. The counter restarts whenever a retrieval
        ran and found nothing usable, as the JAX package does (the C++
        keeps it)."""
        cfg = self.cfg
        idx, _, yaw = self.sc.detect()
        if idx < cfg.extend_frame_num:
            self._skip_cnt = 0
            return -1, 0.0
        d = float(np.linalg.norm(self.key_poses[cur][:3, 3] - self.key_poses[idx][:3, 3]))
        if d > cfg.detect_area:
            self._skip_cnt = 0
            self._skip_num = max(int(cfg.detect_area / 2.0), cfg.loop_step)
            return -1, 0.0
        return idx, yaw

    # -- verification -------------------------------------------------------
    def _verify_inputs(self, index0: int, index1: int):
        """The raw inputs of `_verify_step` on the device: the joint submap
        of +-extend_frame_num keyframes around index0 in their map poses
        (points, mask) and the stored scan of index1 (points, mask)."""
        cfg = self.cfg
        pts_list = []
        for k in range(max(0, index0 - cfg.extend_frame_num),
                       min(len(self.key_poses), index0 + cfg.extend_frame_num + 1)):
            rec = self.store.load(k)
            T = self.key_poses[k]
            pts_list.append(rec["points"][rec["mask"]] @ T[:3, :3].T + T[:3, 3])
        sub = np.concatenate(pts_list)
        # the raw capacity is bucketed as the JAX package buckets it (there to
        # bound jit recompiles); the downsample then bounds the submap
        bucket = 65536
        raw_cap = max(cfg.submap_capacity, ((len(sub) + bucket - 1) // bucket) * bucket)
        sub_pts = np.zeros((raw_cap, 3), np.float32)
        sub_pts[: len(sub)] = sub[:raw_cap]
        sub_msk = np.zeros(raw_cap, bool)
        sub_msk[: min(len(sub), raw_cap)] = True
        rec1 = self.store.load(index1)
        return tuple(torch.as_tensor(a).to(self.device, non_blocking=True)
                     for a in (sub_pts, sub_msk, rec1["points"], rec1["mask"]))

    def _verify(self, index0: int, index1: int, yaw_hint: float) -> Optional[LoopPose]:
        """CloudRegistration: JointMap + JointScan + NDT + fitness gate
        (loop_closing.cpp:233-319), with the SC-yaw discrepancy retry."""
        cfg = self.cfg
        args = self._verify_inputs(index0, index1)
        guess = self.key_poses[index1].copy()
        self.attempts += 1
        result, fitness = _verify_step(*args, guess, cfg)
        if fitness > cfg.fitness_score_limit and cfg.loop_method == "sc":
            # Fallback the reference lacks: Scan Context measured the true
            # relative yaw between the two scans; apply only its discrepancy
            # with the relative yaw the pose estimates imply, if above one
            # sector (2 pi / 60).
            rel = self.key_poses[index0][:3, :3].T @ guess[:3, :3]
            rel_yaw = float(np.arctan2(rel[1, 0], rel[0, 0]))
            corr = (yaw_hint - rel_yaw + np.pi) % (2.0 * np.pi) - np.pi
            if abs(corr) > 2.0 * np.pi / 60.0:
                for sign in (1.0, -1.0):
                    g2 = guess.copy()
                    Rz = euler_xyz_to_matrix(*torch.tensor([0.0, 0.0, sign * corr], dtype=torch.float32))
                    g2[:3, :3] = guess[:3, :3] @ Rz.numpy()
                    self.attempts += 1
                    r2, f2 = _verify_step(*args, g2, cfg)
                    if f2 < fitness:
                        result, fitness = r2, f2
                    if fitness <= cfg.fitness_score_limit:
                        break
        if fitness > cfg.fitness_score_limit:
            return None
        rel = np.linalg.inv(self.key_poses[index0]) @ result
        return LoopPose(index0=index0, index1=index1, relative_pose=rel.astype(np.float32), fitness=fitness)
