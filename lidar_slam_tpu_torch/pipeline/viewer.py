"""Viewer / map builder: trajectory correction + local/global map export.

Re-design of Viewer (src/mapping/viewer/viewer.cpp:18-250, viewer_flow.cpp)
minus rviz: maintains every keyframe, merges optimized poses by index and
applies the latest odom->optimized correction to the not-yet-optimized tail
(viewer.cpp:122-152), assembles local/global maps from the keyframe store
(:160-191), and exports map files (SaveMap, :193-215 — triggered there by
the /save_map ROS service; here a plain method). Maps are written as .npz
and ASCII .pcd for PCL interop, with the JAX package's files and keys
(the port of lidar_slam_tpu/pipeline/viewer.py).

Poses and map files live on the host; the joint map's voxel filter (up to
`map_capacity` = 2M rows) runs on the viewer's device, the card unless the
caller passes device="cpu".
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from .. import device as _default_device
from ..io.keyframe_store import KeyframeStore
from ..ops.pointcloud import PointCloud, voxel_downsample


@dataclasses.dataclass(frozen=True)
class ViewerConfig:
    local_frame_num: int = 20
    local_map_leaf: float = 0.3  # config/mapping/viewer.yaml
    global_map_leaf: float = 0.5
    map_capacity: int = 1 << 21


def write_pcd(path: str, points: np.ndarray) -> None:
    """Minimal ASCII PCD (x y z) writer for interop with PCL tooling."""
    points = np.asarray(points, np.float32)
    with open(path, "w") as f:
        f.write(
            "# .PCD v0.7 - Point Cloud Data file format\n"
            "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
            f"WIDTH {len(points)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {len(points)}\nDATA ascii\n"
        )
        np.savetxt(f, points, fmt="%.4f")


class Viewer:
    def __init__(self, config: ViewerConfig, store: KeyframeStore, device=None):
        self.cfg = config
        self.store = store
        self.device = _default_device(device)
        self.odom_poses: List[np.ndarray] = []  # pose at keyframe creation
        self.corrected_poses: List[np.ndarray] = []
        self._pose_to_optimize = np.eye(4, dtype=np.float32)

    def update_with_new_key_frame(self, kf_index: int, pose) -> None:
        """UpdateWithNewKeyFrame (viewer.cpp:75-120): append and apply the
        current correction to the fresh keyframe."""
        pose = np.asarray(pose, np.float32)
        assert kf_index == len(self.odom_poses)
        self.odom_poses.append(pose.copy())
        self.corrected_poses.append((self._pose_to_optimize @ pose).astype(np.float32))

    def update_with_optimized_poses(self, optimized: np.ndarray) -> None:
        """OptimizeKeyFrames (viewer.cpp:122-152): overwrite matched indices,
        correct the tail with optimized * odom^-1 of the newest match."""
        optimized = np.asarray(optimized, np.float32)
        n = min(len(optimized), len(self.odom_poses))
        for i in range(n):
            self.corrected_poses[i] = optimized[i].copy()
        if n > 0:
            self._pose_to_optimize = (optimized[n - 1] @ np.linalg.inv(self.odom_poses[n - 1])).astype(
                np.float32
            )
            for i in range(n, len(self.odom_poses)):
                self.corrected_poses[i] = (self._pose_to_optimize @ self.odom_poses[i]).astype(
                    np.float32
                )

    # -- map assembly -------------------------------------------------------
    def _joint_map(self, indices, leaf: float):
        """The keyframes' clouds in their corrected poses, cut at
        `map_capacity` points before the voxel filter as the JAX viewer cuts
        them (pipeline/viewer.py:88 there), then filtered at `leaf` (None:
        unfiltered). Returns (points, the points offered before the cut)."""
        pts = []
        for i in indices:
            rec = self.store.load(i)
            T = self.corrected_poses[i]
            p = rec["points"][rec["mask"]]
            pts.append(p @ T[:3, :3].T + T[:3, 3])
        if not pts:
            return np.zeros((0, 3), np.float32), 0
        allp = np.concatenate(pts).astype(np.float32)
        offered = len(allp)
        allp = allp[: self.cfg.map_capacity]
        if leaf is None:  # unfiltered map: raw concatenation (viewer.cpp:193-205)
            return allp, offered
        cloud = PointCloud.from_points(allp, device=self.device)
        out = voxel_downsample(cloud, leaf, out_capacity=cloud.capacity)
        return out.points[out.mask].cpu().numpy(), offered

    def get_local_map(self) -> np.ndarray:
        n = len(self.corrected_poses)
        lo = max(0, n - self.cfg.local_frame_num)
        return self._joint_map(range(lo, n), self.cfg.local_map_leaf)[0]

    def get_global_map(self, filtered: bool = True) -> np.ndarray:
        leaf = self.cfg.global_map_leaf if filtered else None
        return self._joint_map(range(len(self.corrected_poses)), leaf)[0]

    def save_trajectory_plot(self, path: str, gt_poses=None) -> None:
        """Top-down trajectory (+map) plot — the offline stand-in for the
        reference's rviz visualization (rviz/mapping.rviz). Imports
        matplotlib here, so nothing else needs it."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 8))
        gmap = self.get_global_map(filtered=True)
        if len(gmap):
            ax.scatter(gmap[:, 0], gmap[:, 1], s=0.2, c="#cccccc", label="map")
        if self.corrected_poses:
            t = np.stack(self.corrected_poses)[:, :2, 3]
            ax.plot(t[:, 0], t[:, 1], "b.-", lw=1, ms=3, label="optimized")
        if gt_poses is not None:
            g = np.asarray(gt_poses)[:, :2, 3]
            ax.plot(g[:, 0], g[:, 1], "g--", lw=1, label="ground truth")
        ax.set_aspect("equal")
        ax.legend(loc="best")
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)

    def save_map(self) -> dict:
        """SaveMap (viewer.cpp:193-215): write map + filtered map + the
        optimized trajectory next to the keyframe store. The files are the
        JAX viewer's; the returned counts add `map_capacity_dropped`, the
        points the `map_capacity` cut left out of both maps (the JAX viewer
        drops them without a word; the C++ viewer joins every keyframe)."""
        out = {}
        every = range(len(self.corrected_poses))
        gmap, offered = self._joint_map(every, None)
        fmap, _ = self._joint_map(every, self.cfg.global_map_leaf)
        np.savez_compressed(os.path.join(self.store.map_dir, "map.npz"), points=gmap)
        np.savez_compressed(os.path.join(self.store.map_dir, "filtered_map.npz"), points=fmap)
        write_pcd(os.path.join(self.store.map_dir, "map.pcd"), gmap)
        write_pcd(os.path.join(self.store.map_dir, "filtered_map.pcd"), fmap)
        from ..io.trajectory import write_kitti_trajectory

        if self.corrected_poses:
            write_kitti_trajectory(
                os.path.join(self.store.traj_dir, "viewer_optimized.txt"),
                np.stack(self.corrected_poses),
            )
        out["map_points"] = len(gmap)
        out["filtered_map_points"] = len(fmap)
        out["map_capacity_dropped"] = offered - len(gmap)
        return out
