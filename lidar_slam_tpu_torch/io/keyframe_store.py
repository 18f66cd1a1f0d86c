"""Deterministic on-disk keyframe store (checkpoint/resume).

Replaces the reference's file layout — `slam_data/key_frames/key_frame_<i>.pcd`
written by the back end (back_end.cpp:193-194) and re-read by loop closing
(loop_closing.cpp:283-304) and the viewer (viewer.cpp:176-191) — with
compressed npz records that carry the weight channel and pose alongside the
points. Unlike the reference (which wipes directories on startup,
file_manager.cpp:23-29), `resume=True` reopens an existing store mid-run.

The port's own copy of lidar_slam_tpu/io/keyframe_store.py, with the same
file format: a store written by one package loads in the other. One
deliberate difference: records are written atomically, so a mapping run
killed mid-write can be resumed.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np

from ..utils import watchdog


class KeyframeStore:
    def __init__(self, root: str, resume: bool = False):
        self.root = root
        self.kf_dir = os.path.join(root, "key_frames")
        self.traj_dir = os.path.join(root, "trajectory")
        self.map_dir = os.path.join(root, "map")
        if not resume and os.path.isdir(root):
            shutil.rmtree(root)
        for d in (self.kf_dir, self.traj_dir, self.map_dir):
            os.makedirs(d, exist_ok=True)
        self._count = len([f for f in os.listdir(self.kf_dir) if f.endswith(".npz")])

    def __len__(self) -> int:
        return self._count

    def _path(self, index: int) -> str:
        return os.path.join(self.kf_dir, f"key_frame_{index}.npz")

    def save(self, index: int, points, mask, pose, weights=None, time: float = 0.0,
             gnss=None) -> None:
        """Write one keyframe record atomically (a temporary file, then a
        rename): a run killed mid-write leaves the previous state, never a
        truncated record that a resumed run could not load. (The JAX
        package writes the record in place.)"""
        path = self._path(index)
        tmp = path + ".tmp"
        with watchdog.span("store.save"):
            with open(tmp, "wb") as f:
                np.savez_compressed(
                    f,
                    points=np.asarray(points, np.float32),
                    mask=np.asarray(mask, bool),
                    weights=None if weights is None else np.asarray(weights, np.float32),
                    pose=np.asarray(pose, np.float32),
                    time=np.float64(time),
                    gnss=None if gnss is None else np.asarray(gnss, np.float32),
                )
            os.replace(tmp, path)
        self._count = max(self._count, index + 1)

    def load(self, index: int) -> dict:
        with watchdog.span("store.load"), np.load(self._path(index), allow_pickle=True) as z:
            gnss = z["gnss"] if "gnss" in z.files else None
            return {
                "points": z["points"],
                "mask": z["mask"],
                "weights": None if z["weights"].dtype == object else z["weights"],
                "pose": z["pose"],
                "time": float(z["time"]),
                "gnss": None if gnss is None or gnss.dtype == object else gnss,
            }

    # -- mid-run progress (session resume, SURVEY §5.3/§5.4) ----------------
    def save_progress(self, record: dict) -> None:
        """Atomic per-frame progress checkpoint: frame cursor + tracking
        state a resumed session needs (poses as nested lists)."""
        p = os.path.join(self.root, "progress.json")
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, p)

    def load_progress(self) -> Optional[dict]:
        p = os.path.join(self.root, "progress.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    def save_origin(self, lat: float, lon: float, alt: float) -> None:
        """GNSS map origin — the map_origion.txt mechanism
        (data_pretreat_flow.cpp:124-141)."""
        with open(os.path.join(self.root, "map_origin.json"), "w") as f:
            json.dump({"lat": lat, "lon": lon, "alt": alt}, f)

    def load_origin(self) -> Optional[dict]:
        p = os.path.join(self.root, "map_origin.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)
