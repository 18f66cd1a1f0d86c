#!/usr/bin/env python3
"""Replay chip_smoke.py's map-matching run through the JAX package.

    python3 chip_smoke.py --matching-out matching.npz   # the port, on a GPU
    JAX_PLATFORMS=cpu python3 matching_witness.py matching.npz

chip_smoke.py's phase 15 localizes 16 frames of a real HDL-64 sweep density
in a global map at MatchingConfig() widths, through the port's
Matching.update. This script feeds the JAX package's Matching the same
configuration, global map, FullPose init pose and raw frames, frame after
frame, and prints both packages' per-frame position errors to the truth,
the largest per-frame pose gap between them, the frames where either loses
track (a frame's error over the guard), and the frames where the two differ
by more than the configuration's trans_eps. It exits non-zero if either
package's mean error over the guarded frames (those phase 15 guards, after
its warm-up) exceeds the guard, or the two give poses for different
frames. It imports nothing of the port and needs no GPU.
"""

import argparse
import json
import sys

import numpy as np

GUARD = 0.3  # bench.py matching_leg's mean pose-error guard, m


def jax_config(fields):
    """The JAX MatchingConfig with the saved fields (the port's are the
    JAX package's, field for field)."""
    from lidar_slam_tpu.models.registration import NDTConfig
    from lidar_slam_tpu.pipeline.matching import MatchingConfig

    fields = dict(fields)
    ndt = fields.pop("ndt")
    ndt["grid_dims"] = tuple(ndt["grid_dims"])
    return MatchingConfig(ndt=NDTConfig(**ndt), **fields)


def replay(data):
    """The JAX Matching's pose of every saved frame (None where it gives none)."""
    from lidar_slam_tpu.pipeline.matching import Matching

    cfg = jax_config(json.loads(str(data["config"])))
    m = Matching(cfg, data["global_map"])
    m.set_gnss_pose(data["init_pose"])
    poses = []
    for pts, msk in zip(data["frames_pts"], data["frames_msk"]):
        pose = m.update(None, preloaded=m.preload(pts, msk))
        poses.append(None if pose is None else np.asarray(pose, np.float32))
    return cfg, poses


def rotation_gap(a, b):
    """The angle of a^T b, rad."""
    c = (np.trace(a[:3, :3].T @ b[:3, :3]) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("matching", help="the .npz that chip_smoke.py --matching-out wrote")
    args = ap.parse_args(argv)
    data = np.load(args.matching)
    gt, port = data["gt"], data["port_poses"]
    first = int(data["guard_from"])
    cfg, jax_poses = replay(data)
    same_frames = len(jax_poses) == len(port) and all(p is not None for p in jax_poses)
    print(f"{len(port)} frames from the port, {sum(p is not None for p in jax_poses)} poses from JAX "
          f"({'the same frames' if same_frames else 'NOT the same frames'}); the guard covers frames {first}-"
          f"{len(port) - 1}")
    if not same_frames:
        return 1
    jx = np.stack(jax_poses)
    err = {"port": np.linalg.norm(port[:, :3, 3] - gt[:, :3, 3], axis=1),
           "jax": np.linalg.norm(jx[:, :3, 3] - gt[:, :3, 3], axis=1)}
    gap_t = np.linalg.norm(port[:, :3, 3] - jx[:, :3, 3], axis=1)
    gap_r = np.asarray([rotation_gap(a, b) for a, b in zip(port, jx)])
    eps = float(cfg.ndt.trans_eps)
    print("frame  port err (m)  jax err (m)  |port - jax| (m)  rotation gap (rad)")
    for i in range(len(port)):
        print(f"{i:5d}  {err['port'][i]:12.5f}  {err['jax'][i]:11.5f}  {gap_t[i]:16.5f}  {gap_r[i]:18.2e}"
              + ("  <- over trans_eps" if gap_t[i] > eps else ""))
    ok = True
    for name, e in err.items():
        mean = float(e[first:].mean())
        lost = np.flatnonzero(e > GUARD).tolist()
        ok &= mean <= GUARD
        print(f"[{name}] mean error {mean:.5f} m over frames {first}-{len(e) - 1} (all frames {e.mean():.5f}), "
              f"max {e.max():.5f} m; frames over the {GUARD} m guard (lost track): {lost or 'none'}")
    print(f"largest per-frame gap: {gap_t.max():.5f} m at frame {int(gap_t.argmax())}, {gap_r.max():.2e} rad at "
          f"frame {int(gap_r.argmax())}; frames more than trans_eps ({eps} m) apart: "
          f"{np.flatnonzero(gap_t > eps).tolist() or 'none'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
