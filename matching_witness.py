#!/usr/bin/env python3
"""Replay chip_smoke.py's map-matching run through the JAX package.

    python3 chip_smoke.py --matching-out matching.npz   # the port, on a GPU
    JAX_PLATFORMS=cpu python3 matching_witness.py matching.npz [--split 0 4 7]

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

`--split K ...` splits the gap at frames K: from the port's own motion-model
guess at each, the JAX package's GPF and downsample of the port's raw rows
against the port's non-ground mask and downsampled frame, the JAX crop of
the global map against the port's local map cloud, and two JAX
alignments: its whole frame step on its own preprocessing and maps, and
its coarse-to-fine alignment of the port's downsampled frame against maps
built from the port's local cloud. If the last lands within trans_eps of
the port's pose where the first does not, the gap comes from the
preprocessing; if neither does, from the alignments themselves.
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


def split(data, cfg, frames):
    """The gap at each of `frames` split into preprocessing and alignment
    (see the module docstring); one line a frame."""
    import dataclasses

    import jax.numpy as jnp

    from lidar_slam_tpu.models.ground_seg import GroundSegConfig, segment_ground
    from lidar_slam_tpu.models.registration import build_ndt_map, ndt_align
    from lidar_slam_tpu.ops.pointcloud import PointCloud, finite_mask, voxel_downsample
    from lidar_slam_tpu.pipeline.matching import Matching, _match_step

    m = Matching(cfg, data["global_map"])
    ccfg = m._coarse_cfg()
    maps = []  # per local map the port aligned against: JAX's own crop's maps, and maps of the port's cloud
    for c, pts, msk in zip(data["port_local_origins"], data["port_local_pts"], data["port_local_msk"]):
        m.reset_local_map(c)
        own_pts, own_msk = np.asarray(m._local_cloud.points), np.asarray(m._local_cloud.mask)
        same = np.array_equal(own_msk, msk)
        gap = float(np.abs(own_pts[own_msk] - pts[msk]).max()) if same else float("nan")
        print(f"[split] local map at {np.round(c, 3).tolist()}: JAX {int(own_msk.sum())} points, the port "
              f"{int(msk.sum())}; {'the same rows' if same else 'NOT the same rows'}, largest point gap {gap:.2e} m")
        cloud = PointCloud(points=jnp.asarray(pts), mask=jnp.asarray(msk))
        maps.append(((m.ndt_map, m.coarse_ndt_map), (build_ndt_map(cloud, dataclasses.replace(cfg.ndt, dense_stats=False)),
                                                   build_ndt_map(cloud, dataclasses.replace(ccfg, dense_stats=False)))))
    eps = float(cfg.ndt.trans_eps)
    print("frame  GPF rows differing  frame rows (JAX / port)  frame point gap (m)  |own - port| (m)  "
          "|port inputs - port| (m)  iterations coarse/fine")
    for k in frames:
        raw, msk, pred = data["frames_pts"][k], data["frames_msk"][k], data["port_predicts"][k]
        port_pose = data["port_poses"][k]
        mj = np.asarray(msk & finite_mask(jnp.asarray(raw)))
        _, ng = segment_ground(PointCloud(points=jnp.where(mj[:, None], raw, 0.0), mask=jnp.asarray(mj)),
                               GroundSegConfig())
        gpf_diff = int(np.count_nonzero(mj & (np.asarray(ng) != data["port_nonground"][k])))
        mp = mj & data["port_nonground"][k]
        ds = voxel_downsample(PointCloud(points=jnp.where(mp[:, None], raw, 0.0), mask=jnp.asarray(mp)),
                              cfg.frame_leaf, out_capacity=cfg.frame_capacity)
        ds_pts, ds_msk = np.asarray(ds.points), np.asarray(ds.mask)
        p_pts, p_msk = data["port_frame_pts"][k], data["port_frame_msk"][k]
        ds_gap = (float(np.abs(ds_pts[ds_msk] - p_pts[p_msk]).max()) if np.array_equal(ds_msk, p_msk)
                  else float("nan"))
        (own_fine, own_coarse), (fine, coarse) = maps[int(data["port_local_index"][k])]
        pose_own = np.asarray(_match_step(own_fine, own_coarse, jnp.asarray(raw), jnp.asarray(msk),
                                          jnp.asarray(pred), cfg, ccfg)[2])
        frame = PointCloud(points=jnp.asarray(p_pts), mask=jnp.asarray(p_msk))
        rc = ndt_align(coarse, frame, jnp.asarray(pred), ccfg)
        rf = ndt_align(fine, frame, rc.pose, cfg.ndt)
        gap_own = float(np.linalg.norm(pose_own[:3, 3] - port_pose[:3, 3]))
        gap_in = float(np.linalg.norm(np.asarray(rf.pose)[:3, 3] - port_pose[:3, 3]))
        print(f"{k:5d}  {gpf_diff:19d}  {int(ds_msk.sum()):>11d} / {int(p_msk.sum()):<10d}  {ds_gap:19.2e}  "
              f"{gap_own:16.5f}  {gap_in:24.5f}  {int(rc.iterations)}/{int(rf.iterations)}"
              + ("  <- the alignments" if gap_in > eps else "  <- the preprocessing" if gap_own > eps else ""))


def rotation_gap(a, b):
    """The angle of a^T b, rad."""
    c = (np.trace(a[:3, :3].T @ b[:3, :3]) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("matching", help="the .npz that chip_smoke.py --matching-out wrote")
    ap.add_argument("--split", type=int, nargs="+", default=[], metavar="K",
                    help="split the gap at these frames into preprocessing and alignment")
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
    if args.split:
        split(data, cfg, args.split)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
