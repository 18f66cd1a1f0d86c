#!/usr/bin/env python3
"""Replay chip_smoke.py's mapping session through the JAX back end.

    python3 chip_smoke.py --session-out session.npz   # the port, on a GPU
    JAX_PLATFORMS=cpu python3 session_witness.py session.npz

chip_smoke.py's phase 13 runs the port's back half twice: the session as the
CLI wires it (the front end's odometry) and a stress run over that odometry
with a drift added. For each saved run this script feeds the JAX package's
BackEnd(BackEndConfig()) the same odometry a frame and, after the frame that
inserted it, the same loop edge, then force_optimize. It checks that both
back ends made the same keyframes, and prints each one's optimized keyframe
error to the truth beside the odometry's, and the largest position gap
between the two back ends' optimized keyframes. It exits non-zero if the
keyframes differ. It imports nothing of the port and needs no GPU.
"""

import argparse
import sys

import numpy as np


def replay(data, tag):
    from lidar_slam_tpu.pipeline.back_end import BackEnd, BackEndConfig

    odom = data[f"{tag}_odom"]
    loops = {int(f): (int(i0), int(i1), rel) for f, (i0, i1), rel in
             zip(data[f"{tag}_loop_frames"], data[f"{tag}_loop_index"], data[f"{tag}_loop_rel"])}
    be = BackEnd(BackEndConfig())
    kf_frames = []
    for i, pose in enumerate(odom):
        if be.update(pose, time=i * 0.1):
            kf_frames.append(i)
            if i in loops:
                be.insert_loop_pose(*loops[i])
    stats = be.force_optimize()
    return be, kf_frames, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("session", help="the .npz that chip_smoke.py --session-out wrote")
    args = ap.parse_args(argv)
    data = np.load(args.session)
    gt = data["gt"]
    ok = True
    for tag in ("cli", "drift"):
        be, kf_frames, stats = replay(data, tag)
        same = kf_frames == data[f"{tag}_kf_frames"].tolist()
        ok &= same
        kf_gt = gt[kf_frames][:, :3, 3]
        odo = np.stack([k.pose for k in be.key_frames])[:, :3, 3]
        port = data[f"{tag}_optimized"][:, :3, 3]
        jax_opt = np.asarray(be.optimized_poses)[:, :3, 3]
        err = {name: np.linalg.norm(p - kf_gt, axis=1) for name, p in
               (("odometry", odo), ("port", port), ("jax", jax_opt))} if same else {}
        print(f"[{tag}] {len(kf_frames)} keyframes ({'the same as' if same else 'NOT the same as'} the port's), "
              f"{len(data[f'{tag}_loop_frames'])} loop edges; JAX solve chi2 {stats['chi2_before']:.4f} -> "
              f"{stats['chi2_after']:.4f} in {stats['iterations']:.0f} iterations")
        for name, e in err.items():
            print(f"[{tag}] keyframe error to the truth, {name}: mean {e.mean():.5f} max {e.max():.5f} m")
        if same:
            print(f"[{tag}] port - JAX optimized keyframe positions: max {np.abs(port - jax_opt).max():.2e} m")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
