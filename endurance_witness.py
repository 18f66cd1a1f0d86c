#!/usr/bin/env python3
"""Replay endurance.py's mapping run through the JAX back end.

    python3 endurance.py --out endurance.npz      # the port, on a GPU
    JAX_PLATFORMS=cpu python3 endurance_witness.py endurance.npz

endurance.py runs the port's `mapping` command over a long drive and saves,
per frame, the front end's odometry and the GNSS fix, and each loop edge
with the frame that inserted it. This script feeds the JAX package's
BackEnd, configured by the back_end section of the run's own config file,
the same odometry, `gnss_position` and `gnss_pose` a frame and, after the
frame that inserted it, the same loop edge, then `force_optimize`, as the
CLI does. It checks that both back ends made the same keyframes and ran
their pose-graph solves at the same frames, started by the same thing (the
keyframe and GNSS counts, a loop insertion, the final solve), and that the
two packages' optimized keyframes lie within GAP_TOL of each other. It
prints both packages' keyframe ATE beside the odometry's and the largest
gap, and exits non-zero if a check fails. It imports nothing of the port
and needs no GPU.

`--front-end FRAME` replays the JAX FrontEnd instead, over the frames
before a frame the port's run lost (replay_front_end): the NDT front end
only. A record of `endurance.py --front-end aloam` names its front end;
the back end replays it the same way, and aloam_witness.py holds its
A-LOAM steps to JAX's.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

# m: the PCG tolerance that chip_smoke.py holds the port's 2 048-node solve to (GRAPH_TOL["2048 nodes"])
GAP_TOL = 5e-2
LOST_STEP = 0.3  # m, a frame-to-frame motion error that counts a frame as lost (endurance.py's)


def back_end_config(text):
    """The JAX BackEndConfig of a config file's text."""
    from lidar_slam_tpu.config import load_config

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "config.yaml")
        with open(path, "w") as f:
            f.write(text)
        return load_config(path).back_end


def replay(data):
    """The JAX BackEnd over the record: (back end, keyframes' frames, the
    solves as (frame, what started it))."""
    from lidar_slam_tpu.pipeline.back_end import BackEnd

    solves, now = [], {"frame": -1, "by": "back_end"}

    class Recording(BackEnd):
        def _optimize(self):
            solves.append((now["frame"], now["by"]))
            return super()._optimize()

    loops = {int(f): (int(i0), int(i1), rel) for f, (i0, i1), rel in
             zip(data["loop_frames"], data["loop_index"], data["loop_rel"])}
    be = Recording(back_end_config(str(data["config"])))
    kf_frames = []
    for i, pose in enumerate(data["odom"]):
        now["frame"] = i
        if be.update(pose, time=i * 0.1, gnss_position=data["gnss_position"][i], gnss_pose=data["gnss_pose"][i]):
            kf_frames.append(i)
        if i in loops:
            now["by"] = "insert_loop_pose"
            be.insert_loop_pose(*loops[i])
            now["by"] = "back_end"
    now["by"] = "final"
    be.force_optimize()
    return be, kf_frames, solves


def drive_sweeps(drive_json):
    """sweep(i, pose) -> frame i's (points, mask, boxes), simulated with the
    JAX package's copy of the synthetic world from a record's drive
    parameters and seeds, as endurance.py simulates them."""
    import json

    from lidar_slam_tpu.io.synthetic import SyntheticWorld, simulate_scan

    p = json.loads(drive_json)
    world = SyntheticWorld.corridor(length=p["length"], width=p["width"], density=p["density"], seed=p["seed"])
    for center, heading, velocity in p["trucks"]:
        world.add_moving_box(center0=center, size=(4.0, 2.0, 2.0), heading=heading, velocity=velocity, n_points=200)

    def sweep(i, pose):
        return simulate_scan(world, pose, t=i * 0.1, max_range=p["max_range"], n_points=p["n_points"],
                             seed=p["scan_seed"] + i, noise=0.02)

    return sweep


def replay_front_end(data, frame, before=20):
    """The JAX FrontEnd, configured by the record's config file and started
    with an empty map at the port's odometry `before` frames ahead of
    `frame`, over the drive's sweeps up to frame + 1 (simulated with the
    JAX package's copy of the synthetic world from the record's drive
    parameters and seeds, as endurance.py simulates them): (frame, its
    motion error, the port's run's) for each, m. endurance.py
    --replay-front-end replays the same through the port's FrontEnd."""
    from lidar_slam_tpu.config import load_config
    from lidar_slam_tpu.pipeline.front_end import FrontEnd

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "config.yaml")
        with open(path, "w") as f:
            f.write(str(data["config"]))
        fe = FrontEnd(load_config(path).front_end)
    k0, k1 = frame - before, frame + 2
    gt = data["gt"]
    fe.set_init_pose(data["odom"][k0])
    sweep = drive_sweeps(str(data["drive"]))
    poses = []
    for i in range(k0, k1):
        pts, mask, boxes = sweep(i, gt[i])
        poses.append(np.asarray(fe.update(pts[mask], bboxes=boxes)[0]))

    def motion(P):
        P, G = np.asarray(P, np.float64), gt[k0:k1].astype(np.float64)
        d = lambda T: np.einsum("nij,njk->nik", np.linalg.inv(T[:-1]), T[1:])[:, :3, 3]  # noqa: E731
        return np.concatenate([[0.0], np.linalg.norm(d(P) - d(G), axis=1)])

    mine, port = motion(poses), motion(data["odom"][k0:k1])
    return [(k0 + j, float(mine[j]), float(port[j])) for j in range(k1 - k0)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("record", help="the .npz that endurance.py --out wrote")
    ap.add_argument("--front-end", type=int, metavar="FRAME",
                    help="replay_front_end up to FRAME (a lost frame) instead of the back end")
    ap.add_argument("--before", type=int, default=20, help="with --front-end: frames before FRAME")
    args = ap.parse_args(argv)
    from lidar_slam_tpu.io.trajectory import ate_rmse

    data = np.load(args.record)
    front = str(data["front_end"]) if "front_end" in data.files else "ndt"
    if args.front_end is not None:
        if front != "ndt":
            ap.error(f"--front-end replays the NDT front end; this record's is {front} (aloam_witness.py)")
        for i, mine, port in replay_front_end(data, args.front_end, args.before):
            print(f"[replay] frame {i}: motion error {mine:.4f} m in JAX, {port:.4f} m in the port's run"
                  + ("  <- lost" if max(mine, port) > LOST_STEP else ""))
        return 0
    t0 = time.perf_counter()
    be, kf_frames, solves = replay(data)
    seconds = time.perf_counter() - t0
    port_kf = data["kf_frames"].tolist()
    port_solves = list(zip(data["solve_frames"].tolist(), data["solve_by"].tolist()))
    same_kf, same_solves = kf_frames == port_kf, solves == port_solves
    print(f"{len(data['odom'])} frames of the {front} front end, {len(data['loop_frames'])} loop edges; replayed in "
          f"{seconds:.1f} s")
    print(f"keyframes: JAX {len(kf_frames)}, the port {len(port_kf)} "
          f"({'the same frames' if same_kf else 'NOT the same frames'})")
    print(f"solves: JAX {len(solves)}, the port {len(port_solves)} "
          f"({'at the same frames' if same_solves else 'NOT at the same frames'}); JAX {solves}")
    if not same_kf:
        return 1
    gt = data["gt"][kf_frames]
    port, jax_opt = data["optimized"], np.asarray(be.optimized_poses, np.float32)
    odo = np.stack([k.pose for k in be.key_frames])
    for name, poses in (("odometry", odo), ("the port's optimized", port), ("JAX's optimized", jax_opt)):
        print(f"keyframe ATE, {name}: {ate_rmse(poses, gt):.5f} m")
    gap = float(np.linalg.norm(port[:, :3, 3] - jax_opt[:, :3, 3], axis=1).max())
    print(f"port - JAX optimized keyframe positions: largest gap {gap:.3e} m (bound {GAP_TOL})")
    return 0 if same_solves and gap <= GAP_TOL else 1


if __name__ == "__main__":
    sys.exit(main())
