"""Command-line entry points — the L6 launch layer (port of
lidar_slam_tpu/cli.py).

Replaces the reference's roslaunch files + rosservice calls
(launch/mapping.launch, matching.launch, /save_map, /optimize_map) with
plain subcommands over the same pipeline:

  python3 -m lidar_slam_tpu_torch mapping --kitti-raw <drive_dir> --out slam_data
  python3 -m lidar_slam_tpu_torch mapping --synthetic 60 --out slam_data
  python3 -m lidar_slam_tpu_torch matching --map slam_data --kitti-raw <drive_dir>
  python3 -m lidar_slam_tpu_torch inspect --kitti-raw <drive_dir>
  python3 -m lidar_slam_tpu_torch bench

`bench` runs the port's benchmark suite (bench.py: bench.py's legs and
metric lines on the card).

The arguments, the files under --out and the printed lines are the JAX
package's. Everything runs on the first CUDA card unless `--device` names
another device (`--device cpu`: the CPU, the counterpart of the JAX
package's JAX_PLATFORMS); without CUDA and without `--device cpu` the CLI
fails at once. Before the first frame the CLI builds the CUDA kernels its
path launches (nvcc, cached under build/kernels/), so a cold build shows as
start-up time, not in frame 0.

`mapping --mesh-devices N` starts N ranks itself (parallel/launch.py; no
torchrun): rank r on `cuda:r` under NCCL, or all on the CPU under gloo with
`--device cpu`. Rank 0 reads the frames and broadcasts each padded frame;
every rank tracks it with its alignments point-sharded over the ranks
(FrontEnd(mesh=)); rank 0 alone runs the back half and writes the store,
the trajectories and the map. On `--resume` every rank restores its front
end from the store.

Where the reference triggers map save / optimization via ROS services, these
run automatically at the end of a mapping session (and `BackEnd.force_optimize`
/ `Viewer.save_map` remain callable from the API).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

FRONT_ENDS = ("ndt", "aloam")  # mapping's front ends: --front-end, or the config's front_end_method


def _prefetch(iterable, depth: int = 4):
    """Run a frame source on a background thread with a bounded queue — the
    in-process form of the reference's cross-process stage overlap
    (launch/mapping.launch runs data_pretreat and front_end as separate ROS
    nodes): disk reads, decode, numpy padding and the upload for frame i+1
    run while the main thread works on frame i. The upload is a pageable
    copy on the card's default stream, so it waits for the work queued
    there. A producer's exception is re-raised on the consumer side."""
    import queue
    import threading

    q = queue.Queue(maxsize=depth)
    _END = object()
    err = []

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            if err:
                raise err[0]
            break
        yield item


def _path_kernels(ndt_configs, dev, aloam: bool = False, sharded: bool = False, pose_graph: bool = False) -> list:
    """The CUDA sources a path launches on `dev`: ndt_newton for each NDT
    configuration that aligns in one launch, else K1 (the fused gather) or
    K3 (the onehot gather) under the host loop; K2 for A-LOAM; pose_pcg
    where the path solves a pose graph (its PCG, once the graph's capacity
    leaves the dense solver). `sharded`: the configurations align
    point-sharded over a mesh, always through the host loop."""
    from .models.registration.ndt import takes_newton_kernel

    if dev.type != "cuda":
        return []
    stems = set()
    for c in ndt_configs:
        gather = c.resolve_gather(dev)
        if takes_newton_kernel(c, dev) and not sharded:
            stems.add("ndt_newton")
        elif gather == "fused":
            stems.add("ndt_fused")
        elif gather == "onehot":
            stems.add("ndt_gather")
    if aloam:
        stems.add("knn_fused")
    if pose_graph:
        stems.add("pose_pcg")
    return sorted(stems)


def _build_kernels(stems, log: bool = True) -> None:
    """Build (or find in build/kernels/) and load each kernel, one nvcc
    each, all started together: the run's `setup.kernels` span, counting
    `kernels_built` (nvcc runs; the others were found built)."""
    from concurrent.futures import ThreadPoolExecutor

    from .ops.cuda import build
    from .utils import watchdog

    if not stems:
        return
    t0 = time.time()
    with watchdog.span("setup.kernels"):
        with ThreadPoolExecutor(len(stems)) as pool:
            infos = list(pool.map(build.build, stems))
        for stem in stems:
            build.load(stem)
        watchdog.count("kernels_built", sum(info.seconds > 0.0 for info in infos))
    if log:
        print(f"kernels: {', '.join(stems)} ready in {time.time() - t0:.1f}s")


def _send_frame(mesh, preloaded, bboxes, max_bboxes: int) -> None:
    """Rank 0's half of a frame's broadcast: a header (1, box count), the
    padded points with the mask as a fourth column, and the boxes; with
    `preloaded=None`, the end header (0, 0)."""
    import torch

    from .parallel.collectives import broadcast

    nb = 0 if bboxes is None else min(len(bboxes), max_bboxes)
    broadcast(torch.tensor([int(preloaded is not None), nb], device=mesh.device), mesh)
    if preloaded is None:
        return
    pts, msk = preloaded
    broadcast(torch.cat([pts, msk[:, None].to(torch.float32)], dim=1), mesh)
    if nb:
        boxes = torch.zeros((max_bboxes, 8), dtype=torch.float32)
        boxes[:nb] = torch.as_tensor(np.asarray(bboxes, np.float32)[:nb])
        broadcast(boxes.to(mesh.device), mesh)


def _follow_frames(fe, mesh, raw_capacity: int, max_bboxes: int) -> None:
    """A rank other than 0: track every frame rank 0 broadcasts, until the
    end header."""
    import torch

    from .parallel.collectives import broadcast

    dev = mesh.device
    while True:
        more, nb = broadcast(torch.zeros(2, dtype=torch.int64, device=dev), mesh).tolist()
        if not more:
            return
        buf = broadcast(torch.empty((raw_capacity, 4), dtype=torch.float32, device=dev), mesh)
        boxes = None
        if nb:
            boxes = broadcast(torch.empty((max_bboxes, 8), dtype=torch.float32, device=dev), mesh)
            boxes = boxes[:nb].cpu().numpy()
        fe.update(None, bboxes=boxes, preloaded=(buf[:, :3].contiguous(), buf[:, 3] > 0.5))


def _mapping_rank(mesh, args) -> int:
    """One rank of `mapping --mesh-devices N`."""
    return _run_mapping(args, mesh.device, mesh)


def _run_mapping(args, dev, mesh=None) -> int:
    """A mapping session. On the lead rank (rank 0, or the only one) it runs
    under its RunHealth, the run's tracer (utils/watchdog.py), active from
    before the kernel build to the end."""
    from .utils.watchdog import RunHealth

    if mesh is not None and mesh.rank != 0:
        return _mapping_session(args, dev, mesh, None)
    health = RunHealth()
    with health.active():
        return _mapping_session(args, dev, mesh, health)


def _mapping_session(args, dev, mesh, health) -> int:
    import itertools
    import json

    from .config import load_config
    from .io.keyframe_store import KeyframeStore
    from .io.trajectory import write_kitti_trajectory, ate_rmse
    from .pipeline import BackEnd, FrontEnd, LoopClosing, Viewer

    lead = health is not None
    cfg = load_config(args.config)
    resume = bool(getattr(args, "resume", False))
    aloam = getattr(args, "front_end", "ndt") == "aloam"
    front_ndt = [] if aloam else [cfg.front_end.ndt]
    stems = set(_path_kernels(front_ndt, dev, aloam=aloam, sharded=mesh is not None))
    if lead:
        stems |= set(_path_kernels([cfg.loop_closing.ndt], dev, pose_graph=True))
    _build_kernels(sorted(stems), log=lead)
    # ranks other than 0 only read a resumed store, never write or clear it
    store = KeyframeStore(args.out, resume=resume) if lead or resume else None
    if aloam:
        fe = _AloamFrontEnd(cfg.aloam, device=dev)
    else:
        fe = FrontEnd(cfg.front_end, device=dev, mesh=mesh)
    if lead:
        be = BackEnd(cfg.back_end, store=store, device=dev)
        lc = LoopClosing(cfg.loop_closing, store=store, data_path=args.out, device=dev)
        viewer = Viewer(cfg.viewer, store, device=dev)

    # --- session resume (SURVEY §5.3/§5.4): rebuild tracking + graph state
    # from the store and continue where the interrupted run stopped
    est = []
    skip_frames = 0
    progress = store.load_progress() if resume else None
    if progress is not None and len(store) > 0:
        # stored keyframe poses are map-frame (GNSS re-anchored); the front
        # end tracks in its own odometry frame and the live trajectory is
        # written in that frame — restore both frames consistently
        o2m = progress.get("odom_to_map")
        M = np.eye(4, dtype=np.float32) if o2m is None else np.asarray(o2m, np.float32)
        Minv = np.linalg.inv(M).astype(np.float32)
        n_kf = len(store)
        if lead:
            be.restore_from_store(store, odom_to_map=M)
            # replaying LoopClosing over the stored keyframes rebuilds SC
            # state and re-detects the loops the original run found
            for k in range(n_kf):
                rec = store.load(k)
                loop = lc.update(k, rec["pose"], gnss_position=rec.get("gnss"))
                if loop is not None:
                    be.insert_loop_pose(loop.index0, loop.index1, loop.relative_pose)
                viewer.update_with_new_key_frame(k, rec["pose"])
        if hasattr(fe, "restore"):
            local_n = getattr(cfg.front_end, "local_frame_num", 20)
            kfs = []
            for k in range(max(0, n_kf - local_n), n_kf):
                rec = store.load(k)
                rec["pose"] = (Minv @ np.asarray(rec["pose"], np.float32)).astype(np.float32)
                kfs.append(rec)
            fe.restore(
                kfs,
                total_keyframes=n_kf,
                last_pose=np.asarray(progress["last_pose"], np.float32),
                predict_pose=np.asarray(progress["predict_pose"], np.float32),
            )
        skip_frames = int(progress["frames_done"])
        live = f"{store.traj_dir}/laser_odom_live.txt"
        if lead and os.path.exists(live):
            from .io.trajectory import read_kitti_trajectory

            est = list(read_kitti_trajectory(live))[:skip_frames]
        if lead:
            print(f"resumed: {n_kf} keyframes, {skip_frames} frames already done")
    if not lead:
        _follow_frames(fe, mesh, cfg.front_end.raw_capacity, cfg.front_end.max_bboxes)
        return 0

    def _stage(source):
        # the upload happens on the prefetch thread: frame i+1's host-to-
        # device copy is issued while the main thread works on frame i
        for frame in source:
            frame["preloaded"] = fe.preload(frame["points"])
            yield frame

    def _skipping(source):
        for i, frame in enumerate(source):
            if i < skip_frames:
                continue
            yield i, frame

    frames = _skipping(_prefetch(_stage(_frame_source(args))))
    gt = []
    live_path = f"{store.traj_dir}/laser_odom_live.txt"
    if skip_frames == 0:
        open(live_path, "w").close()
    t_start = time.time()
    for i in itertools.count(skip_frames):
        with health.span("handover", frame=i):
            item = next(frames, None)
        if item is None:
            break
        _, frame = item
        with health.span("frame", frame=i):
            if mesh is not None:
                _send_frame(mesh, frame["preloaded"], frame.get("bboxes"), cfg.front_end.max_bboxes)
            with health.stage("front_end"):
                pose, _ = fe.update(
                    frame["points"], bboxes=frame.get("bboxes"),
                    preloaded=frame.get("preloaded"),
                )
            health.frame(pose)
            est.append(pose)
            if frame.get("gt_pose") is not None:
                gt.append(frame["gt_pose"])
            gnss = frame.get("gnss_position")
            pts = frame["points"]
            with health.stage("back_end"):
                new_kf = be.update(
                    pose,
                    time=frame.get("time", i * 0.1),
                    gnss_position=gnss,
                    gnss_pose=frame.get("gnss_pose"),
                    cloud_points=pts[: len(pts)],
                    cloud_mask=np.ones(len(pts), bool),
                )
            if new_kf:
                kf = be.latest_keyframe()
                with health.span("viewer"):
                    viewer.update_with_new_key_frame(kf.index, kf.pose)
                with health.stage("loop_closing", budget_ms=500.0):
                    loop = lc.update(kf.index, kf.pose, gnss_position=gnss)
                if loop is not None:
                    print(f"loop closure: {loop.index0} <- {loop.index1}")
                    with health.span("loop_insert"):
                        be.insert_loop_pose(loop.index0, loop.index1, loop.relative_pose)
                if be.has_new_optimized():
                    with health.span("viewer"):
                        viewer.update_with_optimized_poses(be.get_optimized_poses())
            with health.span("progress"):
                with open(live_path, "a") as f:
                    f.write(" ".join(f"{v:.9g}" for v in np.asarray(pose, np.float32)[:3, :].reshape(-1)) + "\n")
                o2m = be._odom_to_map
                store.save_progress({
                    "frames_done": i + 1,
                    "last_pose": np.asarray(pose, np.float32).tolist(),
                    "predict_pose": np.asarray(
                        getattr(fe, "predict_pose", pose), np.float32
                    ).tolist(),
                    "odom_to_map": None if o2m is None else np.asarray(o2m, np.float32).tolist(),
                })
                if i % 20 == 0:
                    print(f"frame {i}: pose {np.asarray(pose)[:3, 3]}")
    if mesh is not None:
        _send_frame(mesh, None, None, cfg.front_end.max_bboxes)

    stats = be.force_optimize()
    if be.get_optimized_poses() is not None:
        viewer.update_with_optimized_poses(be.optimized_poses)
    out = viewer.save_map()
    write_kitti_trajectory(f"{store.traj_dir}/laser_odom.txt", np.stack(est))
    dt = time.time() - t_start
    print(f"mapping done: {len(est)} frames in {dt:.1f}s ({len(est)/dt:.2f} fps), "
          f"{len(be.key_frames)} keyframes, {len(lc.detected)} loops, map {out}")
    print(f"run health: {json.dumps(health.summary())}")
    if gt:
        write_kitti_trajectory(f"{store.traj_dir}/ground_truth.txt", np.stack(gt))
        print(f"ATE vs ground truth: {ate_rmse(np.stack(est), np.stack(gt)):.3f} m")
    return 0


def _run_mapping_mesh(parser, args) -> int:
    """`mapping --mesh-devices N`: start N ranks of the mapping run and
    return rank 0's exit code. On the card (no --device, or --device cuda)
    rank r runs on cuda:r under NCCL; another --device puts every rank
    there under gloo. Exits 2 when the cards are fewer than N, and on
    --device cuda:K, which names one card for N ranks."""
    import torch

    from .parallel.launch import launch

    n = args.mesh_devices
    if args.front_end == "aloam":
        parser.error("--mesh-devices shards the NDT front end's alignments; --front-end aloam has no sharded form")
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda":
        if dev.index is not None:
            parser.error(f"--mesh-devices {n} runs rank r on cuda:r; --device {args.device} names one card "
                         f"(pass --device cuda or leave it out)")
        have = torch.cuda.device_count()
        if have < n:
            print(f"lidar_slam_tpu_torch: --mesh-devices {n} needs {n} CUDA cards, found {have}", file=sys.stderr)
            return 2
    return launch(_mapping_rank, n, args=(args,), device=None if dev.type == "cuda" else args.device, timeout=None)


def _run_matching(args, dev) -> int:
    from .config import load_config
    from .pipeline import Matching

    cfg = load_config(args.config)
    _build_kernels(_path_kernels([cfg.matching.ndt], dev))
    with np.load(f"{args.map}/map/filtered_map.npz") as z:
        gmap = z["points"]
    matcher = Matching(cfg.matching, gmap, device=dev)
    errs = []
    for i, frame in enumerate(_prefetch(_frame_source(args))):
        if not matcher.has_inited():
            matcher.update(frame["points"])
            init = frame.get("gnss_pose")
            if init is None and frame.get("gt_pose") is not None:
                init = frame["gt_pose"]
            if init is not None:
                matcher.set_gnss_pose(init)
            continue
        pose = matcher.update(frame["points"])
        if frame.get("gt_pose") is not None and pose is not None:
            errs.append(np.linalg.norm(pose[:3, 3] - frame["gt_pose"][:3, 3]))
        if i % 20 == 0 and pose is not None:
            print(f"frame {i}: pose {pose[:3, 3]}")
    if errs:
        print(f"localization mean error: {np.mean(errs):.3f} m over {len(errs)} frames")
    return 0


def _AloamFrontEnd(config=None, device=None):
    """A-LOAM front end behind the FrontEnd.update API — the
    mapping_with_aloam.launch wiring (A-LOAM odometry+mapping feeding the
    lidar_localization back end): a sweep is one stream of device work and
    one host read (pipeline/aloam/pipeline.py). `config` is the YAML's
    `aloam` section (pipeline.aloam.AloamConfig; its defaults without one);
    its `features.capacity` sizes the padded sweep, and a sweep with more
    returns is refused, never cut."""
    from .pipeline.aloam import AloamConfig, AloamPipeline

    cfg = AloamConfig() if config is None else config
    return AloamPipeline(cfg.features, cfg.odometry, cfg.mapping, device=device)


def _run_inspect(args) -> int:
    """Integration sanity check of data decode + extrinsics + ENU — the
    test_frame_node role (src/apps/test_frame_node.cpp:22-99) without rviz:
    prints per-frame stats and validates pose/point invariants."""
    ok = True
    for i, frame in enumerate(_frame_source(args)):
        if i >= args.frames:
            break
        pts = np.asarray(frame["points"])
        finite = np.isfinite(pts).all(axis=1)
        r = np.linalg.norm(pts[finite], axis=1) if finite.any() else np.zeros(1)
        pose = frame.get("gnss_pose", frame.get("gt_pose"))
        line = (
            f"frame {i}: {len(pts)} pts ({finite.mean()*100:.1f}% finite), "
            f"range [{r.min():.1f}, {r.max():.1f}] m"
        )
        if pose is not None:
            R = np.asarray(pose)[:3, :3]
            orth = np.abs(R @ R.T - np.eye(3)).max()
            line += f", pose t={np.asarray(pose)[:3, 3]}, |RR^T - I|={orth:.1e}"
            if orth > 1e-3:
                ok = False
                line += "  <-- NON-ORTHONORMAL ROTATION"
        print(line)
    print("inspect:", "OK" if ok else "FAILED")
    return 0 if ok else 1


def _frame_source(args):
    """Yield frames from KITTI raw / odometry dirs or the synthetic world."""
    if getattr(args, "kitti_raw", None):
        from .io.kitti import KittiRawReader
        from .io.kitti_writer import read_bbox_dir

        # detector-bbox channel: explicit --bbox-dir, else the conventional
        # <date_dir>/bbox/<drive_id> next to the drive (the reference's
        # hard-coded per-frame txt path made explicit, front_end.cpp:427-530)
        bbox_dir = getattr(args, "bbox_dir", None)
        if bbox_dir is None:
            drive = os.path.basename(os.path.normpath(args.kitti_raw))
            parts = drive.split("_drive_")
            if len(parts) == 2:
                cand = os.path.join(
                    os.path.dirname(os.path.normpath(args.kitti_raw)),
                    "bbox",
                    parts[1].replace("_sync", ""),
                )
                bbox_dir = cand if os.path.isdir(cand) else None
        for f in KittiRawReader(args.kitti_raw):
            yield {
                "points": f["points"],
                "time": f["time"],
                "gnss_position": f["gnss_pose"][:3, 3],
                "gnss_pose": f["gnss_pose"],
                "bboxes": read_bbox_dir(bbox_dir, f["index"]) if bbox_dir else None,
            }
    elif getattr(args, "kitti_odometry", None):
        from .io.kitti import KittiOdometryReader

        root, seq = args.kitti_odometry.rsplit(":", 1)
        for f in KittiOdometryReader(root, seq):
            yield {"points": f["points"], "time": f["time"], "gt_pose": f["gt_pose"]}
    else:
        from .io.synthetic import (
            SyntheticWorld,
            make_hairpin_trajectory,
            make_trajectory,
            simulate_scan,
            simulate_spinning_scan,
        )

        n = int(args.synthetic)
        world = SyntheticWorld.corridor(length=max(40, n), seed=0)
        if n >= 72:
            # long runs: out-and-back with a realistically-rated U-turn
            # (<= ~5 deg/frame, like a car at 10 Hz)
            n_turn = max(36, n // 2)
            rest = max(2, (n - n_turn) // 2)
            gt = make_hairpin_trajectory(n_out=rest, n_turn=n_turn, n_back=rest, speed=1.0)
        else:
            gt = make_trajectory(n, speed=1.0)
        spinning = getattr(args, "front_end", "ndt") == "aloam"
        for i in range(len(gt)):
            if spinning:
                pts, mask = simulate_spinning_scan(
                    world, gt[i], t=i * 0.1, n_scans=64, n_azimuth=1024, seed=i
                )
                bboxes = None
            else:
                pts, mask, bboxes = simulate_scan(world, gt[i], t=i * 0.1, n_points=16384, seed=i)
            yield {
                "points": pts[mask],
                "time": i * 0.1,
                "gt_pose": gt[i],
                "gnss_position": gt[i][:3, 3] + np.random.default_rng(i).normal(0, 0.3, 3),
                "bboxes": bboxes,
            }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lidar_slam_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_source(sp):
        sp.add_argument("--kitti-raw", help="KITTI raw *_sync drive directory")
        sp.add_argument(
            "--bbox-dir", dest="bbox_dir", default=None,
            help="per-frame detector bbox txt dir (default: <date>/bbox/<drive> "
                 "next to --kitti-raw when present)",
        )
        sp.add_argument("--kitti-odometry", help="KITTI odometry '<root>:<seq>'")
        sp.add_argument("--synthetic", default=None, help="synthetic run with N frames")
        sp.add_argument("--config", default=None, help="YAML config path")
        sp.add_argument(
            "--device", default=None,
            help="torch device to run on (default: the first CUDA card; 'cpu' runs on "
                 "the CPU — the counterpart of the JAX package's JAX_PLATFORMS)",
        )

    mp = sub.add_parser("mapping", help="build a map (front end + back end + loops)")
    add_source(mp)
    mp.add_argument("--out", default="slam_data")
    mp.add_argument(
        "--mesh-devices",
        type=int,
        default=0,
        help="shard per-frame NDT reductions over N ranks (0 = off): rank r on CUDA card r "
             "(NCCL), or every rank on the CPU with --device cpu (gloo)",
    )
    mp.add_argument(
        "--front-end", dest="front_end", choices=FRONT_ENDS, default=None,
        help="odometry front end: NDT scan-to-map (mapping.launch) or "
             "A-LOAM two-stage (mapping_with_aloam.launch); default: the "
             "config's front_end_method (ndt without one)",
    )
    mp.add_argument(
        "--resume", action="store_true",
        help="continue an interrupted mapping run from --out's keyframe "
             "store + progress checkpoint (the reference wipes and restarts)",
    )

    lp = sub.add_parser("matching", help="localize against a prebuilt map")
    add_source(lp)
    lp.add_argument("--map", default="slam_data")

    ip = sub.add_parser(
        "inspect",
        help="decode + sanity-check a frame source (the test_frame_node role)",
    )
    add_source(ip)
    ip.add_argument("--frames", type=int, default=5)

    bp = sub.add_parser("bench", help="the benchmark suite: bench.py's legs and metric lines (bench.py)")
    bp.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the first CUDA card; 'cpu' runs every leg on the CPU)",
    )

    args = p.parse_args(argv)
    if args.cmd == "bench":
        from . import bench

        return bench.main([] if args.device is None else ["--device", args.device])
    if not (args.kitti_raw or args.kitti_odometry or args.synthetic):
        p.error(f"{args.cmd} needs --kitti-raw, --kitti-odometry or --synthetic N")
    if args.cmd == "mapping" and args.front_end is None:
        from .config import load_config

        args.front_end = load_config(args.config).front_end_method
        if args.front_end not in FRONT_ENDS:
            p.error(f"front_end_method {args.front_end!r} in {args.config}: one of {', '.join(FRONT_ENDS)}")
    if args.cmd == "mapping" and args.mesh_devices > 1:
        return _run_mapping_mesh(p, args)
    from . import device

    try:
        dev = device(args.device)
    except RuntimeError as e:
        p.error(str(e))
    if args.cmd == "mapping":
        return _run_mapping(args, dev)
    if args.cmd == "matching":
        return _run_matching(args, dev)
    return _run_inspect(args)


if __name__ == "__main__":
    sys.exit(main())
