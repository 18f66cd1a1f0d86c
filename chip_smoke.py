#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (lidar_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main path, NDT scan-to-map tracking, at the KITTI
HDL-64 operating point of bench.py (raw scans padded to 131 072 points,
frames of <= 32 768 points, 1 m NDT voxels on a 256 x 256 x 64 grid,
65 536 compact voxels, a 20-keyframe local map):

  1. device and power limit (exits non-zero without CUDA: never runs on
     the CPU);
  2. builds kernel K1 (csrc/ndt_fused.cu) with nvcc;
  3. K1 against its plain PyTorch version on the card, direct7 and
     radius27, with bench.py's parity tolerances, and both device times;
  4. 20-frame chained scan-match drive (bench.py scan_match_leg);
  5. FrontEnd.update over 18 frames, then front_end_drive over 15 frames
     (bench.py front_end_leg);
  6. checks that K1 was launched in phases 4 and 5.

Any failed check ends the run with a non-zero exit code. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

RAW_CAP = 131072
FRAME_CAP = 32768
N_FRAMES = 20
# bench.py:187-189
TOL = {"score": dict(rtol=2e-4, atol=0.0), "grad": dict(rtol=2e-3, atol=1e-3), "hess": dict(rtol=2e-3, atol=1e-2)}


def log(msg):
    print(msg, flush=True)


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def build_workload(dev):
    """bench.py:63-95: corridor map cloud (20 keyframes, 0.3 m leaf),
    20 raw scans padded to RAW_CAP, ground truth, perturbed first guess."""
    import torch

    from lidar_slam_tpu_torch.io import SyntheticWorld, make_trajectory, simulate_scan
    from lidar_slam_tpu_torch.ops import PointCloud, voxel_downsample

    world = SyntheticWorld.corridor(length=120.0, width=18.0, density=40.0, seed=0)
    traj = make_trajectory(40, speed=2.0)
    kf_pts = []
    for i in range(0, 40, 2):
        pts, mask, _ = simulate_scan(world, traj[i], max_range=80.0, n_points=RAW_CAP, seed=i, noise=0.015)
        kf_pts.append((pts[mask] @ traj[i][:3, :3].T + traj[i][:3, 3])[:16384])
    map_cloud = PointCloud.from_points(np.concatenate(kf_pts).astype(np.float32), device=dev)
    map_cloud = voxel_downsample(map_cloud, 0.3, out_capacity=map_cloud.capacity)

    all_pts = np.zeros((N_FRAMES, RAW_CAP, 3), np.float32)
    all_msk = np.zeros((N_FRAMES, RAW_CAP), bool)
    for i in range(N_FRAMES):
        pts, mask, _ = simulate_scan(
            world, traj[10 + i], max_range=80.0, n_points=RAW_CAP, seed=1000 + i, noise=0.02
        )
        all_pts[i], all_msk[i] = pts, mask
    gt = traj[10:10 + N_FRAMES]
    guess0 = gt[0].copy()
    guess0[:3, 3] += np.random.default_rng(7).normal(0, 0.3, 3)
    return map_cloud, torch.from_numpy(all_pts).to(dev), torch.from_numpy(all_msk).to(dev), gt, guess0


def device_ms(fn, reps=30):
    """Median device time of fn() in ms, from CUDA events. A long sleep
    kernel is queued first so the host enqueues the whole call before the
    device reaches it: the events then bracket device work only."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_parity(workload, cfg, stencil):
    """Phase 3 for one stencil: K1 vs the plain version at the operating
    point (bench.py:164-191). Returns (max_abs_err, kernel ms, plain ms)."""
    from lidar_slam_tpu_torch.models.registration import build_ndt_map
    from lidar_slam_tpu_torch.models.registration.ndt import _reduce
    from lidar_slam_tpu_torch.pipeline.front_end import _preprocess

    map_cloud, all_pts, all_msk, _, guess0 = workload
    cfg = dataclasses.replace(cfg, stencil=stencil)
    ndt_map = build_ndt_map(map_cloud, cfg)
    frame = _preprocess(all_pts[0], all_msk[0], FRAME_CAP, 0.5)
    pts, msk, w = frame.points, frame.mask, frame.get_weights()
    pose6 = np.zeros(6, np.float32)
    pose6[:3] = guess0[:3, 3]
    plain_cfg = dataclasses.replace(cfg, gather="two_level")

    k = _reduce(ndt_map, pts, msk, w, pose6, cfg).cpu().numpy()
    p = _reduce(ndt_map, pts, msk, w, pose6, plain_cfg).cpu().numpy()
    check(k[28] == 0.0, f"{stencil}: unresolved = {k[28]}")
    for name, sl in (("score", slice(0, 1)), ("grad", slice(1, 7)), ("hess", slice(7, 28))):
        tol = TOL[name]
        bad = np.abs(k[sl] - p[sl]) > tol["atol"] + tol["rtol"] * np.abs(p[sl])
        check(not bad.any(), f"{stencil} {name}: kernel {k[sl]} vs plain {p[sl]}")
    err = float(np.max(np.abs(k[:28] - p[:28])))
    ms = device_ms(lambda: _reduce(ndt_map, pts, msk, w, pose6, cfg))
    plain_ms = device_ms(lambda: _reduce(ndt_map, pts, msk, w, pose6, plain_cfg), reps=10)
    log(f"[parity {stencil}] {int(msk.sum())} points x {len(ndt_map.keys)} table rows: "
        f"score {k[0]:.4f} (plain {p[0]:.4f}), |grad| {np.linalg.norm(k[1:7]):.4f}, "
        f"max |kernel - plain| {err:.3e}; K1 {ms:.4f} ms, plain {plain_ms:.4f} ms (device, median)")
    return err, ms, plain_ms


def scan_match_drive(workload, cfg, stencil):
    """Phase 4 for one stencil (bench.py:98-161): 20 chained frames,
    motion-model prediction, pose-error guard <= 0.10 m mean."""
    import torch

    from lidar_slam_tpu_torch.models.registration import build_ndt_map, ndt_align
    from lidar_slam_tpu_torch.pipeline.front_end import _preprocess

    map_cloud, all_pts, all_msk, gt, guess0 = workload
    cfg = dataclasses.replace(cfg, stencil=stencil)
    ndt_map = build_ndt_map(map_cloud, cfg)

    def drive():
        last = predict = torch.as_tensor(guess0)
        poses, iters = [], []
        for i in range(N_FRAMES):
            frame = _preprocess(all_pts[i], all_msk[i], FRAME_CAP, 0.5)
            r = ndt_align(ndt_map, frame, predict, cfg)
            check(r.unresolved == 0.0, f"{stencil}: unresolved {r.unresolved}")
            step = torch.linalg.solve(last, r.pose)
            last, predict = r.pose, r.pose @ step
            poses.append(r.pose.numpy())
            iters.append(r.iterations)
        return np.stack(poses), iters

    warm, _ = drive()  # warm-up: allocator and first-call costs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses, iters = drive()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    errs = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    log(f"[scan-match {stencil}] {dt / N_FRAMES * 1e3:.2f} ms/frame ({N_FRAMES / dt:.1f} fps), "
        f"iterations mean {np.mean(iters):.2f} max {max(iters)}, "
        f"pose error mean {errs.mean():.4f} max {errs.max():.4f} m")
    check(errs.mean() <= 0.10, f"scan-match {stencil}: pose error guard ({errs.mean():.4f} m)")
    # every sum on the path is taken in a fixed order: a rerun is bit-identical
    check(np.array_equal(warm, poses), f"scan-match {stencil}: two runs of the drive differ")
    return dt / N_FRAMES * 1e3


def front_end(dev):
    """Phase 5 (bench.py:315-402): FrontEnd.update and front_end_drive."""
    import torch

    from lidar_slam_tpu_torch.io import SyntheticWorld, make_trajectory, simulate_scan
    from lidar_slam_tpu_torch.models.registration import NDTConfig
    from lidar_slam_tpu_torch.pipeline import FrontEnd, FrontEndConfig, front_end_drive, init_front_end_drive

    cfg = FrontEndConfig(
        ndt=NDTConfig(
            resolution=1.0, grid_dims=(256, 256, 64), point_chunk=8192, max_iter=30,
            stencil="direct7", gather="auto", max_compact_voxels=65536, fused_window=512,
        ),
    )
    world = SyntheticWorld.corridor(length=120.0, width=18.0, density=40.0, seed=0)
    traj = make_trajectory(40, speed=0.8)
    scans = [
        simulate_scan(world, traj[i], max_range=80.0, n_points=RAW_CAP, seed=3000 + i, noise=0.02)[:2]
        for i in range(18)
    ]
    fe = FrontEnd(cfg, device=dev)
    fe.set_init_pose(traj[0])
    loaded = [fe.preload(p, m) for p, m in scans]
    for i in range(6):  # warm-up, through a deferred keyframe update
        fe.update(None, preloaded=loaded[i])
    torch.cuda.synchronize()
    n_kf0 = fe.n_keyframes
    t0 = time.perf_counter()
    errs = []
    for i in range(6, 18):
        pose, _ = fe.update(None, preloaded=loaded[i])
        errs.append(np.linalg.norm(pose[:3, 3] - traj[i][:3, 3]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"[front end] FrontEnd.update {dt / 12 * 1e3:.2f} ms/frame ({12 / dt:.1f} fps), "
        f"{fe.n_keyframes - n_kf0} keyframes in 12 frames, {fe.n_keyframes} total, "
        f"pose error mean {np.mean(errs):.4f} m")
    check(np.mean(errs) < 0.15, f"front-end error guard ({np.mean(errs):.4f} m)")

    pts_seq = torch.stack([p for p, _ in loaded[3:18]])
    msk_seq = torch.stack([m for _, m in loaded[3:18]])
    front_end_drive(init_front_end_drive(cfg, init_pose=traj[0], device=dev),
                    torch.stack([p for p, _ in loaded[:3]]), torch.stack([m for _, m in loaded[:3]]), cfg)
    st = init_front_end_drive(cfg, init_pose=traj[3], device=dev)
    best = float("inf")
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, poses, kfs, unres = front_end_drive(st, pts_seq, msk_seq, cfg)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    poses = poses.numpy()
    # the drive restarts from an empty map at frame 3: skip its transient
    errs_d = [np.linalg.norm(poses[k][:3, 3] - traj[3 + k][:3, 3]) for k in range(3, 15)]
    log(f"[front end] front_end_drive {best / 15 * 1e3:.2f} ms/frame ({15 / best:.1f} fps), "
        f"{int(kfs.sum())} keyframes in 15 frames, pose error mean {np.mean(errs_d):.4f} m, "
        f"unresolved max {float(unres.max())}")
    check(float(unres.max()) == 0.0, "front_end_drive: unresolved > 0")
    check(np.mean(errs_d) < 0.15, f"front-end drive error guard ({np.mean(errs_d):.4f} m)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs only on a GPU", file=sys.stderr)
        return 2
    import lidar_slam_tpu_torch
    from lidar_slam_tpu_torch.models.registration import NDTConfig
    from lidar_slam_tpu_torch.ops.cuda import build, ndt_fused

    check("jax" not in sys.modules, "the port imported jax")
    dev = lidar_slam_tpu_torch.device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi = smi[0] if smi else "nvidia-smi: no output"
    log(f"[device] {kind} (count {count}); {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    info = build.build("ndt_fused")
    ptxas = [ln.strip() for ln in info.log.splitlines() if "registers" in ln or "spill" in ln]
    log(f"[build] ndt_fused: nvcc {info.seconds:.1f} s -> {info.path}")
    for ln in ptxas:
        log(f"[build]   {ln}")

    cfg = NDTConfig(
        resolution=1.0, grid_dims=(256, 256, 64), point_chunk=8192, max_iter=30,
        stencil="direct7", gather="fused", max_compact_voxels=65536, fused_window=512,
    )
    t0 = time.perf_counter()
    workload = build_workload(dev)
    torch.cuda.synchronize()
    log(f"[workload] map cloud {int(workload[0].mask.sum())} points (0.3 m leaf), "
        f"{N_FRAMES} scans: {time.perf_counter() - t0:.1f} s")

    parity = {s: kernel_parity(workload, cfg, s) for s in ("direct7", "radius27")}

    # main path: every launch from here on counts
    ndt_fused.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for s in ("direct7", "radius27"):
        scan_match_drive(workload, cfg, s)
    launches_drive = ndt_fused.launches
    front_end(dev)
    launches = ndt_fused.launches
    log(f"[launches] K1: {launches_drive} in the scan-match drives, "
        f"{launches - launches_drive} in the front end; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    check(launches_drive > 0, "K1 was not launched by the scan-match drive")
    check(launches - launches_drive > 0, "K1 was not launched by the front end")

    d7, r27 = parity["direct7"], parity["radius27"]
    log(json.dumps({"kernels": [{
        "name": "ndt_reduce_fused",
        "route": "cuda",
        "source": "lidar_slam_tpu_torch/csrc/ndt_fused.cu",
        "replaces": "lidar_slam_tpu/ops/pallas/ndt_fused.py:297",
        "launches": launches,
        "max_abs_err": max(d7[0], r27[0]),
        "ms": d7[1],
        "plain_ms": d7[2],
        "ms_radius27": r27[1],
        "plain_ms_radius27": r27[2],
    }]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
