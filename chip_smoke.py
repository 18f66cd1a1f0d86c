#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (lidar_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's two paths on the card. NDT scan-to-map tracking runs at
the KITTI HDL-64 operating point of bench.py (raw scans padded to 131 072
points, frames of <= 32 768 points, 1 m NDT voxels on a 256 x 256 x 64
grid, 65 536 compact voxels, a 20-keyframe local map); the A-LOAM front end
at the CLI's KITTI HDL-64 configuration (cli.py: 131 072-point sweeps, a
65 536-point corner map and a 131 072-point surf map on a 192 x 192 x 32
grid) on bench.py's aloam_leg world and trajectory:

  1. device and power limit (exits non-zero without CUDA: never runs on
     the CPU);
  2. builds kernels K1, K2 and K3 (csrc/*.cu), one nvcc each, all at once,
     and logs their registers and spills;
  3. K1 against its plain PyTorch version on the card, direct7 and
     radius27, with bench.py's parity tolerances, and both device times;
  4. 20-frame chained scan-match drive (bench.py scan_match_leg);
  5. FrontEnd.update over 18 frames, then front_end_drive over 15 frames
     (bench.py front_end_leg);
  6. checks that K1 was launched in phases 4 and 5;
  7. K2 against its plain version on the A-LOAM operating point's own
     inputs (odometry: surf features, k = 8, ring extras; mapping: surf
     map, k = 5), exact, with both device times;
  8. K3 against its plain version on phase 3's NDT map and one frame's
     voxel ids (direct7, radius27), exact, with both device times;
  9. the scan-match drive with gather="onehot" (K3 on the path): the
     0.10 m guard, and the same poses as the gather="two_level" drive;
 10. the A-LOAM drive (AloamPipeline.update x 2, then update_batch x 10,
     twice from the same primed state): ms/sweep, pose error (guard
     0.3 m mean), both runs equal, one host sync per batch;
 11. the kernels line: all three kernels, with their launches on the path.

Any failed check ends the run with a non-zero exit code. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""

import dataclasses
import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

RAW_CAP = 131072
FRAME_CAP = 32768
N_FRAMES = 20
ALOAM_SWEEPS = 12
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


def kernel_only_ms(fn, name, reps=10):
    """Mean device time in ms of the kernels whose name contains `name`,
    per call of fn(), from torch.profiler (the wrapper's other device work
    left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages() if name in e.key)
    return total / reps / 1e3


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
    motion-model prediction, pose-error guard <= 0.10 m mean. Returns the
    poses."""
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
    name = stencil if cfg.gather == "fused" else f"{stencil}, gather={cfg.gather}"
    log(f"[scan-match {name}] {dt / N_FRAMES * 1e3:.2f} ms/frame ({N_FRAMES / dt:.1f} fps), "
        f"iterations mean {np.mean(iters):.2f} max {max(iters)}, "
        f"pose error mean {errs.mean():.4f} max {errs.max():.4f} m")
    check(errs.mean() <= 0.10, f"scan-match {name}: pose error guard ({errs.mean():.4f} m)")
    # every sum on the path is taken in a fixed order: a rerun is bit-identical
    check(np.array_equal(warm, poses), f"scan-match {name}: two runs of the drive differ")
    return poses


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


def build_kernels():
    """Phase 2: one nvcc per kernel source, all started together."""
    from lidar_slam_tpu_torch.ops.cuda import build

    stems = ("ndt_fused", "knn_fused", "ndt_gather")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(stems)) as pool:
        infos = dict(zip(stems, pool.map(build.build, stems)))
    log(f"[build] {len(stems)} kernels in {time.perf_counter() - t0:.1f} s (parallel)")
    for stem, info in infos.items():
        log(f"[build] {stem}: nvcc {info.seconds:.1f} s -> {info.path}")
        for ln in info.log.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"[build]   {ln.strip()}")


def aloam_configs():
    """cli.py:244-257 (--front-end aloam, KITTI HDL-64): the feature
    extraction of the CLI, default odometry and mapping."""
    from lidar_slam_tpu_torch.pipeline.aloam import AloamMappingConfig, AloamOdometryConfig, FeatureExtractionConfig

    fe = FeatureExtractionConfig(
        n_scans=64, min_range=2.5, capacity=131072,
        max_sharp=1024, max_less_sharp=8192, max_flat=2048, max_less_flat=16384,
    )
    return fe, AloamOdometryConfig(), AloamMappingConfig()


def aloam_workload():
    """bench.py:437-473 (aloam_leg): corridor 60 x 18 m, density 30, seed 2;
    12 sweeps at 0.8 m/frame, each a 64-ring x 2048-azimuth sweep (131 072
    rows, the padded capacity)."""
    from lidar_slam_tpu_torch.io import SyntheticWorld, make_trajectory, simulate_spinning_scan

    world = SyntheticWorld.corridor(length=60.0, width=18.0, density=30.0, seed=2)
    traj = make_trajectory(ALOAM_SWEEPS, speed=0.8)
    frames = [
        simulate_spinning_scan(world, traj[i], t=i * 0.1, n_scans=64, n_azimuth=2048, seed=i)
        for i in range(ALOAM_SWEEPS)
    ]
    return traj, frames


def primed_pipeline(dev, traj, frames):
    from lidar_slam_tpu_torch.pipeline.aloam import AloamPipeline

    pipe = AloamPipeline(*aloam_configs(), device=dev)
    pipe.set_init_pose(traj[0])
    for i in range(2):
        pipe.update(*frames[i])
    return pipe


def knn_parity(dev, traj, frames):
    """Phase 7: K2 vs knn_exact_plain on the operating point's inputs, at
    the state after two sweeps: the odometry's searches (sweep 2's flat and
    sharp features at the warm-start pose, against sweep 1's less-flat and
    less-sharp clouds, ring extras) and the mapping's (sweep 2's surf and
    corner stacks at the predicted map pose, against the maps). Queries are
    sorted by cell, as the path sorts them. Returns {case: (K2 ms, plain
    ms, max |K2 - plain|)}."""
    import torch

    from lidar_slam_tpu_torch.geom import transform_points
    from lidar_slam_tpu_torch.ops.cuda import knn_fused
    from lidar_slam_tpu_torch.ops.hashgrid import build_bucket_grid
    from lidar_slam_tpu_torch.pipeline.aloam import downsample_stacks, extract_features
    from lidar_slam_tpu_torch.pipeline.aloam.odometry import sort_by_cell

    fe, odo, mapping = aloam_configs()
    pipe = primed_pipeline(dev, traj, frames)
    st = pipe.state
    pts, msk = pipe.preload(*frames[2])
    f = extract_features(pts, msk, fe)
    stack_corner, stack_surf = downsample_stacks(f.less_sharp, f.less_flat, mapping)
    guess = st.T_map_odom @ st.T_world @ st.T_rel
    r_odo = float(np.sqrt(odo.dist_sq_threshold))

    def odo_case(target, ring, queries):
        return build_bucket_grid(target, odo.grid_cell, odo.grid_dims), queries, st.T_rel, odo.knn_k, r_odo, ring

    def map_case(target, queries):
        return (build_bucket_grid(target, mapping.grid_cell, mapping.grid_dims), queries, guess, mapping.knn_k,
                mapping.nn_radius, None)

    cases = {
        "odometry": odo_case(st.prev_less_flat, st.prev_less_flat_ring, f.flat),
        "mapping": map_case(st.surf_map, stack_surf),
        "odometry corner": odo_case(st.prev_less_sharp, st.prev_less_sharp_ring, f.sharp),
        "mapping corner": map_case(st.corner_map, stack_corner),
    }
    out = {}
    for name, (grid, cloud, T, k, radius, extras) in cases.items():
        q = transform_points(T, cloud.points)
        order = sort_by_cell(grid, q, cloud.mask)
        q, qm = q[order].contiguous(), cloud.mask[order].contiguous()
        plain = knn_fused.knn_exact_plain(grid, q, qm, k, radius, extras)
        plain_ms = device_ms(lambda: knn_fused.knn_exact_plain(grid, q, qm, k, radius, extras), reps=5)
        r = knn_fused.window_knn(grid, q, qm, k, radius, extras)
        torch.cuda.synchronize()
        err = 0.0
        for key in plain:
            check(torch.equal(r[key], plain[key]), f"K2 {name}: {key} differs from the plain version")
            if key != "ok" and r[key].numel():
                a, b = r[key].double(), plain[key].double()
                both = torch.isfinite(a) & torch.isfinite(b)
                err = max(err, float(torch.where(both, (a - b).abs(), 0.0).max()))
        ms = device_ms(lambda: knn_fused.window_knn(grid, q, qm, k, radius, extras))
        alone = kernel_only_ms(lambda: knn_fused.window_knn(grid, q, qm, k, radius, extras), "knn_kernel")
        log(f"[parity K2 {name}] {int(qm.sum())} queries x {int(grid.valid.sum())} table rows "
            f"(largest cell {int(grid.cell_counts.max())}), k={k}, r={radius}: {int(plain['ok'].sum())} "
            f"neighbours, equal to the plain version; K2 {ms:.4f} ms (kernel alone {alone:.4f}, the rest "
            f"the feature table and unpacking), plain {plain_ms:.4f} ms (device, median)")
        out[name] = (ms, plain_ms, err)
    return out


def gather_parity(workload, cfg):
    """Phase 8: K3 vs its plain version on phase 3's NDT map and the voxel
    ids of one preprocessed frame at the first guess."""
    import torch

    from lidar_slam_tpu_torch.models.registration import build_ndt_map
    from lidar_slam_tpu_torch.ops.cuda import ndt_fused, ndt_gather
    from lidar_slam_tpu_torch.pipeline.front_end import _preprocess

    map_cloud, all_pts, all_msk, _, guess0 = workload
    ndt_map = build_ndt_map(map_cloud, cfg)
    frame = _preprocess(all_pts[0], all_msk[0], FRAME_CAP, 0.5)
    dev = frame.points.device
    xp = frame.points @ torch.as_tensor(guess0[:3, :3], device=dev).T + torch.as_tensor(guess0[:3, 3], device=dev)
    cell = torch.floor((xp - ndt_map.origin.to(dev)) / ndt_map.resolution).to(torch.int32)
    dims_t = torch.as_tensor(ndt_map.dims, dtype=torch.int32, device=dev)
    out = {}
    for stencil in ("direct7", "radius27"):
        cand = cell[:, None, :] + torch.as_tensor(ndt_fused.STENCIL_OFFSETS[stencil], device=dev)[None]
        inb = torch.all((cand >= 0) & (cand < dims_t), dim=-1)
        vid = (cand[..., 0] * ndt_map.dims[1] + cand[..., 1]) * ndt_map.dims[2] + cand[..., 2]
        vids = torch.where(inb, vid, -2).contiguous()
        k = ndt_gather.gather_stats_onehot(ndt_map.keys, ndt_map.packed, vids)
        p = ndt_gather.gather_stats_plain(ndt_map.keys, ndt_map.packed, vids)
        check(torch.equal(k, p), f"K3 {stencil}: rows differ from the plain version")
        err = float((k - p).abs().max())
        hits = int((k[..., 10] > 0.5).sum())
        ms = device_ms(lambda: ndt_gather.gather_stats_onehot(ndt_map.keys, ndt_map.packed, vids))
        alone = kernel_only_ms(lambda: ndt_gather.gather_stats_onehot(ndt_map.keys, ndt_map.packed, vids),
                               "gather_kernel")
        plain_ms = device_ms(lambda: ndt_gather.gather_stats_plain(ndt_map.keys, ndt_map.packed, vids), reps=3)
        log(f"[parity K3 {stencil}] {vids.numel()} ids ({hits} on valid voxels) x {len(ndt_map.keys)} keys: "
            f"equal to the plain version; K3 {ms:.4f} ms (kernel alone {alone:.4f}, the rest the key sort), "
            f"plain {plain_ms:.4f} ms (device, median)")
        out[stencil] = (ms, plain_ms, err)
    return out


def onehot_drive(workload, cfg):
    """Phase 9: the direct7 scan-match drive with gather="onehot" (K3 for
    the stats fetch, the plain derivative math around it). It fetches the
    same rows as gather="two_level", so the poses are the same."""
    onehot = scan_match_drive(workload, dataclasses.replace(cfg, gather="onehot"), "direct7")
    two_level = scan_match_drive(workload, dataclasses.replace(cfg, gather="two_level"), "direct7")
    check(np.array_equal(onehot, two_level), "onehot drive: poses differ from the two_level drive")
    log("[scan-match onehot] poses equal to the gather=two_level drive's")


def aloam_drive(dev, traj, frames):
    """Phase 10 (bench.py:437-473): two sweeps prime the state through
    update(), then sweeps 2-11 go through update_batch twice from that
    state: a warm-up, then the timed run. Checks the 0.3 m mean-error guard,
    that both runs give the same poses, and that the timed batch
    synchronises with the host once (its final pose copy)."""
    import torch

    pipe = primed_pipeline(dev, traj, frames)
    primed = pipe.state
    batch = frames[2:]
    warm = pipe.update_batch(batch)
    pipe.state = primed
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            poses = pipe.update_batch(batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        dt = time.perf_counter() - t0
    n_sync = sum("called a synchronizing CUDA operation" in str(w.message) for w in syncs)
    n = len(batch)
    errs = np.linalg.norm(poses[:, :3, 3] - traj[2:, :3, 3], axis=1)
    log(f"[aloam] update_batch of {n} sweeps: {dt / n * 1e3:.2f} ms/sweep ({n / dt:.1f} fps), "
        f"{n_sync} host sync(s); pose error mean {errs.mean():.4f} max {errs.max():.4f} m; "
        f"{int(sum(m.sum() for _, m in frames))} returns in {len(frames)} sweeps of {len(frames[0][1])} rows")
    check(errs.mean() < 0.3, f"A-LOAM error guard ({errs.mean():.4f} m)")
    check(np.array_equal(warm, poses), "A-LOAM: two chained runs from the same primed state differ")
    check(n_sync == 1, f"A-LOAM: update_batch synchronised {n_sync} times, expected once")
    return dt / n * 1e3


def reset_launches():
    from lidar_slam_tpu_torch.ops.cuda import knn_fused, ndt_fused, ndt_gather

    for m in (ndt_fused, knn_fused, ndt_gather):
        m.launches = 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs only on a GPU", file=sys.stderr)
        return 2
    import lidar_slam_tpu_torch
    from lidar_slam_tpu_torch.models.registration import NDTConfig
    from lidar_slam_tpu_torch.ops.cuda import knn_fused, ndt_fused, ndt_gather

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

    build_kernels()

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
    t0 = time.perf_counter()
    traj, frames = aloam_workload()
    log(f"[workload] A-LOAM: {len(frames)} sweeps simulated in {time.perf_counter() - t0:.1f} s")
    knn = knn_parity(dev, traj, frames)
    gather = gather_parity(workload, cfg)

    # the main paths: every launch from here on counts; each path's counts
    # are set to 0 just before it and read just after
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for s in ("direct7", "radius27"):
        scan_match_drive(workload, cfg, s)
    launches_drive = ndt_fused.launches
    front_end(dev)
    launches = ndt_fused.launches
    log(f"[launches] K1: {launches_drive} in the scan-match drives, "
        f"{launches - launches_drive} in the front end")
    check(launches_drive > 0, "K1 was not launched by the scan-match drive")
    check(launches - launches_drive > 0, "K1 was not launched by the front end")

    reset_launches()
    onehot_drive(workload, cfg)
    launches_k3 = ndt_gather.launches
    log(f"[launches] K3: {launches_k3} in the onehot scan-match drive")
    check(launches_k3 > 0, "K3 was not launched by the onehot drive")

    reset_launches()
    aloam_drive(dev, traj, frames)
    launches_k2 = knn_fused.launches
    log(f"[launches] K2: {launches_k2} in the A-LOAM drive ({2 + 2 * (len(frames) - 2)} sweeps); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    check(launches_k2 > 0, "K2 was not launched by the A-LOAM drive")

    d7, r27 = parity["direct7"], parity["radius27"]
    log(json.dumps({"kernels": [
        {
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
        },
        {
            "name": "window_knn",
            "route": "cuda",
            "source": "lidar_slam_tpu_torch/csrc/knn_fused.cu",
            "replaces": "lidar_slam_tpu/ops/pallas/knn_fused.py:117",
            "launches": launches_k2,
            "max_abs_err": max(v[2] for v in knn.values()),
            "ms": knn["odometry"][0],
            "plain_ms": knn["odometry"][1],
            "ms_mapping": knn["mapping"][0],
            "plain_ms_mapping": knn["mapping"][1],
            "ms_odometry_corner": knn["odometry corner"][0],
            "plain_ms_odometry_corner": knn["odometry corner"][1],
            "ms_mapping_corner": knn["mapping corner"][0],
            "plain_ms_mapping_corner": knn["mapping corner"][1],
        },
        {
            "name": "gather_stats_onehot",
            "route": "cuda",
            "source": "lidar_slam_tpu_torch/csrc/ndt_gather.cu",
            "replaces": "lidar_slam_tpu/ops/pallas/ndt_reduce.py:49",
            "launches": launches_k3,
            "max_abs_err": max(v[2] for v in gather.values()),
            "ms": gather["direct7"][0],
            "plain_ms": gather["direct7"][1],
            "ms_radius27": gather["radius27"][0],
            "plain_ms_radius27": gather["radius27"][1],
        },
    ]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
