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
  2. builds the kernels (csrc/*.cu: K1 ndt_fused, ndt_newton, K2, K3), one
     nvcc each, all at once, and logs their registers and spills;
  3. K1 against its plain PyTorch version on the card, direct7 and
     radius27, with bench.py's parity tolerances, and both device times;
  4. ndt_newton (the whole clamped-Newton alignment in one launch) against
     its plain version on a few alignments of the drive's frames: the
     kernel's score, gradient and Hessian at its final pose against the
     plain sums there, and the poses (check_poses), its device time per
     alignment and per iteration beside the host loop's;
  5. the 20-frame drive through the host loop (newton_align over K1, one
     launch per evaluation), and ndt_align (ndt_newton) on every frame from
     the host loop's guess: the poses (check_poses), one host sync per
     ndt_newton alignment; then the drive chained through ndt_align, both
     within the 0.10 m guard;
  6. the main path: the 20-frame chained scan-match drive (bench.py
     scan_match_leg), direct7 and radius27, then FrontEnd.update over 18
     frames and front_end_drive over 15 frames (bench.py front_end_leg):
     ndt_newton launched once per alignment there, K1 not at all;
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
 11. the kernels line: every kernel with its launches on its path, its
     device time beside its plain version's and its bound (the larger of
     the bytes it must move over 3.35 TB/s and its fp32 FLOPs over 67
     TFLOP/s, counted from this run's inputs).

Any failed check ends the run with a non-zero exit code. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""

import contextlib
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
POSE_TOL = 1e-4  # ndt_newton against the host loop and its plain version, m and rad (check_poses)
LONG_RUN = 10  # iterations: more is a start-up frame from the drive's 0.3 m-off first guess
GUARD = 0.10  # the scan-match pose-error guard (bench.py), m
# One H100 SXM (the data sheet): HBM bytes/s and fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# fp32 FLOPs the NDT reduction needs (an FMA counts 2): each valid point is transformed
# and its cell found once (the kernels redo that for each stencil offset, which the
# function does not need; the neighbour's index is integer work); a (point, voxel) pair
# on a valid voxel takes the Mahalanobis term (and the radius27 gate); an accepted pair
# adds the score, gradient and 21 Hessian terms
FLOPS_POINT, FLOPS_VALID, FLOPS_GATE, FLOPS_ACCEPTED = 24, 37, 5, 413
FLOPS_KNN_CANDIDATE = 8  # d2 = (dx*dx + dy*dy) + dz*dz: 3 sub, 3 mul, 2 add


def log(msg):
    print(msg, flush=True)


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


@contextlib.contextmanager
def counting_syncs():
    """Counts the host synchronisations torch makes inside the block (its
    sync debug mode's warnings); the count is in the yielded list after."""
    import torch

    count = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield count
        finally:
            torch.cuda.set_sync_debug_mode("default")
    count.append(sum("called a synchronizing CUDA operation" in str(w.message) for w in caught))


def bound(n_bytes, flops):
    """(bound ms, what sets it): the larger of bytes over the HBM rate and
    fp32 FLOPs over the fp32 peak."""
    b, f = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return (b, "bytes") if b >= f else (f, "operations")


def ndt_work(frame, ndt_map, poses, cfg):
    """Bytes and fp32 FLOPs the NDT reduction needs on these inputs at each
    pose of `poses` (host [6] arrays), summed: each source row read once
    (mask; xyz and weight of the valid ones), each index word and stats row
    (48 B read of 64) touched at any pose once, the pose and the result (at
    most 48 floats) once; FLOPs per pair as counted in FLOPS_*."""
    import torch

    from lidar_slam_tpu_torch.ops.cuda import ndt_fused, ndt_newton

    dev = frame.points.device
    stencil = cfg.stencil
    d2 = float(np.float32(cfg.gauss_params()[1]))
    valid = frame.mask & torch.all(torch.isfinite(frame.points), dim=-1)
    x = frame.points[valid]
    dims = torch.as_tensor(ndt_map.dims, device=dev)
    offsets = torch.as_tensor(ndt_fused.STENCIL_OFFSETS[stencil], device=dev)
    origin = ndt_map.origin.to(dev)
    flops, vids, rows = 0, [], []
    for pose in poses:
        R, t, _, _ = ndt_newton.pose_coefficients(torch.as_tensor(pose, device=dev))
        xp = x @ R.T + t
        cell = torch.floor((xp - origin) / ndt_map.resolution).to(torch.int64)
        cand = torch.minimum(torch.maximum(cell, torch.full_like(cell, -2)), dims + 1)[:, None] + offsets
        inb = torch.all((cand >= 0) & (cand < dims), dim=-1)
        vid = ((cand[..., 0] * ndt_map.dims[1] + cand[..., 1]) * ndt_map.dims[2] + cand[..., 2])[inb]
        row = ndt_map.index[vid].long()
        pk = ndt_map.packed[row]
        on_valid = pk[:, 10] > 0.5
        e = xp[:, None, :].expand(-1, offsets.shape[0], 3)[inb] - pk[:, 0:3]
        gate = on_valid
        if stencil == "radius27":
            gate = gate & (torch.sum(e * e, dim=-1) <= ndt_map.resolution**2)
        ix = pk[:, 4:10]
        q = torch.stack([ix[:, 0] * e[:, 0] + ix[:, 1] * e[:, 1] + ix[:, 2] * e[:, 2],
                         ix[:, 1] * e[:, 0] + ix[:, 3] * e[:, 1] + ix[:, 4] * e[:, 2],
                         ix[:, 2] * e[:, 0] + ix[:, 4] * e[:, 1] + ix[:, 5] * e[:, 2]], dim=-1)
        exd = d2 * torch.exp(-0.5 * d2 * torch.sum(q * e, dim=-1))
        accepted = gate & (exd <= 1.0) & (exd >= 0.0) & torch.isfinite(exd)
        n_valid_voxel = int(on_valid.sum())
        flops += (x.shape[0] * FLOPS_POINT + n_valid_voxel * FLOPS_VALID
                  + (n_valid_voxel * FLOPS_GATE if stencil == "radius27" else 0) + int(accepted.sum()) * FLOPS_ACCEPTED)
        vids.append(vid)
        rows.append(row)
    n_bytes = (frame.mask.numel() + int(valid.sum()) * 16 + torch.unique(torch.cat(vids)).numel() * 4
               + torch.unique(torch.cat(rows)).numel() * 48 + (6 + 48) * 4)
    return n_bytes, flops


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
    point (bench.py:164-191). Returns (max_abs_err, kernel ms, plain ms,
    bound ms, what sets the bound)."""
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
    n_bytes, flops = ndt_work(frame, ndt_map, [pose6], cfg)
    bound_ms, bound_by = bound(n_bytes, flops)
    log(f"[parity {stencil}] {int(msk.sum())} points x {len(ndt_map.keys)} table rows: "
        f"score {k[0]:.4f} (plain {p[0]:.4f}), |grad| {np.linalg.norm(k[1:7]):.4f}, "
        f"max |kernel - plain| {err:.3e}; K1 {ms:.4f} ms (one launch), plain {plain_ms:.4f} ms (device, median); "
        f"bound {bound_ms:.5f} ms ({n_bytes} B, {flops} FLOP: {bound_by})")
    return err, ms, plain_ms, bound_ms, bound_by


def newton_kw(ndt_map, cfg):
    d1, d2 = cfg.gauss_params()
    return dict(dims=ndt_map.dims, resolution=ndt_map.resolution, d1=float(np.float32(d1)), d2=float(np.float32(d2)),
                stencil=cfg.stencil, weight_derivatives=cfg.weight_derivatives, max_iter=cfg.max_iter,
                trans_eps=cfg.trans_eps, step_size=cfg.step_size, score_rel_tol=cfg.score_rel_tol)


def pose_gap(a, b):
    """(translation distance, rotation angle) between two [4, 4] poses; the
    angle from the skew part of R_a^T R_b (an arccos of its trace would
    turn float32 rounding of the entries into ~1e-4 rad)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    m = a[:3, :3].T @ b[:3, :3]
    axis = np.asarray([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]]) / 2.0
    return float(np.linalg.norm(a[:3, 3] - b[:3, 3])), float(np.arcsin(min(1.0, np.linalg.norm(axis))))


def check_poses(name, stencil, gaps, iters, ref_iters, trans_eps):
    """ndt_newton's poses against a reference's (the host loop or the plain
    version), frame by frame from the same guesses: `gaps` [F, 2] (m, rad),
    the iteration counts of both. direct7, and a radius27 frame the
    reference converges in at most LONG_RUN iterations: the same count and
    within POSE_TOL. A radius27 start-up frame that runs longer (from the
    0.3 m-off first guess): within trans_eps, where its stop falls is
    decided by float32 rounding (the plain version alone moves by
    millimetres when its sums are reordered: tests/test_torch_newton.py::
    test_plain_order_sensitivity). At most three such frames."""
    long = [i for i, n in enumerate(ref_iters) if n > LONG_RUN and stencil == "radius27"]
    for i, (gap, n, ref) in enumerate(zip(gaps, iters, ref_iters)):
        if i in long:
            check(max(gap) <= trans_eps, f"{name} frame {i}: {n} / {ref} iterations, poses {gap} apart")
        else:
            check(n == ref and max(gap) <= POSE_TOL, f"{name} frame {i}: {n} / {ref} iterations, poses {gap} apart")
    check(len(long) <= 3, f"{name}: {len(long)} frames run more than {LONG_RUN} iterations")


def check_sums_at(name, out, plain):
    """ndt_newton's score, gradient and Hessian (its result `out`) against
    the plain sums `plain` [32] at the kernel's final pose: the score and
    Hessian at K1's tolerances (TOL; the Hessian's atol widened to 1e-5 of
    its largest entry, as tests/test_torch_cuda.py does, for entries that
    cancel beside large ones), the gradient through the Newton step it
    makes, H^-1 (g - g_plain), within POSE_TOL. At an optimum the
    gradient's entries cancel to near zero and keep the sums' rounding
    (0.003-0.006 on entries of 0.2-1600 on the CPU test scene), beyond a
    fixed atol; what matters is the step. Returns the step's largest entry."""
    from lidar_slam_tpu_torch.ops.cuda import ndt_newton as N
    from lidar_slam_tpu_torch.ops.cuda.ndt_fused import unpack_results

    k = np.concatenate([out[N.SCORE:N.HESS.stop], [0.0]]).astype(np.float32)
    for part, sl in (("score", slice(0, 1)), ("hess", slice(7, 28))):
        tol = TOL[part]
        atol = max(tol["atol"], 1e-5 * float(np.abs(plain[sl]).max())) if part == "hess" else tol["atol"]
        bad = np.abs(k[sl] - plain[sl]) > atol + tol["rtol"] * np.abs(plain[sl])
        check(not bad.any(), f"{name} {part} at the final pose: kernel {k[sl]} vs plain {plain[sl]}")
    _, g, h, _ = unpack_results(plain)
    step = np.linalg.solve(h.astype(np.float64), (k[1:7] - g).astype(np.float64))
    check(np.abs(step).max() <= POSE_TOL, f"{name} gradient at the final pose: kernel {k[1:7]} vs plain {g}")
    return float(np.abs(step).max())


def host_ms(fn, reps=5):
    """Median host wall time of fn() in ms, synchronised on both ends."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def newton_parity(workload, cfg, stencil):
    """Phase 4 for one stencil: ndt_newton against ndt_newton_plain on the
    card, on the drive's first three alignments (each from the motion-model
    prediction of the kernel's previous poses): its sums at its final pose
    (check_sums_at) and the poses (check_poses). Times frame 0's alignment:
    the kernel and its plain version (device, CUDA events), and ndt_align
    against the host loop (host wall clock, both ending in their copy to
    the host); the bound counts the plain run's evaluations. Returns the
    kernels-line fields."""
    import torch

    from lidar_slam_tpu_torch.models.registration import build_ndt_map, ndt_align
    from lidar_slam_tpu_torch.models.registration.ndt import _matrix_to_pose, _pose_to_matrix, ndt_align_host_loop
    from lidar_slam_tpu_torch.ops.cuda import ndt_newton as N
    from lidar_slam_tpu_torch.ops.cuda.ndt_fused import ndt_reduce_plain
    from lidar_slam_tpu_torch.pipeline.front_end import _preprocess

    map_cloud, all_pts, all_msk, gt, guess0 = workload
    cfg = dataclasses.replace(cfg, stencil=stencil)
    ndt_map = build_ndt_map(map_cloud, cfg)
    kw = newton_kw(ndt_map, cfg)
    res = {"max_abs_err": 0.0}
    gaps, iters, plain_iters = [], [], []
    last = predict = torch.as_tensor(guess0)
    for i in range(3):
        frame = _preprocess(all_pts[i], all_msk[i], FRAME_CAP, 0.5)
        args = (frame.points, frame.mask, frame.get_weights(), ndt_map.index, ndt_map.packed, ndt_map.origin,
                torch.as_tensor(_matrix_to_pose(predict), device=frame.points.device))
        trace = []
        k = N.ndt_newton(*args, **kw).cpu().numpy()
        p = N.ndt_newton_plain(*args, **kw, trace=trace).cpu().numpy()
        R, t, jang, hang = N.pose_coefficients(torch.as_tensor(k[N.POSE], device=frame.points.device))
        at_k = ndt_reduce_plain(*args[:6], R, t, jang, hang, dims=kw["dims"], resolution=kw["resolution"],
                                d1=kw["d1"], d2=kw["d2"], stencil=stencil,
                                weight_derivatives=kw["weight_derivatives"]).cpu().numpy()
        step = check_sums_at(f"newton {stencil} frame {i}", k, at_k)
        pose = _pose_to_matrix(k[N.POSE])
        gap = pose_gap(pose, _pose_to_matrix(p[N.POSE]))
        err_k, err_p = (pose_gap(_pose_to_matrix(o[N.POSE]), gt[i])[0] for o in (k, p))
        res["max_abs_err"] = max(res["max_abs_err"], float(np.abs(k[N.POSE] - p[N.POSE]).max()))
        log(f"[newton {stencil}] frame {i}: kernel {int(k[N.ITERATIONS])} iterations (converged "
            f"{bool(k[N.CONVERGED])}), plain {int(p[N.ITERATIONS])} ({bool(p[N.CONVERGED])}); kernel - plain "
            f"{gap[0]:.2e} m, {gap[1]:.2e} rad; error to ground truth {err_k:.4f} / {err_p:.4f} m; at the "
            f"kernel's pose: score {k[N.SCORE]:.4f} (plain {at_k[0]:.4f}), max |Hessian - plain| "
            f"{np.abs(k[N.HESS] - at_k[7:28]).max():.3e}, gradient difference's step {step:.2e}")
        check(k[N.N_VALID] == p[N.N_VALID] == int(frame.mask.sum()), f"newton {stencil}: valid-point counts differ")
        check(np.allclose(k[N.ROTATION], pose[:3, :3].numpy().reshape(9), rtol=0, atol=1e-6),
              f"newton {stencil}: the kernel's rotation is not its pose's")
        check(max(err_k, err_p) <= GUARD, f"newton {stencil} frame {i}: outside the {GUARD} m guard")
        gaps.append(gap)
        iters.append(int(k[N.ITERATIONS]))
        plain_iters.append(int(p[N.ITERATIONS]))
        if i == 0:
            res["iterations"] = int(k[N.ITERATIONS])
            res["ms"] = device_ms(lambda: N.ndt_newton(*args, **kw), reps=20)
            res["ms_per_iteration"] = res["ms"] / max(res["iterations"], 1)
            res["plain_ms"] = device_ms(lambda: N.ndt_newton_plain(*args, **kw), reps=3)
            res["align_ms"] = host_ms(lambda: ndt_align(ndt_map, frame, predict, cfg), reps=20)
            res["host_loop_ms"] = host_ms(lambda: ndt_align_host_loop(ndt_map, frame, predict, cfg), reps=20)
            n_bytes, flops = ndt_work(frame, ndt_map, trace, cfg)
            res["bound_ms"], res["bound_by"] = bound(n_bytes, flops)
            log(f"[newton {stencil}] frame 0: ndt_newton {res['ms']:.4f} ms an alignment, "
                f"{res['ms_per_iteration']:.4f} an iteration (device, median); plain {res['plain_ms']:.2f} ms; "
                f"ndt_align {res['align_ms']:.3f} ms vs host loop {res['host_loop_ms']:.3f} ms (wall, median); "
                f"bound {res['bound_ms']:.5f} ms ({n_bytes} B, {flops} FLOP in {len(trace)} evaluations: "
                f"{res['bound_by']})")
        step = torch.linalg.solve(last, pose)
        last, predict = pose, pose @ step
    check_poses(f"newton {stencil}", stencil, gaps, iters, plain_iters, cfg.trans_eps)
    return res


def drive_parity(workload, cfg, stencil):
    """Phase 5 for one stencil: the 20-frame chained drive on preprocessed
    frames through the host loop (ndt_align_host_loop: K1 and a copy per
    evaluation), and ndt_align (ndt_newton: one launch and one host sync an
    alignment, both counted) on every frame from the same guess as the host
    loop's: the poses (check_poses, the per-frame gap logged). Then the
    drive chained through
    ndt_align on its own predictions: both drives within the 0.10 m guard,
    their per-frame gap logged (each frame stops once a step is under
    trans_eps, 1 cm, so a chained drive carries a rounding difference from
    frame to frame). Returns the host-loop drive's K1 launches."""
    import torch

    from lidar_slam_tpu_torch.models.registration import build_ndt_map, ndt_align
    from lidar_slam_tpu_torch.models.registration.ndt import ndt_align_host_loop
    from lidar_slam_tpu_torch.ops.cuda import ndt_fused, ndt_newton
    from lidar_slam_tpu_torch.pipeline.front_end import _preprocess

    map_cloud, all_pts, all_msk, gt, guess0 = workload
    cfg = dataclasses.replace(cfg, stencil=stencil)
    ndt_map = build_ndt_map(map_cloud, cfg)
    frames = [_preprocess(all_pts[i], all_msk[i], FRAME_CAP, 0.5) for i in range(N_FRAMES)]

    def drive(align, guesses=None):
        last = predict = torch.as_tensor(guess0)
        poses, iters, starts = [], [], []
        for i, f in enumerate(frames):
            start = predict if guesses is None else guesses[i]
            r = align(ndt_map, f, start, cfg)
            step = torch.linalg.solve(last, r.pose)
            last, predict = r.pose, r.pose @ step
            poses.append(r.pose.numpy())
            iters.append(r.iterations)
            starts.append(start)
        return np.stack(poses), iters, starts

    drive(ndt_align)  # warm-up
    reset_launches()
    t0 = time.perf_counter()
    h_poses, h_iters, guesses = drive(ndt_align_host_loop)
    dt_h = (time.perf_counter() - t0) * 1e3 / N_FRAMES
    n_k1 = ndt_fused.launches
    check(ndt_newton.launches == 0 and n_k1 >= sum(h_iters), f"host-loop drive {stencil}: {n_k1} K1 launches")
    reset_launches()
    with counting_syncs() as syncs:
        t0 = time.perf_counter()
        k_poses, k_iters, _ = drive(ndt_align, guesses)
        dt_k = (time.perf_counter() - t0) * 1e3 / N_FRAMES
    check(ndt_newton.launches == N_FRAMES and ndt_fused.launches == 0,
          f"drive {stencil}: {ndt_newton.launches} ndt_newton and {ndt_fused.launches} K1 launches in "
          f"{N_FRAMES} alignments, expected {N_FRAMES} and 0")
    check(syncs[0] == N_FRAMES, f"drive {stencil}: {syncs[0]} host syncs in {N_FRAMES} alignments, expected one each")
    gaps = np.asarray([pose_gap(a, b) for a, b in zip(k_poses, h_poses)])
    log(f"[drive {stencil}] from the host loop's guesses: ndt_align {dt_k:.3f} ms an alignment (wall, sync "
        f"counting on), {syncs[0]} host syncs and {N_FRAMES} ndt_newton launches in {N_FRAMES} alignments; host "
        f"loop {dt_h:.3f} ms, {n_k1} K1 launches; iterations kernel {k_iters}, host loop {h_iters}; |kernel - host "
        f"loop| max {gaps[:, 0].max():.2e} m, {gaps[:, 1].max():.2e} rad")
    log(f"[drive {stencil}] per-frame |kernel - host loop| m {np.array2string(gaps[:, 0], precision=6)}")
    check_poses(f"drive {stencil}", stencil, gaps, k_iters, h_iters, cfg.trans_eps)

    c_poses, c_iters, _ = drive(ndt_align)
    chained = np.asarray([pose_gap(a, b) for a, b in zip(c_poses, h_poses)])
    err_c = np.linalg.norm(c_poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    err_h = np.linalg.norm(h_poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    log(f"[drive {stencil}] chained on its own predictions: iterations {c_iters}; per-frame |kernel - host loop| "
        f"m {np.array2string(chained[:, 0], precision=6)}; error mean {err_c.mean():.4f} / {err_h.mean():.4f} m")
    check(max(err_c.mean(), err_h.mean()) <= GUARD, f"drive {stencil}: outside the {GUARD} m guard")
    return n_k1


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
    """Phase 6, second part (bench.py:315-402): FrontEnd.update and
    front_end_drive. Returns the number of alignments they ran: two (coarse
    and fine) a frame, except on a first frame, which has no map yet."""
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
    # 18 updates, a 3-frame warm-up drive and two 15-frame drives, each from an empty map
    return 2 * ((len(scans) - 1) + (3 - 1) + 2 * (len(pts_seq) - 1))


def build_kernels():
    """Phase 2: one nvcc per kernel source, all started together."""
    from lidar_slam_tpu_torch.ops.cuda import build

    stems = ("ndt_fused", "ndt_newton", "knn_fused", "ndt_gather")
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


def knn_work(grid, q, qm, k, n_extra):
    """Bytes and fp32 FLOPs of one k-NN search on these inputs: the queries
    read once, the cell ranges and table rows (xyz, valid, index, extras)
    of the stencil cells the valid queries touch read once, the outputs
    (idx, dist, ok, pts, extras) written once; a distance per candidate."""
    import torch

    from lidar_slam_tpu_torch.ops.hashgrid import _flat_cell_id, clip_to_grid, in_bounds, stencil_offsets

    ok = qm & torch.all(torch.isfinite(q), dim=-1)
    cell = clip_to_grid(torch.floor((q[ok] - grid.origin) / grid.cell_size), grid.dims).to(torch.int32)
    cand = cell[:, None, :] + stencil_offsets(q.device)[None]
    cells = _flat_cell_id(cand, grid.dims)[in_bounds(cand, grid.dims)].long()
    uniq = torch.unique(cells)
    nq = q.shape[0]
    n_bytes = (nq * 13 + uniq.numel() * 8 + int(grid.cell_counts[uniq].sum()) * (17 + 4 * n_extra)
               + nq * k * (21 + 4 * n_extra))
    return n_bytes, int(grid.cell_counts[cells].sum()) * FLOPS_KNN_CANDIDATE


def knn_parity(dev, traj, frames):
    """Phase 7: K2 vs knn_exact_plain on the operating point's inputs, at
    the state after two sweeps: the odometry's searches (sweep 2's flat and
    sharp features at the warm-start pose, against sweep 1's less-flat and
    less-sharp clouds, ring extras) and the mapping's (sweep 2's surf and
    corner stacks at the predicted map pose, against the maps). Queries are
    sorted by cell, as the path sorts them. Returns {case: (K2 ms, plain
    ms, max |K2 - plain|, bound ms, what sets it)}."""
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
        n_bytes, flops = knn_work(grid, q, qm, k, 0 if extras is None else 1)
        bound_ms, bound_by = bound(n_bytes, flops)
        log(f"[parity K2 {name}] {int(qm.sum())} queries x {int(grid.valid.sum())} table rows "
            f"(largest cell {int(grid.cell_counts.max())}), k={k}, r={radius}: {int(plain['ok'].sum())} "
            f"neighbours, equal to the plain version; K2 {ms:.4f} ms (kernel alone {alone:.4f}, the rest "
            f"the feature table and unpacking), plain {plain_ms:.4f} ms (device, median); bound "
            f"{bound_ms:.5f} ms ({n_bytes} B, {flops} FLOP: {bound_by})")
        out[name] = (ms, plain_ms, err, bound_ms, bound_by)
    return out


def gather_parity(workload, cfg):
    """Phase 8: K3 vs its plain version on phase 3's NDT map and the voxel
    ids of one preprocessed frame at the first guess. Returns {stencil: (K3
    ms, plain ms, max |K3 - plain|, bound ms, what sets it)}."""
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
        # keys read once (the sort needs all), the hit rows once, ids in, rows out
        n_bytes = (ndt_map.keys.numel() * 4 + int(torch.isin(ndt_map.keys, vids[vids >= 0]).sum()) * 64
                   + vids.numel() * (4 + 64))
        bound_ms, bound_by = bound(n_bytes, 0)
        log(f"[parity K3 {stencil}] {vids.numel()} ids ({hits} on valid voxels) x {len(ndt_map.keys)} keys: "
            f"equal to the plain version; K3 {ms:.4f} ms (kernel alone {alone:.4f}, the rest the key sort), "
            f"plain {plain_ms:.4f} ms (device, median); bound {bound_ms:.5f} ms ({n_bytes} B: {bound_by})")
        out[stencil] = (ms, plain_ms, err, bound_ms, bound_by)
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
    with counting_syncs() as syncs:
        t0 = time.perf_counter()
        poses = pipe.update_batch(batch)
        dt = time.perf_counter() - t0
    n_sync = syncs[0]
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
    from lidar_slam_tpu_torch.ops.cuda import knn_fused, ndt_fused, ndt_gather, ndt_newton

    for m in (ndt_fused, ndt_newton, knn_fused, ndt_gather):
        m.launches = 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs only on a GPU", file=sys.stderr)
        return 2
    import lidar_slam_tpu_torch
    from lidar_slam_tpu_torch.models.registration import NDTConfig
    from lidar_slam_tpu_torch.ops.cuda import knn_fused, ndt_fused, ndt_gather, ndt_newton

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

    stencils = ("direct7", "radius27")
    parity = {s: kernel_parity(workload, cfg, s) for s in stencils}
    newton = {s: newton_parity(workload, cfg, s) for s in stencils}
    # the host-loop drives are K1's path: their counts are read inside
    launches_k1 = sum(drive_parity(workload, cfg, s) for s in stencils)
    log(f"[launches] K1: {launches_k1} in the host-loop drives")
    check(launches_k1 > 0, "K1 was not launched by the host-loop drive")
    t0 = time.perf_counter()
    traj, frames = aloam_workload()
    log(f"[workload] A-LOAM: {len(frames)} sweeps simulated in {time.perf_counter() - t0:.1f} s")
    knn = knn_parity(dev, traj, frames)
    gather = gather_parity(workload, cfg)

    # the main paths: each path's counts are set to 0 just before it and
    # read just after
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for s in stencils:
        scan_match_drive(workload, cfg, s)
    launches_drive, k1_drive = ndt_newton.launches, ndt_fused.launches
    n_drive = len(stencils) * 2 * N_FRAMES  # a warm-up and a timed run of the drive per stencil
    reset_launches()
    n_front = front_end(dev)
    launches_front, k1_front = ndt_newton.launches, ndt_fused.launches
    log(f"[launches] ndt_newton: {launches_drive} in {n_drive} alignments of the scan-match drives, "
        f"{launches_front} in {n_front} alignments of the front end; K1: {k1_drive} and {k1_front}")
    check(launches_drive == n_drive and k1_drive == 0, "the scan-match drive: not one ndt_newton launch an alignment")
    check(launches_front == n_front and k1_front == 0, "the front end: not one ndt_newton launch an alignment")

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
    n7, n27 = newton["direct7"], newton["radius27"]
    log(json.dumps({"kernels": [
        {
            "name": "ndt_newton",
            "route": "cuda",
            "source": "lidar_slam_tpu_torch/csrc/ndt_newton.cu",
            "replaces": "lidar_slam_tpu/ops/pallas/ndt_fused.py:297",
            "replaces_loop": "lidar_slam_tpu/models/registration/ndt.py:1407",
            "launches": launches_drive + launches_front,
            "max_abs_err": max(n7["max_abs_err"], n27["max_abs_err"]),
            "ms": n7["ms"],
            "plain_ms": n7["plain_ms"],
            "bound_ms": n7["bound_ms"],
            "bound_by": n7["bound_by"],
            "library_ms": None,
            "iterations": n7["iterations"],
            "ms_per_iteration": n7["ms_per_iteration"],
            "align_ms": n7["align_ms"],
            "host_loop_ms": n7["host_loop_ms"],
            "ms_radius27": n27["ms"],
            "plain_ms_radius27": n27["plain_ms"],
            "bound_ms_radius27": n27["bound_ms"],
            "iterations_radius27": n27["iterations"],
            "align_ms_radius27": n27["align_ms"],
            "host_loop_ms_radius27": n27["host_loop_ms"],
        },
        {
            "name": "ndt_reduce_fused",
            "route": "cuda",
            "source": "lidar_slam_tpu_torch/csrc/ndt_fused.cu",
            "replaces": "lidar_slam_tpu/ops/pallas/ndt_fused.py:297",
            "launches": launches_k1,
            "max_abs_err": max(d7[0], r27[0]),
            "ms": d7[1],
            "plain_ms": d7[2],
            "bound_ms": d7[3],
            "bound_by": d7[4],
            "library_ms": None,
            "ms_radius27": r27[1],
            "plain_ms_radius27": r27[2],
            "bound_ms_radius27": r27[3],
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
            "bound_ms": knn["odometry"][3],
            "bound_by": knn["odometry"][4],
            "library_ms": None,
            **{f"{key}_{case.replace(' ', '_')}": knn[case][i]
               for case in ("mapping", "odometry corner", "mapping corner")
               for i, key in ((0, "ms"), (1, "plain_ms"), (3, "bound_ms"))},
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
            "bound_ms": gather["direct7"][3],
            "bound_by": gather["direct7"][4],
            "library_ms": None,
            "ms_radius27": gather["radius27"][0],
            "plain_ms_radius27": gather["radius27"][1],
            "bound_ms_radius27": gather["radius27"][3],
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
