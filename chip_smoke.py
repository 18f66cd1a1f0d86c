#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (lidar_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's paths on the card: tracking, A-LOAM, the mapping back
half (loop closure, pose-graph optimization, a whole mapping session,
phases 11-13), map-matching localization, the rebuilt local map with
session restore, and the LM solver (phases 15-17). NDT scan-to-map tracking
runs at
the KITTI HDL-64 operating point of bench.py (raw scans padded to 131 072
points, frames of <= 32 768 points, 1 m NDT voxels on a 256 x 256 x 64
grid, 65 536 compact voxels, a 20-keyframe local map); the A-LOAM front end
at the CLI's KITTI HDL-64 configuration (cli.py: 131 072-point sweeps, a
65 536-point corner map and a 131 072-point surf map on a 192 x 192 x 32
grid) on bench.py's aloam_leg world and trajectory, at bench.py's density
30 (~5.5k returns a sweep) and at DENSE, a real HDL-64 sweep (~106k):

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
     inputs at both densities (knn_cases at sweep 2: odometry surf and
     corner, k = 8, ring extras; mapping surf and corner, k = 5; and at
     DENSE mapping's two searches against the full maps the phase-10 drive
     left), every key equal with the queries sorted and in a random order,
     no host sync and one kernel and no copy a call, with the wrapper's,
     the kernel's and the plain version's device times;
  8. K3 against its plain version on phase 3's NDT map and one frame's
     voxel ids (direct7, radius27), exact, through both entries: the
     presorted one on the map's keys (no host sync; one kernel and nothing
     else, torch.profiler) and the general one, which sorts the keys; the
     device times of both, of the kernel alone and of the plain version;
  9. the scan-match drive with gather="onehot" (K3 on the path): the
     0.10 m guard, and the same poses as the gather="two_level" drive; a
     third run under torch.profiler gives K3's share of the device time a
     frame and shows that no sort kernel runs;
 10. the A-LOAM drive at each density (AloamPipeline.update x 2, then
     update_batch x 10, twice from the same primed state): ms/sweep, pose
     error (guard 0.3 m mean), both runs equal, one host sync per batch;
     a third run under torch.profiler for the device's busy time a sweep
     and its idle share; K2 launched 10 times a sweep;
 11. loop closure at LoopClosingConfig() widths on bench.py's
     loop_verify_leg hairpin (42 keyframes of 16 384-point scans):
     LoopClosing.update on every keyframe, one ndt_newton launch a
     verification attempt; a loop accepted (fitness <= 0.2, relative pose
     within 0.2 m of the truth), the false pair (1, 14) rejected, at most
     two host syncs an attempt; ndt_newton against its plain version at the
     loop shape (a 160 x 160 x 40 radius27 map of the 0.3 m submap) from
     the keyframe pose (check_poses) and from a far guess (its sums at its
     final pose, its fitness within the gate), the fitness within FIT_TOL
     of a float64 brute-force NN; detect and verify ms, the kernel's device
     time and bound there;
 12. bench.py's two pose graphs (366 nodes, dense Cholesky; 2 048 nodes,
     PCG): chi2 below 5 % of its start, the card's solve against the port's
     CPU solve, ms an LM iteration, at most one host sync an iteration and
     none in the linear solve;
 13. a mapping session as the CLI wires it: FrontEnd (phase 6's operating
     point), BackEnd(BackEndConfig()) and LoopClosing (phase 11's config)
     over a 132-frame hairpin of raw HDL-64-sized scans, ending in
     force_optimize: a loop closed, one ndt_newton launch an alignment, the
     optimized keyframes within SESSION_TOL of the odometry's error to the
     truth; ms/frame and the back half's ms a keyframe. Then the back half
     again over the front end's poses with an arbitrary drift added
     (DRIFT_*, a stress input): a loop closed and the drift taken out. With
     `--session-out FILE` both runs' odometry, keyframes, loop edges and
     optimized poses are saved for session_witness.py, which replays them
     through the JAX back end;
 14. the kernels line (printed last, after phases 15-17): every kernel
     with its launches on its paths, its device time beside its plain
     version's and its bound (the larger of the bytes it must move over
     3.35 TB/s and its fp32 FLOPs over 67 TFLOP/s, counted from this run's
     inputs); K2's headline is DENSE's odometry surf search, its other
     searches under "cases"; ndt_newton's launches count the loop-closure,
     session, matching and rebuilt-map paths too, its `_loop` fields are
     phase 11's and its `_matching` fields phase 15's; K1's count the LM
     alignments of phase 17 beside the host-loop drives;
 15. map-matching localization at MatchingConfig() widths (a 224 x 224 x
     48 radius27 fine map, a 112 x 112 x 24 coarse one, GPF ground removal)
     on bench.py's matching_leg world at DENSE, against the world surface
     voxel-filtered at the viewer's 0.5 m leaf: the crop against its
     capacity; ndt_newton against its plain version at both matching
     shapes on frames 0-2; Matching.update over 13 frames (2 ndt_newton
     launches and 2 host syncs a frame, mean error < 0.3 m) and
     matching_drive over the same frames (the guard, and each pose the
     stepwise frame's from the same guess); the OnlyPosition yaw init
     (height map and 270-yaw search) on the card against the CPU; the
     refresh stall;
 16. FrontEnd(incremental_map=False) at phase 6's operating point and
     frames (the 0.15 m guard, one ndt_newton launch an alignment, the
     rebuild's ms a keyframe beside the incremental update's), and
     FrontEnd.restore from an incremental run's keyframe window, then
     updates: within RESTORE_TOL of the uninterrupted run;
 17. ndt_align(solver="lm") from the scan-match drive's guesses, direct7
     and radius27: one K1 launch an LM evaluation, poses within LM_TOL of
     the NDT optimum (ndt_newton run to a step under OPT_EPS), frame 0
     against the LM over the plain derivative path;
     ndt_fitness_score on the card against the CPU.

Phases 11-17 print the card's name and power limit on each summary line.

Any failed check ends the run with a non-zero exit code. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""

import contextlib
import dataclasses
import json
import os
import shutil
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
DENSE = 10000.0  # the aloam_leg world at a real HDL-64 sweep density (~106k returns in 131 072 rows)
ALOAM_DENSITIES = (30.0, DENSE)  # bench.py's density, kept for continuity, and DENSE
K2_PER_SWEEP = 10  # odometry: 3 rounds x (corner, surf); mapping: 2 rounds x (corner, surf)
# bench.py:187-189
TOL = {"score": dict(rtol=2e-4, atol=0.0), "grad": dict(rtol=2e-3, atol=1e-3), "hess": dict(rtol=2e-3, atol=1e-2)}
POSE_TOL = 1e-4  # ndt_newton against the host loop and its plain version, m and rad (check_poses)
LONG_RUN = 10  # iterations: more is a start-up frame from the drive's 0.3 m-off first guess
GUARD = 0.10  # the scan-match pose-error guard (bench.py), m
LOOP_SCAN_POINTS = 16384  # bench.py loop_verify_leg's scan size
FIT_TOL = 1e-3  # the loop fitness against a float64 brute-force NN, absolute (m^2)
# a pose graph solved on the card against the port's CPU solve of the same arrays, per graph:
# positions (m), rotation entries, chi2 (relative). LM accept/reject turns on float32 rounding; the
# 366-node graph converges, the 2 048-node one stops at its 30-iteration cap mid-descent, where the
# LM path's rounding shows (on an H100 80GB HBM3: 2.9e-4 / 3.2e-6 / 1.5e-6 and 1.7e-2 / 4.3e-4 / 1.7e-5)
GRAPH_TOL = {"366 nodes": (1e-3, 1e-4, 1e-4), "2048 nodes": (5e-2, 2e-3, 1e-4)}
# The session as the CLI wires it: the front end tracks the synthetic corridor to ~2 cm, which
# leaves the loop edges nothing to take out, and the solve spreads their own error (the
# verification's, cm) along the loop. The optimized keyframes' mean error to the truth may exceed
# the odometry's by at most SESSION_TOL m (on an H100 80GB HBM3: 0.0165 -> 0.0182 m); the JAX back
# end replayed over the same keyframes and loop edges (session_witness.py) is the witness.
SESSION_TOL = 5e-3
# A stress input, not the CLI's traffic: the session's back half replayed over the front end's
# poses with an arbitrary drift a frame (the translation scaled by 1 + DRIFT_SCALE and a yaw of
# DRIFT_YAW rad added), which the loop must then take out: the optimized keyframes must end nearer
# the truth than the drifted odometry.
DRIFT_YAW, DRIFT_SCALE = 5e-4, 5e-3
# Phase 15 (bench.py matching_leg): 16 frames, 3 warm, the rest timed; the viewer's global-map leaf
MATCH_FRAMES, MATCH_WARM, GLOBAL_MAP_LEAF = 16, 3, 0.5
MATCH_GUARD = 0.3  # bench.py matching_leg's mean pose-error guard, m
DRIVE_TOL = 1e-4  # matching_drive against _match_step from the drive's own guesses, m and rad
YAW_TOL = 1e-4  # the yaw search's 270 scores, card against CPU, relative to the best
RESTORE_TOL = 1e-3  # FrontEnd.restore, then updates, against the uninterrupted run, m
# ndt_align(solver="lm") against the NDT optimum from the same guesses (ndt_newton run to a step under
# OPT_EPS), m. Both solvers stop once a step is under trans_eps (1 cm), each a few millimetres short
# of the optimum in its own direction, so they are held to the optimum, not to each other
LM_TOL, OPT_EPS = 5e-3, 1e-5
FITNESS_RTOL = 1e-5  # ndt_fitness_score, card against CPU, relative
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


def device_events(fn, reps=10, tries=3):
    """{kernel or copy name: (count, device us)} of reps calls of fn(), from
    torch.profiler (after one warm call). A profiler window now and then
    comes back empty on the card: up to `tries` windows are taken."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
                  if e.self_device_time_total > 0}
        if events:
            return events
    return {}


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
        k, p, trace, at_k, step = newton_case(f"newton {stencil} frame {i}", args, kw, stencil)
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
    """Phase 6 for one stencil (bench.py:98-161): 20 chained frames,
    motion-model prediction, pose-error guard <= 0.10 m mean. Returns the
    poses and the timed run's ms/frame."""
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
    return poses, dt / N_FRAMES * 1e3


def tracking_config():
    """bench.py:315-332 (front_end_leg): the tracking operating point, 1 m
    NDT voxels on a 256 x 256 x 64 grid, 65 536 compact voxels, direct7,
    each alignment one ndt_newton launch on the card."""
    from lidar_slam_tpu_torch.models.registration import NDTConfig
    from lidar_slam_tpu_torch.pipeline import FrontEndConfig

    return FrontEndConfig(
        ndt=NDTConfig(
            resolution=1.0, grid_dims=(256, 256, 64), point_chunk=8192, max_iter=30,
            stencil="direct7", gather="auto", max_compact_voxels=65536, fused_window=512,
        ),
    )


def front_end(dev):
    """Phase 6, second part (bench.py:315-402): FrontEnd.update and
    front_end_drive. Returns the number of alignments they ran (two, coarse
    and fine, a frame, except on a first frame, which has no map yet), the
    truth and the preloaded frames (phase 16 drives them again)."""
    import torch

    from lidar_slam_tpu_torch.io import SyntheticWorld, make_trajectory, simulate_scan
    from lidar_slam_tpu_torch.pipeline import FrontEnd, front_end_drive, init_front_end_drive

    cfg = tracking_config()
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
    return 2 * ((len(scans) - 1) + (3 - 1) + 2 * (len(pts_seq) - 1)), traj, loaded


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


def aloam_workload(density):
    """bench.py:437-473 (aloam_leg): corridor 60 x 18 m, seed 2, at
    `density` (bench.py's 30, or DENSE); 12 sweeps at 0.8 m/frame, each a
    64-ring x 2048-azimuth sweep (131 072 rows, the padded capacity)."""
    from lidar_slam_tpu_torch.io import SyntheticWorld, make_trajectory, simulate_spinning_scan

    world = SyntheticWorld.corridor(length=60.0, width=18.0, density=density, seed=2)
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


def knn_work(grid, q, qm, k, n_extra, n_found):
    """Bytes and fp32 FLOPs of one k-NN search on these inputs: the queries
    read once (xyz and mask), the cell ranges (start, count) of the stencil
    cells the valid queries touch, 12 B of xyz per candidate row of those
    cells, the original index and extras of the `n_found` neighbours only,
    the outputs (idx, dist, ok, pts, extras) written once; a distance per
    candidate."""
    import torch

    from lidar_slam_tpu_torch.ops.hashgrid import _flat_cell_id, clip_to_grid, in_bounds, stencil_offsets

    ok = qm & torch.all(torch.isfinite(q), dim=-1)
    cell = clip_to_grid(torch.floor((q[ok] - grid.origin) / grid.cell_size), grid.dims).to(torch.int32)
    cand = cell[:, None, :] + stencil_offsets(q.device)[None]
    cells = _flat_cell_id(cand, grid.dims)[in_bounds(cand, grid.dims)].long()
    uniq = torch.unique(cells)
    nq = q.shape[0]
    n_bytes = (nq * 13 + uniq.numel() * 8 + int(grid.cell_counts[uniq].sum()) * 12 + n_found * (4 + 4 * n_extra)
               + nq * k * (21 + 4 * n_extra))
    return n_bytes, int(grid.cell_counts[cells].sum()) * FLOPS_KNN_CANDIDATE


def knn_cases(st, pts, msk, after_drive=False):
    """K2's searches in one aloam_step from state `st` on the sweep (pts,
    msk): odometry's (the sweep's flat and sharp features at the warm-start
    pose against the previous sweep's less-flat and less-sharp clouds, ring
    extras, k = 8, 5 m cells) and mapping's (its surf and corner stacks at
    the predicted map pose against the maps, k = 5, 1 m cells). With
    `after_drive`, mapping's only, at the sweep's own refined pose: `st` is
    the state after that sweep. Queries sorted by cell, as the path sorts
    them. Returns {case: (grid, queries, mask, k, radius, extras)}."""
    from lidar_slam_tpu_torch.geom import transform_points
    from lidar_slam_tpu_torch.ops.hashgrid import build_bucket_grid
    from lidar_slam_tpu_torch.pipeline.aloam import downsample_stacks, extract_features
    from lidar_slam_tpu_torch.pipeline.aloam.odometry import sort_by_cell

    fe, odo, mapping = aloam_configs()
    f = extract_features(pts, msk, fe)
    stack_corner, stack_surf = downsample_stacks(f.less_sharp, f.less_flat, mapping)
    guess = st.T_map_odom @ st.T_world if after_drive else st.T_map_odom @ st.T_world @ st.T_rel
    r_odo = float(np.sqrt(odo.dist_sq_threshold))

    def case(target, cell, dims, cloud, T, k, radius, extras):
        grid = build_bucket_grid(target, cell, dims)
        q = transform_points(T, cloud.points)
        order = sort_by_cell(grid, q, cloud.mask)
        return grid, q[order].contiguous(), cloud.mask[order].contiguous(), k, radius, extras

    cases = {}
    if not after_drive:
        cases["odometry"] = case(st.prev_less_flat, odo.grid_cell, odo.grid_dims, f.flat, st.T_rel, odo.knn_k,
                                 r_odo, st.prev_less_flat_ring)
    cases["mapping"] = case(st.surf_map, mapping.grid_cell, mapping.grid_dims, stack_surf, guess, mapping.knn_k,
                            mapping.nn_radius, None)
    if not after_drive:
        cases["odometry corner"] = case(st.prev_less_sharp, odo.grid_cell, odo.grid_dims, f.sharp, st.T_rel,
                                        odo.knn_k, r_odo, st.prev_less_sharp_ring)
    cases["mapping corner"] = case(st.corner_map, mapping.grid_cell, mapping.grid_dims, stack_corner, guess,
                                   mapping.knn_k, mapping.nn_radius, None)
    return cases


def knn_parity(label, cases):
    """Phase 7 for one operating point: K2 vs knn_exact_plain on `cases`
    (knn_cases), equal on every key with the queries sorted and in a random
    order; one call makes no host sync and runs one kernel and no copy
    (torch.profiler). Returns {case: fields of the kernels line}."""
    import torch

    from lidar_slam_tpu_torch.ops.cuda import knn_fused

    out = {}
    for name, (grid, q, qm, k, radius, extras) in cases.items():
        lanes = knn_fused.default_lanes(grid.cell_size)

        def call(q=q, qm=qm):
            return knn_fused.window_knn(grid, q, qm, k, radius, extras)

        plain = knn_fused.knn_exact_plain(grid, q, qm, k, radius, extras)
        plain_ms = device_ms(lambda: knn_fused.knn_exact_plain(grid, q, qm, k, radius, extras), reps=3)
        with counting_syncs() as syncs:
            r = call()
        check(syncs[0] == 0, f"K2 {label} {name}: {syncs[0]} host syncs in one call")
        perm = torch.randperm(q.shape[0], generator=torch.Generator().manual_seed(0)).to(q.device)
        r_perm = call(q[perm].contiguous(), qm[perm].contiguous())
        torch.cuda.synchronize()
        check(set(r) == set(plain), f"K2 {label} {name}: keys {sorted(r)} vs {sorted(plain)}")
        err = 0.0
        for key in plain:
            check(torch.equal(r[key], plain[key]), f"K2 {label} {name}: {key} differs from the plain version")
            if key != "unresolved":
                check(torch.equal(r_perm[key], plain[key][perm]), f"K2 {label} {name}: {key} differs in random order")
            if key != "ok" and r[key].numel():
                a, b = r[key].double(), plain[key].double()
                both = torch.isfinite(a) & torch.isfinite(b)
                err = max(err, float(torch.where(both, (a - b).abs(), 0.0).max()))
        ms = device_ms(call)
        events = device_events(call)
        check(len(events) == 1 and "knn_kernel" in next(iter(events)),
              f"K2 {label} {name}: device work of 10 calls {events}, expected one kernel and nothing else")
        n_calls, us = next(iter(events.values()))
        alone = us / n_calls / 1e3
        n_found = int(plain["ok"].sum())
        n_bytes, flops = knn_work(grid, q, qm, k, 0 if extras is None else 1, n_found)
        bound_ms, bound_by = bound(n_bytes, flops)
        log(f"[parity K2 {label} {name}] {int(qm.sum())} queries x {int(grid.valid.sum())} table rows "
            f"(largest cell {int(grid.cell_counts.max())}), k={k}, r={radius}, "
            f"{lanes} lanes: {n_found} neighbours, equal to the plain version "
            f"sorted and in random order, no host sync; K2 {ms:.4f} ms (kernel alone {alone:.4f}, one launch, "
            f"no copy), plain {plain_ms:.4f} ms (device, median); bound {bound_ms:.5f} ms ({n_bytes} B, "
            f"{flops} FLOP: {bound_by})")
        out[name] = {"density": label, "case": name, "ms": ms, "alone_ms": alone, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err, "queries": int(qm.sum()),
                     "rows": int(grid.valid.sum()), "lanes": lanes}
    return out


def gather_cases(workload, cfg):
    """Phase 3's NDT map and the voxel ids of one preprocessed frame at the
    first guess, direct7 and radius27 (-2 off the grid): (map, {stencil:
    [N, S] int32 ids})."""
    import torch

    from lidar_slam_tpu_torch.models.registration import build_ndt_map
    from lidar_slam_tpu_torch.ops.cuda import ndt_fused
    from lidar_slam_tpu_torch.pipeline.front_end import _preprocess

    map_cloud, all_pts, all_msk, _, guess0 = workload
    ndt_map = build_ndt_map(map_cloud, cfg)
    frame = _preprocess(all_pts[0], all_msk[0], FRAME_CAP, 0.5)
    dev = frame.points.device
    xp = frame.points @ torch.as_tensor(guess0[:3, :3], device=dev).T + torch.as_tensor(guess0[:3, 3], device=dev)
    cell = torch.floor((xp - ndt_map.origin.to(dev)) / ndt_map.resolution).to(torch.int32)
    dims_t = torch.as_tensor(ndt_map.dims, dtype=torch.int32, device=dev)
    cases = {}
    for stencil in ("direct7", "radius27"):
        cand = cell[:, None, :] + torch.as_tensor(ndt_fused.STENCIL_OFFSETS[stencil], device=dev)[None]
        inb = torch.all((cand >= 0) & (cand < dims_t), dim=-1)
        vid = (cand[..., 0] * ndt_map.dims[1] + cand[..., 1]) * ndt_map.dims[2] + cand[..., 2]
        cases[stencil] = torch.where(inb, vid, -2).contiguous()
    return ndt_map, cases


def is_k3_kernel(name):
    """Whether a profiler event is K3's kernel: ndt_gather_* here, or the
    earlier form's gather_kernel (so chip_gather.py reads a parent too)."""
    return "ndt_gather" in name or "::gather_kernel(" in name


def gather_work(keys, vids):
    """Bytes K3 must move on these inputs: the keys read once, the rows of
    the keys hit once, the ids in and the 64 B rows out."""
    import torch

    return keys.numel() * 4 + int(torch.isin(keys, vids[vids >= 0]).sum()) * 64 + vids.numel() * (4 + 64)


def gather_parity(workload, cfg):
    """Phase 8: K3 against its plain version on phase 3's NDT map and one
    frame's voxel ids (gather_cases), both entries: the presorted one on the
    map's keys (one kernel, no sort, no host sync) and the general one,
    which sorts the keys first. Exact. Returns {stencil: fields of the
    kernels line}: both entries' device times (CUDA events), the kernel's
    alone (torch.profiler), the plain version's, the bound."""
    import torch

    from lidar_slam_tpu_torch.ops.cuda import ndt_gather

    ndt_map, cases = gather_cases(workload, cfg)
    keys, table = ndt_map.keys, ndt_map.packed
    out = {}
    for stencil, vids in cases.items():
        def sorted_call():
            return ndt_gather.gather_stats_sorted(keys, table, vids)

        def general_call():
            return ndt_gather.gather_stats_onehot(keys, table, vids)

        with counting_syncs() as syncs:
            k = sorted_call()
        check(syncs[0] == 0, f"K3 {stencil}: {syncs[0]} host syncs in a presorted call")
        g = general_call()
        p = ndt_gather.gather_stats_plain(keys, table, vids)
        check(torch.equal(k, p), f"K3 {stencil}: presorted rows differ from the plain version")
        check(torch.equal(g, p), f"K3 {stencil}: general-entry rows differ from the plain version")
        err = float((k - p).abs().max())
        hits = int((k[..., 10] > 0.5).sum())
        ms = device_ms(sorted_call)
        ms_general = device_ms(general_call)
        events = device_events(sorted_call)
        check(len(events) == 1 and is_k3_kernel(next(iter(events))),
              f"K3 {stencil}: device work of 10 presorted calls {events}, expected one kernel and nothing else")
        n_calls, us = next(iter(events.values()))
        alone = us / n_calls / 1e3
        plain_ms = device_ms(lambda: ndt_gather.gather_stats_plain(keys, table, vids), reps=3)
        n_bytes = gather_work(keys, vids)
        bound_ms, bound_by = bound(n_bytes, 0)
        log(f"[parity K3 {stencil}] {vids.numel()} ids ({hits} on valid voxels) x {len(keys)} keys: both entries "
            f"equal to the plain version, no host sync; presorted {ms:.4f} ms (kernel alone {alone:.4f}, one "
            f"launch), general {ms_general:.4f} ms (with its key sort), plain {plain_ms:.4f} ms (device, median); "
            f"bound {bound_ms:.5f} ms ({n_bytes} B: {bound_by})")
        out[stencil] = {"ms": ms, "alone_ms": alone, "ms_general": ms_general, "plain_ms": plain_ms,
                        "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by}
    return out


def onehot_drive(workload, cfg):
    """Phase 9: the direct7 scan-match drive with gather="onehot" (K3 for
    the stats fetch, the plain derivative math around it). It fetches the
    same rows as gather="two_level", so the poses are the same. Then a
    third run of the onehot drive, on frames preprocessed before it, under
    torch.profiler: K3's device time a frame and the whole device time a
    frame, and the names of any sort kernels it ran (the map's keys are in
    order, so none should run). Returns those and the timed ms/frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lidar_slam_tpu_torch.models.registration import build_ndt_map, ndt_align
    from lidar_slam_tpu_torch.pipeline.front_end import _preprocess

    oh_cfg = dataclasses.replace(cfg, gather="onehot", stencil="direct7")
    onehot, ms_frame = scan_match_drive(workload, oh_cfg, "direct7")
    two_level, _ = scan_match_drive(workload, dataclasses.replace(cfg, gather="two_level"), "direct7")
    check(np.array_equal(onehot, two_level), "onehot drive: poses differ from the two_level drive")
    log("[scan-match onehot] poses equal to the gather=two_level drive's")

    map_cloud, all_pts, all_msk, _, guess0 = workload
    ndt_map = build_ndt_map(map_cloud, oh_cfg)
    frames = [_preprocess(all_pts[i], all_msk[i], FRAME_CAP, 0.5) for i in range(N_FRAMES)]
    torch.cuda.synchronize()
    for _ in range(2):  # a profiler window now and then comes back empty on the card
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            last = predict = torch.as_tensor(guess0)
            for f in frames:
                pose = ndt_align(ndt_map, f, predict, oh_cfg).pose
                last, predict = pose, pose @ torch.linalg.solve(last, pose)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        if events:
            break
    busy = sum(e.self_device_time_total for e in events) / N_FRAMES / 1e3
    k3 = sum(e.self_device_time_total for e in events if is_k3_kernel(e.key)) / N_FRAMES / 1e3
    sorts = sorted({e.key for e in events if "sort" in e.key.lower()})
    log(f"[scan-match onehot] profiled run: device busy {busy:.4f} ms/frame, K3 {k3:.4f} ms/frame of it "
        f"({k3 / max(busy, 1e-12):.3f}); sort kernels: {sorts or 'none'}")
    return {"ms_per_frame": ms_frame, "device_ms_per_frame": busy, "k3_ms_per_frame": k3, "sorts": sorts}


def aloam_drive(dev, traj, frames, label):
    """Phase 10 (bench.py:437-473) at one density: two sweeps prime the
    state through update(), then sweeps 2-11 go through update_batch twice
    from that state: a warm-up, then the timed run. Checks the 0.3 m
    mean-error guard, that both runs give the same poses, and that the timed
    batch synchronises with the host once (its final pose copy). Returns
    (ms/sweep, the pipeline after the timed run). A third run, under
    torch.profiler, gives the device's busy time a sweep and its idle
    share of the timed run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    log(f"[aloam {label}] update_batch of {n} sweeps: {dt / n * 1e3:.2f} ms/sweep ({n / dt:.1f} fps), "
        f"{n_sync} host sync(s); pose error mean {errs.mean():.4f} max {errs.max():.4f} m; "
        f"{int(sum(m.sum() for _, m in frames))} returns in {len(frames)} sweeps of {len(frames[0][1])} rows")
    check(errs.mean() < 0.3, f"A-LOAM {label}: error guard ({errs.mean():.4f} m)")
    check(np.array_equal(warm, poses), f"A-LOAM {label}: two chained runs from the same primed state differ")
    check(n_sync == 1, f"A-LOAM {label}: update_batch synchronised {n_sync} times, expected once")
    # a third run under torch.profiler: the device's busy time a sweep
    for _ in range(2):  # a profiler window now and then comes back empty on the card
        pipe.state = primed
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pipe.update_batch(batch)
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        if events:
            break
    busy = sum(e.self_device_time_total for e in events) / n / 1e3
    k2 = sum(e.self_device_time_total for e in events if "knn_kernel" in e.key) / n / 1e3
    log(f"[aloam {label}] device busy {busy:.3f} ms/sweep (torch.profiler, a third run of the batch): idle share "
        f"{1 - busy / (dt / n * 1e3):.3f} of the timed run; K2 {k2:.4f} ms/sweep of it")
    return dt / n * 1e3, pipe


def loop_config():
    """bench.py:821-823 (loop_verify_leg): LoopClosingConfig() with
    loop_step 1, diff_num 20 and a 20-keyframe Scan Context exclusion: 0.3 m
    leaves, a 65 536-point submap, a 16 384-point scan, a 160 x 160 x 40 NDT
    grid, radius27, Scan Context 20 x 60."""
    from lidar_slam_tpu_torch.models.scan_context import ScanContextConfig
    from lidar_slam_tpu_torch.pipeline import LoopClosingConfig

    return LoopClosingConfig(loop_step=1, diff_num=20, sc=ScanContextConfig(num_exclude_recent=20))


def loop_store(root):
    """bench.py:812-831: the 60 x 16 m corridor (density 30, seed 9), the
    14 / 16 / 12 hairpin at 1 m a frame, one 16 384-point scan (45 m range)
    a keyframe, its returns stored with their ground-truth pose."""
    from lidar_slam_tpu_torch.io import KeyframeStore, SyntheticWorld, make_hairpin_trajectory, simulate_scan

    world = SyntheticWorld.corridor(length=60.0, width=16.0, density=30.0, seed=9)
    gt = make_hairpin_trajectory(n_out=14, n_turn=16, n_back=12, speed=1.0, turn_radius=1.0)
    store = KeyframeStore(root)
    for i in range(len(gt)):
        pts, mask, _ = simulate_scan(world, gt[i], t=i * 0.1, max_range=45.0, n_points=LOOP_SCAN_POINTS, seed=900 + i)
        kept = pts[mask]
        store.save(i, kept, np.ones(len(kept), bool), gt[i], time=i * 0.1)
    return gt, store


def newton_case(name, args, kw, stencil):
    """ndt_newton and its plain version on one alignment's inputs `args`:
    (kernel result, plain result, the plain run's evaluated poses, the
    plain sums at the kernel's final pose, the kernel sums' Newton-step gap
    to them, check_sums_at)."""
    import torch

    from lidar_slam_tpu_torch.ops.cuda import ndt_newton as N
    from lidar_slam_tpu_torch.ops.cuda.ndt_fused import ndt_reduce_plain

    trace = []
    k = N.ndt_newton(*args, **kw).cpu().numpy()
    p = N.ndt_newton_plain(*args, **kw, trace=trace).cpu().numpy()
    R, t, jang, hang = N.pose_coefficients(torch.as_tensor(k[N.POSE], device=args[0].device))
    at_k = ndt_reduce_plain(*args[:6], R, t, jang, hang, dims=kw["dims"], resolution=kw["resolution"], d1=kw["d1"],
                            d2=kw["d2"], stencil=stencil, weight_derivatives=kw["weight_derivatives"]).cpu().numpy()
    return k, p, trace, at_k, check_sums_at(name, k, at_k)


def nn_fitness_f64(target, source, T, max_radius=2.0):
    """point_nn_fitness_score in float64 by direct differences (no matmul
    form): the reference for the port's float32 |q|^2 - 2 q.t + |t|^2."""
    import torch

    T = T.double()
    x = source.points[source.mask].double() @ T[:3, :3].T + T[:3, 3]
    tgt = target.points[target.mask].double()
    d2 = torch.cat([torch.cdist(x[s:s + 1024], tgt, compute_mode="donot_use_mm_for_euclid_dist").amin(dim=1) ** 2
                    for s in range(0, x.shape[0], 1024)])
    return float(torch.clamp(d2, max=max_radius**2).mean())


def loop_kernel_parity(lc, pair, smi):
    """Phase 11, second part: ndt_newton against its plain version at the
    loop shape, on the detected pair's submap and scan (built as
    `_verify_step` builds them), from the keyframe pose (check_poses,
    check_sums_at) and from a guess 0.5 m and 3 degrees off (check_sums_at,
    the fitness within the gate; the poses logged); the fitness at the
    kernel's pose against a float64 brute-force NN (FIT_TOL); device times
    of the kernel, its plain version and the fitness; the bound from the
    plain run's evaluations. Returns the kernels-line fields."""
    import torch

    from lidar_slam_tpu_torch.geom import euler_xyz_to_matrix
    from lidar_slam_tpu_torch.models.registration import point_nn_fitness_score
    from lidar_slam_tpu_torch.models.registration.ndt import _matrix_to_pose, newton_pose
    from lidar_slam_tpu_torch.ops import PointCloud, voxel_downsample
    from lidar_slam_tpu_torch.ops.cuda import ndt_newton as N
    from lidar_slam_tpu_torch.pipeline import loop_closing as L

    cfg = lc.cfg
    ncfg = dataclasses.replace(cfg.ndt, dense_stats=False)
    i0, i1 = pair
    sub_pts, sub_msk, scan_pts, scan_msk = lc._verify_inputs(i0, i1)
    submap, ndt_map = L._submap_ndt(sub_pts, sub_msk, cfg)
    scan = voxel_downsample(PointCloud(points=scan_pts, mask=scan_msk), cfg.scan_filter_leaf,
                            out_capacity=cfg.scan_capacity)
    kw = newton_kw(ndt_map, ncfg)
    off = lc.key_poses[i1].copy()
    off[:3, :3] = off[:3, :3] @ euler_xyz_to_matrix(*torch.tensor([0.0, 0.0, np.deg2rad(3.0)], dtype=torch.float32)).numpy()
    off[:3, 3] += np.float32([0.4, -0.3, 0.0])
    res, gaps, iters, plain_iters = {"max_abs_err": 0.0}, [], [], []
    for label, guess in (("keyframe pose", lc.key_poses[i1]), ("0.5 m, 3 deg off", off)):
        pose0 = torch.as_tensor(_matrix_to_pose(guess), device=scan.points.device)
        args = (scan.points, scan.mask, scan.get_weights(), ndt_map.index, ndt_map.packed, ndt_map.origin, pose0)
        k, p, trace, _, step = newton_case(f"loop newton {label}", args, kw, ncfg.stencil)
        gap = pose_gap(newton_pose(torch.as_tensor(k)).numpy(), newton_pose(torch.as_tensor(p)).numpy())
        gaps.append(gap)
        iters.append(int(k[N.ITERATIONS]))
        plain_iters.append(int(p[N.ITERATIONS]))
        res["max_abs_err"] = max(res["max_abs_err"], float(np.abs(k[N.POSE] - p[N.POSE]).max()))
        T = newton_pose(torch.as_tensor(k).to(scan.points.device))
        fit = float(point_nn_fitness_score(submap, scan, T))
        ref = nn_fitness_f64(submap, scan, T)
        log(f"[loop newton] pair {i0}->{i1} from the {label}: kernel {iters[-1]} iterations, plain "
            f"{plain_iters[-1]}; kernel - plain {gap[0]:.2e} m, {gap[1]:.2e} rad; gradient difference's step "
            f"{step:.2e}; fitness {fit:.6f} against float64 {ref:.6f} ({abs(fit - ref):.2e})")
        check(abs(fit - ref) <= FIT_TOL, f"loop fitness {fit} vs float64 brute force {ref}")
        res["off_fitness"] = fit
        if "ms" in res:
            continue  # timed on the first guess's inputs
        res["iterations"] = iters[-1]
        res["ms"] = device_ms(lambda: N.ndt_newton(*args, **kw), reps=20)
        res["plain_ms"] = device_ms(lambda: N.ndt_newton_plain(*args, **kw), reps=3)
        res["fitness_ms"] = device_ms(lambda: point_nn_fitness_score(submap, scan, T), reps=10)
        n_bytes, flops = ndt_work(scan, ndt_map, trace, ncfg)
        res["bound_ms"], res["bound_by"] = bound(n_bytes, flops)
        log(f"[loop newton] {int(scan.mask.sum())} scan points x {int((ndt_map.keys >= 0).sum())} voxels of a "
            f"{int(submap.mask.sum())}-point submap ({ncfg.stencil}, {'x'.join(map(str, ndt_map.dims))} grid): "
            f"ndt_newton {res['ms']:.4f} ms an alignment of {res['iterations']} iterations, plain "
            f"{res['plain_ms']:.2f} ms (device, median); bound {res['bound_ms']:.5f} ms ({n_bytes} B, {flops} FLOP "
            f"in {len(trace)} evaluations: {res['bound_by']}); fitness {res['fitness_ms']:.3f} ms ({smi})")
    # the path's own guess: from the second, a far start, where a radius27 alignment stops is decided
    # by float32 rounding (check_poses), so it is logged and its fitness held to the gate
    check_poses("loop newton", ncfg.stencil, gaps[:1], iters[:1], plain_iters[:1], ncfg.trans_eps)
    check(res["off_fitness"] <= cfg.fitness_score_limit, f"loop newton from the far guess: fitness {res['off_fitness']}")
    return res


def loop_drive(dev, root, smi):
    """Phase 11: bench.py's loop_verify_leg on the card. The main path:
    LoopClosing.update on each of the 42 keyframes, the counts read just
    after (one ndt_newton launch an attempt). Then: the first accepted
    loop's fitness (<= 0.2) and relative pose (within 0.2 m of the truth);
    the false pair (1, 14) rejected; host syncs of one attempt (at most 2:
    the map build's origin and the pose-and-fitness copy) and of one
    retrieval; detect and verify ms (wall, synchronised, median of 5) and
    an attempt's device busy time (torch.profiler); loop_kernel_parity."""
    import torch

    from lidar_slam_tpu_torch.ops.cuda import ndt_newton
    from lidar_slam_tpu_torch.pipeline import LoopClosing
    from lidar_slam_tpu_torch.pipeline import loop_closing as L

    t0 = time.perf_counter()
    gt, store = loop_store(root)
    log(f"[workload] loop: {len(gt)} keyframe scans simulated and stored in {time.perf_counter() - t0:.1f} s")
    lc = LoopClosing(loop_config(), store, data_path=root, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    loops = [lp for i in range(len(gt)) if (lp := lc.update(i, gt[i])) is not None]
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    launches, attempts = ndt_newton.launches, lc.attempts
    log(f"[loop] LoopClosing.update over {len(gt)} keyframes: {drive_s * 1e3 / len(gt):.2f} ms a keyframe, "
        f"{attempts} verification attempts, {launches} ndt_newton launches, accepted "
        f"{[(lp.index0, lp.index1, round(lp.fitness, 4)) for lp in loops]} ({smi})")
    check(loops, "loop: no loop accepted on the hairpin")
    check(launches == attempts > 0, f"loop: {launches} ndt_newton launches in {attempts} verification attempts")
    lp = loops[0]
    rel_gt = np.linalg.inv(gt[lp.index0]) @ gt[lp.index1]
    err = float(np.linalg.norm(lp.relative_pose[:3, 3] - rel_gt[:3, 3]))
    check(lp.fitness <= 0.2 and err < 0.2, f"loop {lp.index0}->{lp.index1}: fitness {lp.fitness}, {err} m off")
    before = lc.attempts
    check(lc._verify(1, 14, 0.0) is None, "loop: the false pair (1, 14) was accepted")
    false_attempts = lc.attempts - before

    args = lc._verify_inputs(lp.index0, lp.index1)
    guess = lc.key_poses[lp.index1]
    with counting_syncs() as attempt_syncs:
        L._verify_step(*args, guess, lc.cfg)
    with counting_syncs() as detect_syncs:
        lc.sc.detect()
    check(attempt_syncs[0] <= 2, f"loop: {attempt_syncs[0]} host syncs in one verification attempt")
    detect_ms = host_ms(lc.sc.detect)
    verify_ms = host_ms(lambda: lc._verify(lp.index0, lp.index1, 0.0))
    step_ms = host_ms(lambda: L._verify_step(*args, guess, lc.cfg))
    events = device_events(lambda: L._verify_step(*args, guess, lc.cfg), reps=5)
    step_busy = sum(us for _, us in events.values()) / 5 / 1e3
    log(f"[loop] pair {lp.index0}->{lp.index1}: fitness {lp.fitness:.4f}, relative pose {err:.4f} m from the "
        f"truth; false pair (1, 14) rejected in {false_attempts} attempts; host syncs: {attempt_syncs[0]} an "
        f"attempt, {detect_syncs[0]} a retrieval; detect {detect_ms:.3f} ms, verify {verify_ms:.2f} ms (store reads "
        f"included; one attempt on uploaded inputs {step_ms:.2f} ms; wall, median), the attempt's device busy "
        f"time {step_busy:.3f} ms (torch.profiler) ({smi})")
    res = loop_kernel_parity(lc, (lp.index0, lp.index1), smi)
    res.update(launches=launches, attempts=attempts, detect_ms=detect_ms, verify_ms=verify_ms,
               syncs_per_attempt=attempt_syncs[0])
    return res


def circle_graph(builder, n, radius, rng):
    """bench.py:207-233 / 276-297: n poses on a circle, odometry edges with
    N(0, 0.02) se(3) noise chained into the initial guess, one loop edge
    from the last node to the first; node 0 fixed."""
    import torch

    from lidar_slam_tpu_torch.geom import se3_exp

    gt = []
    for i in range(n):
        th = 2 * np.pi * i / n
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
        T[:3, 3] = [radius * np.cos(th), radius * np.sin(th), 0.0]
        gt.append(T)
    est = [gt[0]]
    builder.add_se3_node(gt[0], fixed=True)
    for i in range(1, n):
        Z = np.linalg.inv(gt[i - 1]) @ gt[i]
        Zn = se3_exp(torch.as_tensor(rng.normal(0, 0.02, 6).astype(np.float32))).numpy() @ Z
        est.append((est[-1] @ Zn).astype(np.float32))
        builder.add_se3_node(est[-1])
        builder.add_se3_edge(i - 1, i, Zn, noise=[0.5, 0.5, 0.5, 0.01, 0.01, 0.01])
    builder.add_se3_edge(n - 1, 0, np.linalg.inv(gt[n - 1]) @ gt[0], noise=[0.3, 0.3, 0.3, 0.01, 0.01, 0.01])


def pose_graphs(dev, smi):
    """Phase 12: bench.py's pose_graph_leg graphs (bench.py:194-311) solved
    on the card: 366 nodes at capacity 384 (the dense Cholesky path,
    max_iterations 50) and 2 048 nodes (PCG, max_iterations 30). Each: chi2
    below 5 % of its start; the poses and chi2 within GRAPH_TOL of the
    port's own CPU solve of the same arrays; a timed solve (wall,
    synchronised), its device busy time (torch.profiler) and a solve under
    sync counting (at most one host read an LM iteration); the linear solve
    alone reads nothing on the host."""
    import torch

    from lidar_slam_tpu_torch import convert
    from lidar_slam_tpu_torch.models import graph_optimizer as G

    rng = np.random.default_rng(0)
    cases = (("366 nodes", 366, 60.0, (384, 384, 8), G.GraphOptimizerConfig(max_iterations=50), True),
             ("2048 nodes", 2048, 120.0, (2048, 2056, 8), G.GraphOptimizerConfig(max_iterations=30, solver="pcg"),
              False))
    out = {}
    for name, n, radius, caps, cfg, dense in cases:
        b = G.PoseGraphBuilder(*caps, device=dev)
        circle_graph(b, n, radius, rng)
        check(G.uses_dense(cfg, b.max_nodes) == dense, f"pose graph {name}: not on the {'dense' if dense else 'PCG'} path")
        g = b.to_graph()
        G.optimize_pose_graph(g, cfg)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        go, st = G.optimize_pose_graph(g, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        with counting_syncs() as syncs:
            _, st2 = G.optimize_pose_graph(g, cfg)
        events = device_events(lambda: G.optimize_pose_graph(g, cfg), reps=1)
        busy = sum(us for _, us in events.values()) / 1e3
        asm = G._assemble(g, cfg)
        grad = G._gradient(asm)
        lam = torch.full((), cfg.lm_lambda_init, device=dev)
        with counting_syncs() as solve_syncs:
            G._solve_dense(asm, lam, grad) if dense else G._solve_pcg(asm, lam, grad, cfg)
        fields = {f.name: getattr(b, "_" + f.name) for f in dataclasses.fields(G.PoseGraph)}
        t0 = time.perf_counter()
        co, cst = G.optimize_pose_graph(convert.pose_graph_from_numpy(fields, device="cpu"), cfg)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        dpos = float(np.abs(go.poses[:n, :3, 3].cpu().numpy() - co.poses[:n, :3, 3].numpy()).max())
        drot = float(np.abs(go.poses[:n, :3, :3].cpu().numpy() - co.poses[:n, :3, :3].numpy()).max())
        dchi2 = abs(st["chi2_after"] - cst["chi2_after"]) / cst["chi2_after"]
        it = st["iterations"]
        log(f"[pose graph {name}] {'dense' if dense else 'PCG'}: chi2 {st['chi2_before']:.2f} -> "
            f"{st['chi2_after']:.5f} in {it} LM iterations, {ms:.1f} ms ({ms / max(it, 1):.3f} ms an iteration; "
            f"wall, synchronised; device busy {busy:.1f} ms a solve, torch.profiler); {syncs[0]} host syncs in a "
            f"solve of {st2['iterations']} iterations, "
            f"{solve_syncs[0]} in the linear solve alone; CPU solve {cst['iterations']} iterations, chi2 "
            f"{cst['chi2_after']:.5f}, {cpu_ms:.0f} ms; card - CPU: poses {dpos:.2e} m, {drot:.2e} (rotation "
            f"entries), chi2 {dchi2:.2e} relative ({smi})")
        check(st["chi2_after"] < 0.05 * st["chi2_before"], f"pose graph {name}: chi2 did not fall below 5 %")
        check(syncs[0] <= st2["iterations"], f"pose graph {name}: {syncs[0]} host syncs in {st2['iterations']} iterations")
        check(solve_syncs[0] == 0, f"pose graph {name}: the linear solve synchronised {solve_syncs[0]} times")
        tol_pos, tol_rot, tol_chi2 = GRAPH_TOL[name]
        check(dpos <= tol_pos and drot <= tol_rot and dchi2 <= tol_chi2,
              f"pose graph {name}: card and CPU solves differ ({dpos}, {drot}, {dchi2})")
        out[name] = {"ms": ms, "iterations": it, "ms_per_iteration": ms / max(it, 1), "syncs": syncs[0], "busy_ms": busy}
    return out


def session_workload():
    """Phase 13's drive: the loop phase's corridor (16 m wide, density 30,
    seed 9) lengthened to 100 m, and a hairpin on it of 60 / 16 / 56 frames
    at 1 m a frame, so that a 2 m keyframe gate leaves more keyframes than
    the 20-keyframe Scan Context exclusion before the return leg passes the
    outbound one; a raw HDL-64-sized scan (RAW_CAP points, 80 m) a frame."""
    from lidar_slam_tpu_torch.io import SyntheticWorld, make_hairpin_trajectory, simulate_scan

    world = SyntheticWorld.corridor(length=100.0, width=16.0, density=30.0, seed=9)
    gt = make_hairpin_trajectory(n_out=60, n_turn=16, n_back=56, speed=1.0, turn_radius=1.0)
    scans = [simulate_scan(world, gt[i], t=i * 0.1, max_range=80.0, n_points=RAW_CAP, seed=5000 + i, noise=0.02)[:2]
             for i in range(len(gt))]
    return gt, scans


def drifted(poses):
    """The stress odometry: `poses` [N, 4, 4] re-chained from their
    frame-to-frame motion with the translation scaled by 1 + DRIFT_SCALE and
    a yaw of DRIFT_YAW added a frame."""
    c, s = np.cos(DRIFT_YAW), np.sin(DRIFT_YAW)
    yaw = np.float32([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    out = [poses[0].astype(np.float32)]
    for a, b in zip(poses[:-1], poses[1:]):
        step = (np.linalg.inv(a) @ b).astype(np.float32)
        step[:3, 3] *= 1.0 + DRIFT_SCALE
        out.append((out[-1] @ step @ yaw).astype(np.float32))
    return np.stack(out)


def session_run(dev, root, scans, front=None, odometry=None):
    """The session loop of cli.py:154-199 over `scans`: each frame's
    odometry (FrontEnd.update on the preloaded frame if `front` =
    (FrontEnd, preloaded frames) is given, else `odometry[i]`) to
    BackEnd.update with the frame's returns, each new keyframe to
    LoopClosing.update, each accepted loop to insert_loop_pose, then
    force_optimize. Returns the back end, the loop closer, a record (the
    odometry, the keyframes' frames, each loop edge with the frame that
    inserted it, the final solve's stats), the session's and the back
    half's wall seconds (the card synchronised at the end)."""
    import torch

    from lidar_slam_tpu_torch.io import KeyframeStore
    from lidar_slam_tpu_torch.pipeline import BackEnd, BackEndConfig, LoopClosing

    store = KeyframeStore(root)
    be = BackEnd(BackEndConfig(), store=store, device=dev)
    lc = LoopClosing(loop_config(), store=store, data_path=root, device=dev)
    rec = {"odom": [], "kf_frames": [], "loops": []}
    back_s = 0.0
    t0 = time.perf_counter()
    for i, (pts, mask) in enumerate(scans):
        odom = front[0].update(None, preloaded=front[1][i])[0] if front else odometry[i]
        tb = time.perf_counter()
        rec["odom"].append(np.asarray(odom, np.float32))
        kept = pts[mask]
        if be.update(odom, time=i * 0.1, cloud_points=kept, cloud_mask=np.ones(len(kept), bool)):
            kf = be.latest_keyframe()
            rec["kf_frames"].append(i)
            loop = lc.update(kf.index, kf.pose)
            if loop is not None:
                rec["loops"].append((i, loop))
                be.insert_loop_pose(loop.index0, loop.index1, loop.relative_pose)
            if be.has_new_optimized():
                be.get_optimized_poses()
        back_s += time.perf_counter() - tb
    tb = time.perf_counter()
    rec["stats"] = be.force_optimize()
    torch.cuda.synchronize()
    back_s += time.perf_counter() - tb
    return be, lc, rec, time.perf_counter() - t0, back_s


def keyframe_errors(gt, be, rec):
    """Mean and max distance to the truth of the keyframes' odometry and of
    their optimized poses."""
    kf_gt = gt[rec["kf_frames"]][:, :3, 3]
    odo = np.stack([k.pose for k in be.key_frames])[:, :3, 3]
    e_odo, e_opt = (np.linalg.norm(p - kf_gt, axis=1) for p in (odo, be.optimized_poses[:, :3, 3]))
    return e_odo, e_opt


def mapping_session(dev, root, gt, scans, smi, session_out=None):
    """Phase 13, the main path of the mapping back half: FrontEnd (phase 6's
    tracking operating point), BackEnd(BackEndConfig()) and LoopClosing
    (loop_config()) over session_workload's hairpin, wired as the CLI wires
    them (session_run). Checks at least one accepted loop, one ndt_newton
    launch an alignment (two a tracked frame, one a verification attempt)
    and the optimized keyframes' mean error to the truth within SESSION_TOL
    of the odometry's. Then the stress run (the back half over `drifted`
    front-end poses, its counts read apart): a loop accepted, one launch an
    attempt, the optimized keyframes nearer the truth than the drifted
    odometry. Saves both runs to `session_out` if given. Returns the
    launches of both, ms a frame of the session and ms a keyframe of the
    back half (BackEnd, LoopClosing and the solves: wall, the session
    synchronised at its end)."""
    import torch

    from lidar_slam_tpu_torch.ops.cuda import ndt_newton
    from lidar_slam_tpu_torch.pipeline import FrontEnd

    fe = FrontEnd(tracking_config(), device=dev)
    fe.set_init_pose(gt[0])
    loaded = [fe.preload(p, m) for p, m in scans]  # the CLI uploads on its prefetch thread
    torch.cuda.synchronize()
    reset_launches()
    be, lc, rec, total_s, back_s = session_run(dev, os.path.join(root, "cli"), scans, front=(fe, loaded))
    launches, n_align = ndt_newton.launches, 2 * (len(scans) - 1) + lc.attempts
    del loaded
    err_odo, err_opt = keyframe_errors(gt, be, rec)
    loops = [lp for _, lp in rec["loops"]]
    loop_err = [float(np.linalg.norm(lp.relative_pose[:3, 3] - (np.linalg.inv(gt[rec["kf_frames"][lp.index0]])
                                                                  @ gt[rec["kf_frames"][lp.index1]])[:3, 3]))
                for lp in loops]
    n_kf, stats = len(be.key_frames), rec["stats"]
    log(f"[session] {len(scans)} frames, {n_kf} keyframes, {lc.attempts} verification attempts, loops "
        f"{[(lp.index0, lp.index1, round(lp.fitness, 4)) for lp in loops]} (relative pose to the truth "
        f"{[round(e, 4) for e in loop_err]} m); {total_s * 1e3 / len(scans):.2f} ms a frame, back half "
        f"{back_s * 1e3 / n_kf:.2f} ms a keyframe (wall); final solve chi2 {stats['chi2_before']:.4f} -> "
        f"{stats['chi2_after']:.4f} in {stats['iterations']:.0f} iterations; keyframe error to the truth: odometry "
        f"mean {err_odo.mean():.4f} max {err_odo.max():.4f} m, optimized mean {err_opt.mean():.4f} max "
        f"{err_opt.max():.4f} m (bound: odometry + {SESSION_TOL}); {launches} ndt_newton launches in {n_align} "
        f"alignments ({smi})")
    check(loops, "session: no loop accepted")
    check(launches == n_align, f"session: {launches} ndt_newton launches in {n_align} alignments")
    check(err_opt.mean() <= err_odo.mean() + SESSION_TOL,
          f"session: the optimized keyframes' mean error {err_opt.mean()} exceeds the odometry's {err_odo.mean()} "
          f"by more than {SESSION_TOL} m")

    reset_launches()
    odom_d = drifted(np.stack(rec["odom"]))
    be_d, lc_d, rec_d, _, back_d = session_run(dev, os.path.join(root, "drift"), scans, odometry=odom_d)
    launches_d = ndt_newton.launches
    d_odo, d_opt = keyframe_errors(gt, be_d, rec_d)
    log(f"[session, drift {DRIFT_SCALE} scale and {DRIFT_YAW} rad a frame: a stress input] {len(be_d.key_frames)} "
        f"keyframes, {lc_d.attempts} verification attempts, loops "
        f"{[(lp.index0, lp.index1, round(lp.fitness, 4)) for _, lp in rec_d['loops']]}; back half "
        f"{back_d * 1e3 / len(be_d.key_frames):.2f} ms a keyframe (wall); keyframe error to the truth: odometry mean "
        f"{d_odo.mean():.4f} max {d_odo.max():.4f} m, optimized mean {d_opt.mean():.4f} max {d_opt.max():.4f} m; "
        f"{launches_d} ndt_newton launches ({smi})")
    check(rec_d["loops"], "session with drift: no loop accepted")
    check(launches_d == lc_d.attempts, f"session with drift: {launches_d} ndt_newton launches in {lc_d.attempts} attempts")
    check(d_opt.mean() < d_odo.mean(), "session with drift: the optimized keyframes are no nearer the truth than the odometry")

    if session_out:
        out = {"gt": np.asarray(gt, np.float32)}
        for tag, b, r in (("cli", be, rec), ("drift", be_d, rec_d)):
            loops_r = r["loops"]
            out.update({
                f"{tag}_odom": np.stack(r["odom"]), f"{tag}_kf_frames": np.asarray(r["kf_frames"]),
                f"{tag}_loop_frames": np.asarray([i for i, _ in loops_r], np.int64),
                f"{tag}_loop_index": np.asarray([(lp.index0, lp.index1) for _, lp in loops_r], np.int64).reshape(-1, 2),
                f"{tag}_loop_rel": np.asarray([lp.relative_pose for _, lp in loops_r], np.float32).reshape(-1, 4, 4),
                f"{tag}_optimized": np.asarray(b.optimized_poses, np.float32),
            })
        os.makedirs(os.path.dirname(os.path.abspath(session_out)), exist_ok=True)
        np.savez(session_out, **out)
        log(f"[session] both runs saved to {session_out}")
    return {"launches": launches, "launches_drift": launches_d, "ms_per_frame": total_s * 1e3 / len(scans),
            "back_ms_per_keyframe": back_s * 1e3 / n_kf}


def matching_workload(dev):
    """Phase 15's inputs: bench.py's matching_leg world and trajectory
    (corridor 120 x 18 m, seed 5; 16 frames at 1 m a frame) at DENSE, each
    frame a simulate_spinning_scan sweep of 64 x 2 048 bins (~104k returns
    in RAW_CAP rows), and the global map as the CLI loads it: the world
    surface voxel-filtered at the viewer's global_map_leaf. Returns (truth,
    raw frames, global map points (host), the world's point count)."""
    from lidar_slam_tpu_torch.io import SyntheticWorld, make_trajectory, simulate_spinning_scan
    from lidar_slam_tpu_torch.ops import PointCloud, voxel_downsample

    world = SyntheticWorld.corridor(length=120.0, width=18.0, density=DENSE, seed=5)
    traj = make_trajectory(MATCH_FRAMES, speed=1.0)
    frames = [simulate_spinning_scan(world, traj[i], t=i * 0.1, n_scans=64, n_azimuth=2048, seed=700 + i)[:2]
              for i in range(MATCH_FRAMES)]
    gm = voxel_downsample(PointCloud.from_points(world.points, device=dev), GLOBAL_MAP_LEAF)
    return traj, frames, gm.points[gm.mask].cpu().numpy(), len(world.points)


def matching_kernel_parity(m, frame, predict, res):
    """Phase 15, one frame: ndt_newton against its plain version at the
    matching shapes (the coarse 112 x 112 x 24 map from `predict`, then the
    fine 224 x 224 x 48 one from the kernel's coarse pose), with
    check_sums_at; the first call also times the fine alignment (kernel,
    plain, bound from the plain run's evaluations). Appends (gap,
    iterations, plain iterations) per level to `res` and returns the
    kernel's fine pose [4, 4] (host)."""
    import torch

    from lidar_slam_tpu_torch.models.registration.ndt import _matrix_to_pose, newton_pose
    from lidar_slam_tpu_torch.ops.cuda import ndt_newton as N

    guess, calls = predict, {}
    for level, ndt_map, cfg in (("coarse", m.coarse_ndt_map, m._coarse_cfg()), ("fine", m.ndt_map, m.cfg.ndt)):
        kw = newton_kw(ndt_map, cfg)
        pose0 = torch.as_tensor(_matrix_to_pose(guess), device=frame.points.device)
        args = (frame.points, frame.mask, frame.get_weights(), ndt_map.index, ndt_map.packed, ndt_map.origin, pose0)
        calls[level] = (args, kw)
        k, p, trace, _, step = newton_case(f"matching newton {level}", args, kw, cfg.stencil)
        gap = pose_gap(newton_pose(torch.as_tensor(k)).numpy(), newton_pose(torch.as_tensor(p)).numpy())
        res[level].append((gap, int(k[N.ITERATIONS]), int(p[N.ITERATIONS])))
        res["max_abs_err"] = max(res["max_abs_err"], float(np.abs(k[N.POSE] - p[N.POSE]).max()))
        log(f"[matching newton {level}] kernel {int(k[N.ITERATIONS])} iterations, plain {int(p[N.ITERATIONS])}; "
            f"kernel - plain {gap[0]:.2e} m, {gap[1]:.2e} rad; gradient difference's step {step:.2e}")
        guess = newton_pose(torch.as_tensor(k)).numpy()
        if level == "fine" and "ms" not in res:
            res["iterations"] = int(k[N.ITERATIONS])
            res["ms"] = device_ms(lambda: N.ndt_newton(*args, **kw), reps=20)
            res["plain_ms"] = device_ms(lambda: N.ndt_newton_plain(*args, **kw), reps=3)
            n_bytes, flops = ndt_work(frame, ndt_map, trace, cfg)
            res["bound_ms"], res["bound_by"] = bound(n_bytes, flops)
            c_args, c_kw = calls["coarse"]
            res["coarse_ms"] = device_ms(lambda: N.ndt_newton(*c_args, **c_kw), reps=20)
            log(f"[matching newton] {int(frame.mask.sum())} frame points x {int((ndt_map.keys >= 0).sum())} voxels "
                f"({cfg.stencil}, {'x'.join(map(str, ndt_map.dims))} grid): ndt_newton {res['ms']:.4f} ms an "
                f"alignment of {res['iterations']} iterations, plain {res['plain_ms']:.2f} ms (device, median); "
                f"bound {res['bound_ms']:.5f} ms ({n_bytes} B, {flops} FLOP in {len(trace)} evaluations: "
                f"{res['bound_by']}); coarse alignment {res['coarse_ms']:.4f} ms")
    return guess


def matching_phase(dev, smi):
    """Phase 15: Matching at MatchingConfig() widths on the matching_leg
    world at DENSE. The crop against local_map_capacity; ndt_newton against
    its plain version at the matching shapes on frames 0-2 (each stepwise
    update then equal to the kernel's pose); the main path: FullPose
    Matching.update over frames 3-15 after the three warm frames (2
    ndt_newton launches and 2 host syncs a frame, K1 none; mean error
    < MATCH_GUARD) and matching_drive over the same frames (the same guard;
    each pose within DRIVE_TOL of _match_step from the drive's own guess);
    _height_map and _yaw_search (frame 3, the OnlyPosition init) on the card
    against the same calls on CPU tensors (the same best yaw, scores within
    YAW_TOL), an OnlyPosition Matching through set_gnss_pose; the refresh
    stall (reset_local_map). Returns the kernels-line fields."""
    import torch

    from lidar_slam_tpu_torch.ops.cuda import ndt_fused
    from lidar_slam_tpu_torch.ops.cuda import ndt_newton as N
    from lidar_slam_tpu_torch.pipeline import Matching, MatchingConfig, matching_drive
    from lidar_slam_tpu_torch.pipeline import matching as M

    t0 = time.perf_counter()
    traj, frames, gmap, n_world = matching_workload(dev)
    cfg = MatchingConfig()
    m = Matching(cfg, gmap, device=dev)
    m.set_gnss_pose(traj[0])
    loaded = [m.preload(*f) for f in frames]
    torch.cuda.synchronize()
    n_ret = [int(f[1].sum()) for f in frames]
    used = [int((x.keys >= 0).sum()) for x in (m.ndt_map, m.coarse_ndt_map)]
    log(f"[matching] workload {time.perf_counter() - t0:.1f} s: {n_world} world points, a global map of {len(gmap)} "
        f"points ({GLOBAL_MAP_LEAF} m leaf); frames of {min(n_ret)}-{max(n_ret)} returns in {cfg.raw_capacity} rows; "
        f"crop {m.crop_points} points (capacity {cfg.local_map_capacity}), local map "
        f"{int(m._local_cloud.mask.sum())} points ({cfg.local_map_leaf} m), compact voxels fine {used[0]} / coarse "
        f"{used[1]} (of {cfg.ndt.max_compact_voxels}) ({smi})")
    check(m.crop_points <= cfg.local_map_capacity,
          f"matching: the crop holds {m.crop_points} points, over local_map_capacity {cfg.local_map_capacity}")
    check(max(used) < cfg.ndt.max_compact_voxels, f"matching: compact voxels {used} fill the table")

    res = {"max_abs_err": 0.0, "coarse": [], "fine": []}
    warm_launches = 0
    for i in range(MATCH_WARM):
        frame = M._frame(*loaded[i], cfg)
        kernel_pose = matching_kernel_parity(m, frame, m.current_pose @ m.predict_step, res)
        before = N.launches
        pose = m.update(None, preloaded=loaded[i])
        warm_launches += N.launches - before
        check(np.array_equal(pose, kernel_pose.astype(np.float32)),
              f"matching frame {i}: Matching.update's pose is not the kernel's")
    for level in ("coarse", "fine"):
        gaps, iters, plain_iters = zip(*res[level])
        check_poses(f"matching newton {level}", "radius27", gaps, iters, plain_iters, cfg.ndt.trans_eps)

    reset_launches()
    with counting_syncs() as syncs:
        t0 = time.perf_counter()
        poses = [m.update(None, preloaded=loaded[i]) for i in range(MATCH_WARM, MATCH_FRAMES)]
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3 / len(poses)
    n = len(poses)
    step_launches = N.launches
    errs = np.linalg.norm(np.stack(poses)[:, :3, 3] - traj[MATCH_WARM:, :3, 3], axis=1)
    log(f"[matching] Matching.update {dt:.2f} ms/frame over {n} frames (wall, sync counting on), pose error mean "
        f"{errs.mean():.4f} max {errs.max():.4f} m; {N.launches} ndt_newton and {ndt_fused.launches} K1 launches, "
        f"{syncs[0]} host syncs ({smi})")
    check(N.launches == 2 * n and ndt_fused.launches == 0,
          f"matching: {N.launches} ndt_newton and {ndt_fused.launches} K1 launches in {n} frames, expected 2 a frame")
    check(syncs[0] == 2 * n, f"matching: {syncs[0]} host syncs in {n} frames, expected 2 a frame")
    check(errs.mean() < MATCH_GUARD, f"matching: pose error guard ({errs.mean():.4f} m)")

    pts_seq = torch.stack([loaded[i][0] for i in range(MATCH_WARM, MATCH_FRAMES)])
    msk_seq = torch.stack([loaded[i][1] for i in range(MATCH_WARM, MATCH_FRAMES)])
    ccfg = m._coarse_cfg()
    reset_launches()
    best = float("inf")
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dposes, dunres = matching_drive(m.ndt_map, m.coarse_ndt_map, pts_seq, msk_seq, traj[MATCH_WARM], cfg, ccfg)
        best = min(best, time.perf_counter() - t0)
    drive_launches = N.launches
    check(drive_launches == 4 * n and ndt_fused.launches == 0,
          f"matching_drive: {drive_launches} ndt_newton launches in two drives of {n} frames")
    dposes = dposes.numpy()
    errs_d = np.linalg.norm(dposes[:, :3, 3] - traj[MATCH_WARM:, :3, 3], axis=1)
    cur, step, gap = torch.as_tensor(traj[MATCH_WARM]), torch.eye(4), 0.0
    for k in range(n):
        _, _, pose, _ = M._match_step(m.ndt_map, m.coarse_ndt_map, pts_seq[k], msk_seq[k], cur @ step, cfg, ccfg)
        gap = max(gap, *pose_gap(pose.numpy(), dposes[k]))
        step, cur = torch.linalg.solve(cur, torch.as_tensor(dposes[k])), torch.as_tensor(dposes[k])
    log(f"[matching] matching_drive {best * 1e3 / n:.2f} ms/frame ({n / best:.1f} fps), pose error mean "
        f"{errs_d.mean():.4f} m, unresolved max {float(dunres.max())}; |drive - stepwise| from its guesses "
        f"{gap:.2e} ({smi})")
    check(float(dunres.max()) == 0.0, "matching_drive: unresolved > 0")
    check(errs_d.mean() < MATCH_GUARD, f"matching_drive: pose error guard ({errs_d.mean():.4f} m)")
    check(gap <= DRIVE_TOL, f"matching_drive: {gap} from the stepwise frames from the same guesses")

    # the OnlyPosition init on frame 3: the height map and all 270 yaws on the card and on the CPU
    pos = np.asarray(traj[MATCH_WARM][:3, 3], np.float32)
    scan = M._frame(*loaded[MATCH_WARM], cfg)
    cloud = m._local_cloud
    dim, cell = cfg.height_map_dim, cfg.cell_size
    origin = np.asarray(pos[:2] - dim * cell / 2.0, np.float32)
    out = {}
    for where in (dev, "cpu"):
        c_pts, c_msk = cloud.points.to(where), cloud.mask.to(where)
        hm = M._height_map(c_pts, c_msk, torch.as_tensor(origin, device=where), dim, cell)
        out[where] = (hm, *M._yaw_search(scan.points.to(where), scan.mask.to(where), torch.as_tensor(pos, device=where),
                                         *hm, torch.as_tensor(origin, device=where), dim, cell, cfg.yaw_samples))
    (hm_g, yaw_g, sc_g), (hm_c, yaw_c, sc_c) = out[dev], out["cpu"]
    sc_g, sc_c = sc_g.cpu().numpy(), sc_c.numpy()
    rel = float(np.max(np.abs(sc_g - sc_c)) / np.max(np.abs(sc_c)))
    hm_err = max(float((a.cpu().double() - b.double()).abs().max()) for a, b in zip(hm_g[:2], hm_c[:2]))
    yaw_err = abs((float(yaw_g) + np.pi) % (2 * np.pi) - np.pi)  # the truth's yaw is 0
    order = np.argsort(-sc_g)
    res["height_ms"] = device_ms(lambda: M._height_map(cloud.points, cloud.mask, torch.as_tensor(origin, device=dev),
                                                       dim, cell), reps=10)
    res["yaw_ms"] = device_ms(lambda: M._yaw_search(scan.points, scan.mask, torch.as_tensor(pos, device=dev), *hm_g,
                                                    torch.as_tensor(origin, device=dev), dim, cell, cfg.yaw_samples),
                              reps=10)
    log(f"[matching yaw] {int(scan.mask.sum())} scan points x {cfg.yaw_samples} yaws on a {dim} x {dim} height map "
        f"({int(hm_g[2].sum())} cells occupied): best yaw {float(yaw_g):.4f} rad (CPU {float(yaw_c):.4f}), "
        f"{yaw_err:.4f} rad from the truth; best scores {sc_g[order[0]]:.2f}, next {sc_g[order[1]]:.2f} at "
        f"{float(order[1]) * 2 * np.pi / cfg.yaw_samples:.4f} rad; scores card vs CPU {rel:.2e} relative, height map "
        f"{hm_err:.2e}; height map {res['height_ms']:.3f} ms, yaw search {res['yaw_ms']:.3f} ms (device, median) "
        f"({smi})")
    check(int(np.argmax(sc_g)) == int(np.argmax(sc_c)) and float(yaw_g) == float(yaw_c),
          "the yaw search: the card's best yaw is not the CPU's")
    check(rel <= YAW_TOL, f"the yaw search: scores {rel} apart (relative)")
    check(torch.equal(hm_g[2].cpu(), hm_c[2]), "the height map: occupied cells differ")

    init = Matching(dataclasses.replace(cfg, init_mode="only_position"), gmap, device=dev)
    check(init.update(None, preloaded=loaded[MATCH_WARM]) is None, "OnlyPosition: the first update returned a pose")
    t0 = time.perf_counter()
    agreed = [init.set_gnss_pose(pos), init.set_gnss_pose(pos)]
    res["init_ms"] = (time.perf_counter() - t0) * 1e3 / 2
    init_yaw = float(np.arctan2(init.current_pose[1, 0], init.current_pose[0, 0])) if init.has_inited() else None
    res["refresh_ms"] = host_ms(lambda: m.reset_local_map(pos), reps=3)
    log(f"[matching init] OnlyPosition set_gnss_pose x 2: {agreed}, yaw {init_yaw}; {res['init_ms']:.1f} ms a call "
        f"(a crop and map rebuild, the height map, the yaw search); reset_local_map {res['refresh_ms']:.1f} ms "
        f"(wall, median) ({smi})")
    check(agreed == [False, True], f"OnlyPosition: set_gnss_pose gave {agreed}, expected [False, True]")
    res.update(launches=warm_launches + step_launches + drive_launches, ms_per_frame=dt,
               drive_ms_per_frame=best * 1e3 / n, error=float(errs.mean()), drive_error=float(errs_d.mean()))
    return res


def rebuilt_front_end(dev, traj, loaded, smi):
    """Phase 16 at phase 6's NDT operating point and frames:
    FrontEnd(incremental_map=False) over the 18 frames (the 0.15 m guard,
    one ndt_newton launch an alignment, K1 none), the rebuild's ms a
    keyframe beside the incremental update's (both host wall, synchronised,
    on the run's last keyframe window); then FrontEnd.restore from the last
    local_frame_num keyframes of an incremental run stopped after a frame
    that is not a keyframe (so nothing is pending), and update over the
    remaining frames: poses within RESTORE_TOL of the uninterrupted run's.
    The rebuilt-map run is repeated with the JAX package's coarse-map
    corner, its error logged. Returns the kernels-line fields."""
    import torch

    from lidar_slam_tpu_torch.ops.cuda import ndt_fused
    from lidar_slam_tpu_torch.ops.cuda import ndt_newton as N
    from lidar_slam_tpu_torch.pipeline import FrontEnd
    from lidar_slam_tpu_torch.pipeline import front_end as F
    from lidar_slam_tpu_torch.pipeline.front_end import _build_local_map, _incremental_map_update, coarse_tracking_cfg

    cfg = dataclasses.replace(tracking_config(), incremental_map=False)
    fe = FrontEnd(cfg, device=dev)
    fe.set_init_pose(traj[0])
    reset_launches()
    for i in range(6):
        fe.update(None, preloaded=loaded[i])
    torch.cuda.synchronize()
    n_kf0, errs = fe.n_keyframes, []
    t0 = time.perf_counter()
    for i in range(6, len(loaded)):
        pose, _ = fe.update(None, preloaded=loaded[i])
        errs.append(np.linalg.norm(pose[:3, 3] - traj[i][:3, 3]))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) * 1e3 / (len(loaded) - 6)
    launches, n_align = N.launches, 2 * (len(loaded) - 1)
    k = cfg.local_frame_num
    last = (fe.kf_cursor - 1) % k
    res = {"launches": launches, "ms_per_frame": dt, "error": float(np.mean(errs))}
    res["rebuild_ms"] = host_ms(lambda: _build_local_map(
        fe.kf_points, fe.kf_masks, fe.kf_weights, fe.kf_poses, fe.kf_valid, min(fe.n_keyframes, k),
        fe.kf_poses[last][:3, 3], cfg), reps=5)
    log(f"[rebuilt map] FrontEnd(incremental_map=False).update {dt:.2f} ms/frame, {fe.n_keyframes - n_kf0} keyframes "
        f"in {len(loaded) - 6} frames ({fe.n_keyframes} total), pose error mean {res['error']:.4f} m; "
        f"{launches} ndt_newton and {ndt_fused.launches} K1 launches in {n_align} alignments; the rebuild "
        f"{res['rebuild_ms']:.2f} ms a keyframe ({int(fe.local_map_cloud.mask.sum())} local-map points) ({smi})")
    check(res["error"] < 0.15, f"rebuilt-map front end: error guard ({res['error']:.4f} m)")
    check(launches == n_align and ndt_fused.launches == 0,
          f"rebuilt-map front end: {launches} ndt_newton launches in {n_align} alignments")

    # the same run with the JAX package's coarse corner (the fine corner itself, off the coarse
    # lattice where odd): logged, the measurement behind front_end.coarse_origin
    snap = F.coarse_origin
    F.coarse_origin = lambda origin, resolution: np.asarray(origin, np.float32)
    try:
        ref = FrontEnd(cfg, device=dev)
        ref.set_init_pose(traj[0])
        ref_errs = [np.linalg.norm(ref.update(None, preloaded=loaded[i])[0][:3, 3] - traj[i][:3, 3])
                    for i in range(len(loaded))]
    finally:
        F.coarse_origin = snap
    res["reference_corner_error"] = float(np.mean(ref_errs[6:]))
    log(f"[rebuilt map] with the JAX package's coarse corner: pose error mean {res['reference_corner_error']:.4f} "
        f"m over frames 6-{len(loaded) - 1}, per frame m {np.array2string(np.asarray(ref_errs), precision=3)}")

    # the uninterrupted incremental run, stopped after a frame that made no keyframe
    inc = FrontEnd(tracking_config(), device=dev)
    inc.set_init_pose(traj[0])
    stop = None
    for i in range(len(loaded)):
        _, is_kf = inc.update(None, preloaded=loaded[i])
        if i >= 9 and not is_kf:
            stop = i
            break
    check(stop is not None and inc._pending_update is None, "restore: no frame to stop the run after")
    recs = []
    for j in range(max(0, inc.kf_cursor - k), inc.kf_cursor):
        s, msk = j % k, inc.kf_masks[j % k]
        recs.append({"points": inc.kf_points[s][msk].cpu().numpy(), "weights": inc.kf_weights[s][msk].cpu().numpy(),
                     "pose": inc.kf_poses[s].copy()})
    fine_cfg = dataclasses.replace(inc.cfg.ndt, dense_stats=False)
    s = (inc.kf_cursor - 1) % k
    origin = FrontEnd._lattice_origin(inc.kf_poses[s][:3, 3], fine_cfg, snap_mult=2.0)
    res["incremental_ms"] = host_ms(lambda: _incremental_map_update(
        inc.fine_sums, inc.kf_world[s], inc.kf_masks[s], inc.kf_weights[s], inc.kf_points[s], inc.kf_masks[s],
        inc.kf_weights[s], inc.kf_poses[s], origin, fine_cfg, coarse_tracking_cfg(inc.cfg.ndt)), reps=5)
    restored = FrontEnd(tracking_config(), device=dev)
    t0 = time.perf_counter()
    restored.restore(recs, total_keyframes=inc.kf_cursor, last_pose=inc.last_pose, predict_pose=inc.predict_pose)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    gaps, flags = [], []
    for i in range(stop + 1, len(loaded)):
        a, ka = inc.update(None, preloaded=loaded[i])
        b, kb = restored.update(None, preloaded=loaded[i])
        gaps.append(pose_gap(a, b))
        flags.append(ka == kb)
    gaps = np.asarray(gaps)
    log(f"[restore] from {len(recs)} keyframes (run stopped after frame {stop}, {inc.kf_cursor} keyframes): restore "
        f"{restore_ms:.1f} ms, then {len(gaps)} updates: |restored - uninterrupted| max {gaps[:, 0].max():.2e} m, "
        f"{gaps[:, 1].max():.2e} rad, keyframe flags equal {all(flags)}; incremental map update "
        f"{res['incremental_ms']:.2f} ms a keyframe against the rebuild's {res['rebuild_ms']:.2f} ({smi})")
    check(all(flags) and gaps[:, 0].max() <= RESTORE_TOL,
          f"restore: {gaps[:, 0].max()} m from the uninterrupted run (flags equal: {all(flags)})")
    res["restore_gap"] = float(gaps[:, 0].max())
    return res


def lm_phase(workload, cfg, drives, smi):
    """Phase 17: ndt_align(solver="lm") from the scan-match drive's guesses
    (its motion-model predictions of its own poses), direct7 and radius27:
    one K1 launch an LM evaluation and no ndt_newton launch; poses within
    LM_TOL of ndt_newton's run to a step under OPT_EPS (the NDT optimum),
    their gap to ndt_newton at the configuration's trans_eps logged. The
    first frame's LM
    against the same LM over the plain derivative path on the card
    (gather="two_level"), within POSE_TOL; ndt_fitness_score at the LM's
    pose on the card against the same call on CPU tensors (FITNESS_RTOL).
    Returns the LM's K1 launches."""
    import torch

    from lidar_slam_tpu_torch.models.registration import build_ndt_map, ndt_align, ndt_fitness_score
    from lidar_slam_tpu_torch.ops.cuda import ndt_fused, ndt_newton
    from lidar_slam_tpu_torch.pipeline.front_end import _preprocess

    map_cloud, all_pts, all_msk, gt, guess0 = workload
    total = 0
    for stencil, poses in drives.items():
        scfg = dataclasses.replace(cfg, stencil=stencil)
        lm_cfg = dataclasses.replace(scfg, solver="lm")
        ndt_map = build_ndt_map(map_cloud, scfg)
        frames = [_preprocess(all_pts[i], all_msk[i], FRAME_CAP, 0.5) for i in range(N_FRAMES)]
        guesses, last, predict = [], torch.as_tensor(guess0), torch.as_tensor(guess0)
        for p in poses:
            guesses.append(predict)
            p = torch.as_tensor(p)
            step = torch.linalg.solve(last, p)
            last, predict = p, p @ step
        newton = [ndt_align(ndt_map, f, g, scfg) for f, g in zip(frames, guesses)]
        opt_cfg = dataclasses.replace(scfg, trans_eps=OPT_EPS, max_iter=100)
        optimum = [ndt_align(ndt_map, f, g, opt_cfg) for f, g in zip(frames, guesses)]
        reset_launches()
        t0 = time.perf_counter()
        lm = [ndt_align(ndt_map, f, g, lm_cfg) for f, g in zip(frames, guesses)]
        dt = (time.perf_counter() - t0) * 1e3 / N_FRAMES
        evals = sum(r.iterations + 1 for r in lm)
        check(ndt_fused.launches == evals and ndt_newton.launches == 0,
              f"LM {stencil}: {ndt_fused.launches} K1 and {ndt_newton.launches} ndt_newton launches in {evals} "
              f"evaluations")
        total += ndt_fused.launches
        gaps = np.asarray([pose_gap(a.pose.numpy(), b.pose.numpy()) for a, b in zip(lm, optimum)])
        gaps_n = np.asarray([pose_gap(a.pose.numpy(), b.pose.numpy()) for a, b in zip(newton, optimum)])
        err = np.linalg.norm(np.stack([r.pose.numpy() for r in lm])[:, :3, 3] - gt[:, :3, 3], axis=1)
        plain = ndt_align(ndt_map, frames[0], guesses[0], dataclasses.replace(lm_cfg, gather="two_level"))
        first = pose_gap(lm[0].pose.numpy(), plain.pose.numpy())
        log(f"[lm {stencil}] {N_FRAMES} alignments: {dt:.2f} ms each (wall), iterations {[r.iterations for r in lm]}, "
            f"converged {sum(r.converged for r in lm)}; {ndt_fused.launches} K1 launches in {evals} evaluations; "
            f"from the optimum: LM max {gaps[:, 0].max():.2e} m, {gaps[:, 1].max():.2e} rad, ndt_newton at "
            f"trans_eps {cfg.trans_eps} max {gaps_n[:, 0].max():.2e} m (optimum iterations "
            f"{[r.iterations for r in optimum]}); error mean {err.mean():.4f} m; frame 0 against the plain path's "
            f"LM ({plain.iterations} iterations): {first[0]:.2e} m, {first[1]:.2e} rad ({smi})")
        log(f"[lm {stencil}] per-frame |LM - optimum| m {np.array2string(gaps[:, 0], precision=5)}; "
            f"|ndt_newton - optimum| m {np.array2string(gaps_n[:, 0], precision=5)}")
        check(gaps[:, 0].max() <= LM_TOL, f"LM {stencil}: {gaps[:, 0].max()} m from the NDT optimum")
        check(max(first) <= POSE_TOL, f"LM {stencil} frame 0: {first} from the plain path's LM")
        if stencil == "direct7":
            T = lm[0].pose.to(frames[0].points.device)
            on_card = float(ndt_fitness_score(ndt_map, frames[0], T, scfg))
            cpu_map = dataclasses.replace(ndt_map, **{f: getattr(ndt_map, f).cpu() for f in
                                                      ("count", "mean", "icov", "staticvalue", "valid", "index",
                                                       "packed", "keys")})
            cpu_frame = dataclasses.replace(frames[0], points=frames[0].points.cpu(), mask=frames[0].mask.cpu())
            on_cpu = float(ndt_fitness_score(cpu_map, cpu_frame, T.cpu(), scfg))
            fit_ms = device_ms(lambda: ndt_fitness_score(ndt_map, frames[0], T, scfg), reps=10)
            log(f"[lm fitness] ndt_fitness_score at frame 0's LM pose: card {on_card:.7f}, CPU {on_cpu:.7f} "
                f"({abs(on_card - on_cpu) / on_cpu:.2e} relative); {fit_ms:.3f} ms (device, median) ({smi})")
            check(abs(on_card - on_cpu) <= FITNESS_RTOL * abs(on_cpu), f"ndt_fitness_score: card {on_card}, CPU {on_cpu}")
    return total


def reset_launches():
    from lidar_slam_tpu_torch.ops.cuda import knn_fused, ndt_fused, ndt_gather, ndt_newton

    for m in (ndt_fused, ndt_newton, knn_fused, ndt_gather):
        m.launches = 0


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch / CUDA port on one GPU.")
    ap.add_argument("--session-out", help="save phase 13's runs (.npz) for session_witness.py")
    args = ap.parse_args(argv)

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
    aloam = {}
    for density in ALOAM_DENSITIES:
        t0 = time.perf_counter()
        aloam[density] = aloam_workload(density)
        log(f"[workload] A-LOAM, density {density:g}: {ALOAM_SWEEPS} sweeps simulated in "
            f"{time.perf_counter() - t0:.1f} s")
    knn = []
    for density, (traj, frames) in aloam.items():
        pipe = primed_pipeline(dev, traj, frames)
        knn += knn_parity(f"{density:g}", knn_cases(pipe.state, *pipe.preload(*frames[2]))).values()
    gather = gather_parity(workload, cfg)

    # the main paths: each path's counts are set to 0 just before it and
    # read just after
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    drives = {s: scan_match_drive(workload, cfg, s)[0] for s in stencils}
    launches_drive, k1_drive = ndt_newton.launches, ndt_fused.launches
    n_drive = len(stencils) * 2 * N_FRAMES  # a warm-up and a timed run of the drive per stencil
    reset_launches()
    n_front, traj_front, loaded_front = front_end(dev)
    launches_front, k1_front = ndt_newton.launches, ndt_fused.launches
    log(f"[launches] ndt_newton: {launches_drive} in {n_drive} alignments of the scan-match drives, "
        f"{launches_front} in {n_front} alignments of the front end; K1: {k1_drive} and {k1_front}")
    check(launches_drive == n_drive and k1_drive == 0, "the scan-match drive: not one ndt_newton launch an alignment")
    check(launches_front == n_front and k1_front == 0, "the front end: not one ndt_newton launch an alignment")

    reset_launches()
    onehot = onehot_drive(workload, cfg)
    launches_k3 = ndt_gather.launches
    log(f"[launches] K3: {launches_k3} in the onehot scan-match drives")
    check(launches_k3 > 0 and onehot["k3_ms_per_frame"] > 0, "K3 was not launched by the onehot drive")
    check(not onehot["sorts"], f"the onehot drive ran sort kernels: {onehot['sorts']}")

    launches_k2 = 0
    for density, (traj, frames) in aloam.items():
        reset_launches()
        _, pipe = aloam_drive(dev, traj, frames, f"{density:g}")
        n_sweeps = 2 + 3 * (len(frames) - 2)  # primed by 2, then a warm-up, a timed and a profiled batch
        log(f"[launches] K2: {knn_fused.launches} in the density-{density:g} A-LOAM drive ({n_sweeps} sweeps); "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
        check(knn_fused.launches == K2_PER_SWEEP * n_sweeps,
              f"A-LOAM {density:g}: {knn_fused.launches} K2 launches in {n_sweeps} sweeps, expected "
              f"{K2_PER_SWEEP} a sweep")
        launches_k2 += knn_fused.launches
    # mapping's searches against the full maps the dense drive left
    knn += knn_parity(f"{DENSE:g} after the drive",
                      knn_cases(pipe.state, *pipe.preload(*frames[-1]), after_drive=True)).values()

    # the mapping back half; its stores live in the checkout's build directory
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    loop = loop_drive(dev, os.path.join(work, "loop"), smi)
    pose_graphs(dev, smi)
    t0 = time.perf_counter()
    gt_s, scans_s = session_workload()
    log(f"[workload] session: {len(scans_s)} scans simulated in {time.perf_counter() - t0:.1f} s")
    session = mapping_session(dev, os.path.join(work, "session"), gt_s, scans_s, smi, args.session_out)
    shutil.rmtree(work, ignore_errors=True)

    # this slice's paths: map-matching localization, the rebuilt local map
    # and session restore, the LM solver; counts reset inside each
    reset_launches()
    matching = matching_phase(dev, smi)
    rebuilt = rebuilt_front_end(dev, traj_front, loaded_front, smi)
    launches_lm = lm_phase(workload, cfg, drives, smi)
    log(f"[launches] ndt_newton: {matching['launches']} in the matching paths, {rebuilt['launches']} in the "
        f"rebuilt-map front end; K1: {launches_lm} in the LM alignments ({smi})")

    d7, r27 = parity["direct7"], parity["radius27"]
    n7, n27 = newton["direct7"], newton["radius27"]
    k2 = next(c for c in knn if c["density"] == f"{DENSE:g}" and c["case"] == "odometry")
    g7, g27 = gather["direct7"], gather["radius27"]
    log(json.dumps({"kernels": [
        {
            "name": "ndt_newton",
            "route": "cuda",
            "source": "lidar_slam_tpu_torch/csrc/ndt_newton.cu",
            "replaces": "lidar_slam_tpu/ops/pallas/ndt_fused.py:297",
            "replaces_loop": "lidar_slam_tpu/models/registration/ndt.py:1407",
            "launches": launches_drive + launches_front + loop["launches"] + session["launches"]
            + session["launches_drift"] + matching["launches"] + rebuilt["launches"],
            "max_abs_err": max(n7["max_abs_err"], n27["max_abs_err"], loop["max_abs_err"], matching["max_abs_err"]),
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
            "launches_loop_closure": loop["launches"],
            "launches_session": session["launches"],
            "launches_session_drift": session["launches_drift"],
            "ms_loop": loop["ms"],
            "plain_ms_loop": loop["plain_ms"],
            "bound_ms_loop": loop["bound_ms"],
            "bound_by_loop": loop["bound_by"],
            "iterations_loop": loop["iterations"],
            "launches_matching": matching["launches"],
            "ms_matching": matching["ms"],
            "plain_ms_matching": matching["plain_ms"],
            "bound_ms_matching": matching["bound_ms"],
            "bound_by_matching": matching["bound_by"],
            "iterations_matching": matching["iterations"],
            "ms_matching_coarse": matching["coarse_ms"],
            "launches_front_end_rebuild": rebuilt["launches"],
        },
        {
            "name": "ndt_reduce_fused",
            "route": "cuda",
            "source": "lidar_slam_tpu_torch/csrc/ndt_fused.cu",
            "replaces": "lidar_slam_tpu/ops/pallas/ndt_fused.py:297",
            "launches": launches_k1 + launches_lm,
            "max_abs_err": max(d7[0], r27[0]),
            "ms": d7[1],
            "plain_ms": d7[2],
            "bound_ms": d7[3],
            "bound_by": d7[4],
            "library_ms": None,
            "ms_radius27": r27[1],
            "plain_ms_radius27": r27[2],
            "bound_ms_radius27": r27[3],
            "launches_host_loop_drive": launches_k1,
            "launches_lm": launches_lm,
        },
        {
            "name": "window_knn",
            "route": "cuda",
            "source": "lidar_slam_tpu_torch/csrc/knn_fused.cu",
            "replaces": "lidar_slam_tpu/ops/pallas/knn_fused.py:117",
            "launches": launches_k2,
            "max_abs_err": max(c["max_abs_err"] for c in knn),
            "ms": k2["ms"],
            "plain_ms": k2["plain_ms"],
            "bound_ms": k2["bound_ms"],
            "bound_by": k2["bound_by"],
            "library_ms": None,
            "alone_ms": k2["alone_ms"],
            "cases": [{key: v for key, v in c.items() if key != "max_abs_err"} for c in knn],
        },
        {
            "name": "gather_stats_onehot",
            "route": "cuda",
            "source": "lidar_slam_tpu_torch/csrc/ndt_gather.cu",
            "replaces": "lidar_slam_tpu/ops/pallas/ndt_reduce.py:49",
            "launches": launches_k3,
            "max_abs_err": max(v["max_abs_err"] for v in gather.values()),
            "ms": g7["ms"],
            "plain_ms": g7["plain_ms"],
            "bound_ms": g7["bound_ms"],
            "bound_by": g7["bound_by"],
            "library_ms": None,
            "alone_ms": g7["alone_ms"],
            "ms_general": g7["ms_general"],
            "ms_radius27": g27["ms"],
            "alone_ms_radius27": g27["alone_ms"],
            "ms_general_radius27": g27["ms_general"],
            "plain_ms_radius27": g27["plain_ms"],
            "bound_ms_radius27": g27["bound_ms"],
            "onehot_drive_ms_per_frame": onehot["ms_per_frame"],
            "onehot_drive_k3_ms_per_frame": onehot["k3_ms_per_frame"],
            "onehot_drive_device_ms_per_frame": onehot["device_ms_per_frame"],
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
