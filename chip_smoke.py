#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (lidar_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's paths on the card: tracking, A-LOAM, the mapping back
half (loop closure, pose-graph optimization, a whole mapping session,
phases 11-13), map-matching localization, the rebuilt local map with
session restore, and the LM solver (phases 15-17), and the command-line
entry point from KITTI files on disk (phase 18), the multi-rank layer
(phase 19), the benchmark entry point (phase 20), the mapping CLI over
the endurance drive's first out-and-back with each front end (phases 21-22)
and the pose graph's PCG kernel (phase 23).
NDT scan-to-map tracking
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
  2. builds the kernels (csrc/*.cu: K1 ndt_fused, ndt_newton, K2, K3,
     pose_pcg), one nvcc each, all at once, and logs their registers and
     spills;
  3. K1 against its plain PyTorch version on the card, direct7 and
     radius27, with bench.py's parity tolerances, and both device times;
     K1 given the pose on the card (the bench's evaluation probe: the
     kernel computes the pose coefficients) against the plain version too;
  4. ndt_newton (the whole clamped-Newton alignment in one launch) against
     its plain version on a few alignments of the drive's frames: the
     kernel's score, gradient and Hessian at its final pose against the
     plain sums there, and the poses (check_poses), its device time per
     alignment and per iteration beside the host loop's; its grid (blocks,
     cluster size) and, at frame 0, its split by phase an evaluation from
     20 stamped launches (newton_split), each equal to the bit to an
     unstamped one;
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
  8. a map build (finalize_ndt_sums, which ends with the keys' order
     check, a device-side assert) with no host sync; K3 against its plain
     version on phase 3's NDT map and one frame's
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
 14. the kernels line (printed last, after phases 15-22): every kernel
     with its launches on its paths, its device time beside its plain
     version's and its bound (the larger of the bytes it must move over
     3.35 TB/s and its fp32 FLOPs over 67 TFLOP/s, counted from this run's
     inputs); K2's headline is DENSE's odometry surf search, its other
     searches under "cases"; ndt_newton's launches count the loop-closure,
     session, matching and rebuilt-map paths too, its `_loop` fields are
     phase 11's and its `_matching` fields phase 15's; K1's count the LM
     alignments of phase 17 and the sharded paths of phase 19 beside the
     host-loop drives; every kernel's count adds the bench's (phase 20)
     and the endurance phases' (21-22: ndt_newton's and K2's);
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
     refresh stall. With `--matching-out FILE` the configuration, global
     map, init pose, raw frames and Matching.update's poses are saved for
     matching_witness.py, which replays them through the JAX Matching;
 16. FrontEnd(incremental_map=False) at phase 6's operating point and
     frames (the 0.15 m guard, one ndt_newton launch an alignment, the
     rebuild's ms a keyframe beside the incremental update's), and
     FrontEnd.restore from an incremental run's keyframe window, then
     updates: within RESTORE_TOL of the uninterrupted run;
 17. ndt_align(solver="lm") from the scan-match drive's guesses, direct7
     and radius27: one K1 launch an LM evaluation, poses within LM_TOL of
     the NDT optimum (ndt_newton run to a step under OPT_EPS), frame 0
     against the LM over the plain derivative path;
     ndt_fitness_score on the card against the CPU;
 18. the command-line entry point from KITTI files on disk (cli_phase):
     phase 13's drive written as a KITTI raw *_sync drive by the port's
     writer (with a truck's returns and boxes and 0.10 m GNSS noise) and a
     config at configs/kitti_hdl64.yaml's values (loop closing at phase
     11's); `mapping` through lidar_slam_tpu_torch.cli.main (a loop closed,
     the e2e test's ATE bounds, two ndt_newton launches a frame and one an
     attempt, K1 and K3 none), again with the frames read on the main
     thread; a `python3 -m lidar_slam_tpu_torch mapping` process killed
     after 90 frames, past the hairpin's turn (CLI_KILL_AT), and resumed
     (within 0.05 m of the uninterrupted run);
     `matching` (the 0.3 m guard over the drive's outbound leg, two
     launches a frame); `mapping --front-end aloam` (10 K2 launches a
     sweep); `inspect`;
 19. the multi-rank layer (mesh_phase), in rank processes started by the
     port's launcher (parallel/launch.py): one rank under NCCL, then two
     gloo ranks sharing the card, each at phase 3's NDT operating point:
     every rank's strided shard of frame 0 holds valid points; K1 against
     its plain version on each rank's shard; sharded_ndt_
     derivatives and sharded_ndt_align (K1 once an evaluation on every
     rank, counted by the wrappers and, at one rank, by torch.profiler,
     with one host sync an evaluation) against the host loop and
     ndt_newton; sharded_build_ndt_map and sharded_build_local_map (20
     keyframes) against build_ndt_map; the edge-sharded PCG on phase 12's
     2 048-node circle and the Schur solve on its 366-node one against the
     single-rank optimizer (the sharded PCG on one rank is also held to the
     bit to the single-rank plain PCG, `_solve_pcg`, which it runs; the
     single-rank optimizer on the card launches the PCG kernel);
     front_end_drive(mesh=) over phase 6's frames
     against the single-rank drive and the truth; the dry run
     (parallel/dryrun.py). Wall ms of each beside the unsharded function's.
     With `--parallel-out FILE` the local map's keyframes, grid corner,
     frame and guess and both of the port's maps (one rank and two) are
     saved for parallel_witness.py, which builds the JAX one- and
     two-device maps of the same keyframes and aligns on each;
 20. the benchmark entry point (bench_phase): `python3 -m
     lidar_slam_tpu_torch bench` in its own process: exit 0, bench.py's
     metric lines each once with the card's name and power limit, the
     headlines over the port's CPU path, every leg's launch counts as its
     path must launch them (one ndt_newton launch a scan-match frame, K1 in
     the parity gate and the evaluation probe, K2 10 times an A-LOAM sweep,
     two ndt_newton launches a matching frame); its launches join the
     kernels line's counts; the log carries every drive's iterations and
     errors a frame, the CPU baseline's among them;
 21. the endurance harness (endurance_phase): endurance.py's run_mapping,
     report and check over the first out-and-back of its drive (a 16 m
     corridor with three trucks, at least 100k returns a sweep, 1.05 m a
     frame on 130 m legs with a 3 m U-turn; configs/kitti_hdl64.yaml): the mapping
     CLI with the drive as its frame source, every pose-graph solve, memory
     samples, the saved map's cut; endurance.py's checks but its keyframe
     floor, at least ENDURANCE_MIN_LOOPS loop; its launches join the
     kernels line;
 22. the A-LOAM endurance harness (aloam_endurance_phase): the same
     harness with `mapping --front-end aloam` over the first out-and-back
     of endurance.py's A-LOAM drive (the same corridor, trucks and truth at
     density 10000, 64 x 2 048 spinning sweeps of at least 100k returns,
     simulated by endurance.SIM_WORKERS low-priority processes from phase 2
     on, while the earlier phases run): the CLI's A-LOAM front
     end at 131 072 rows (the CLI's own rule asks 65 536 under
     --synthetic); endurance.py's checks but its keyframe floor: at least
     one verification attempt and ENDURANCE_MIN_LOOPS loop, window_knn
     exactly K2_PER_SWEEP launches a sweep and ndt_newton one an attempt,
     K1 and K3 none, no sweep cut, no map at capacity; its launches join
     the kernels line. The phase's seconds and the whole run's are logged.

 23. the pose graph's PCG kernel (pose_pcg_phase, run after phase 12) at
     the benchmark cell's graph (bench.shuttle_graph at the back end's
     capacities): x against `_solve_pcg` (both against it in float64),
     the same working steps, two launches equal, no host sync; device ms
     beside the plain version's, the bound, the launches on each path and
     one an LM iteration in `optimize_pose_graph`; it joins the kernels
     line.

Phases 11-23 print the card's name and power limit on each summary line.

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

# the workload, the NDT bound's count and the loop and pose-graph set-ups are the bench's
# (lidar_slam_tpu_torch/bench.py, bench.py's legs on the card)
from lidar_slam_tpu_torch.bench import (
    FRAME_CAP,
    N_FRAMES,
    RAW_CAP,
    bound,
    build_workload,
    circle_graph,
    device_label,
    loop_config,
    ndt_work,
    shuttle_graph,
)

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
# Phase 19, the multi-rank layer: sharded alignments timed a world size, the 2 048-node PCG's and the
# 366-node Schur solve's LM iterations, and the tolerances a sharded result is held to against the
# unsharded port function at world 2 (at world 1 the alignment, the derivatives and the PCG must be the
# same bits): test_parallel.py's own, since the sums add in another order on each layout (voxel counts
# and means :82-83, the pose chain of a drive :227-228, the Schur solve against the dense LM :160). A
# voxel's inverse covariance is not compared entry by entry: where its two small eigenvalues nearly
# coincide (a pole's returns) it moves by up to a third of its largest entry between two summation
# orders (the closed-form eigh3 loses the eigenvectors' orthogonality there); it is held through its
# use, an alignment on either map within trans_eps.
MESH_FRAMES, MESH_PCG_ITERS, MESH_SCHUR_ITERS = 4, 5, 20
MAP_TOL = dict(count=1e-5, mean=1e-4)
LAYOUT_TOL, SCHUR_TOL = 8e-2, 0.05
MESH_TIMEOUT = 600.0  # s a launch of phase 19's ranks
BENCH_TIMEOUT = 600.0  # s, phase 20's `python3 -m lidar_slam_tpu_torch bench`
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
    point (bench.py:164-191), K1 given the pose on the card (the bench's
    evaluation probe: the kernel computes the pose coefficients) against
    the plain version too. Returns (max_abs_err, kernel ms, plain ms, bound
    ms, what sets the bound, the device-pose launch's max_abs_err)."""
    import torch

    from lidar_slam_tpu_torch.models.registration import build_ndt_map
    from lidar_slam_tpu_torch.models.registration.ndt import _reduce
    from lidar_slam_tpu_torch.ops.cuda.ndt_fused import ndt_reduce_fused
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
    d1, d2 = cfg.gauss_params()
    kd = ndt_reduce_fused(pts, msk, w, ndt_map.index, ndt_map.packed, ndt_map.origin, None, None, None, None,
                          dims=ndt_map.dims, resolution=ndt_map.resolution, d1=float(np.float32(d1)),
                          d2=float(np.float32(d2)), stencil=stencil, weight_derivatives=cfg.weight_derivatives,
                          pose=torch.from_numpy(pose6).to(pts.device)).cpu().numpy()
    for label, got in (("kernel", k), ("kernel, pose on the card,", kd)):
        check(got[28] == 0.0, f"{stencil}: {label} unresolved = {got[28]}")
        for name, sl in (("score", slice(0, 1)), ("grad", slice(1, 7)), ("hess", slice(7, 28))):
            tol = TOL[name]
            bad = np.abs(got[sl] - p[sl]) > tol["atol"] + tol["rtol"] * np.abs(p[sl])
            check(not bad.any(), f"{stencil} {name}: {label} {got[sl]} vs plain {p[sl]}")
    err = float(np.max(np.abs(k[:28] - p[:28])))
    err_dev = float(np.max(np.abs(kd[:28] - p[:28])))
    ms = device_ms(lambda: _reduce(ndt_map, pts, msk, w, pose6, cfg))
    plain_ms = device_ms(lambda: _reduce(ndt_map, pts, msk, w, pose6, plain_cfg), reps=10)
    n_bytes, flops = ndt_work(frame, ndt_map, [pose6], cfg)
    bound_ms, bound_by = bound(n_bytes, flops)
    log(f"[parity {stencil}] {int(msk.sum())} points x {len(ndt_map.keys)} table rows: "
        f"score {k[0]:.4f} (plain {p[0]:.4f}), |grad| {np.linalg.norm(k[1:7]):.4f}, "
        f"max |kernel - plain| {err:.3e} (pose on the card: {err_dev:.3e}); K1 {ms:.4f} ms (one launch), plain "
        f"{plain_ms:.4f} ms (device, median); bound {bound_ms:.5f} ms ({n_bytes} B, {flops} FLOP: {bound_by})")
    return err, ms, plain_ms, bound_ms, bound_by, err_dev


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


def newton_split(call, max_iter, dev, reps=20):
    """ndt_newton's split by phase on one alignment's inputs: `call(stamps)`
    launched `reps` times with stamps (ndt_newton.split), each result equal to
    the bit to an unstamped launch's. Returns the mean us an evaluation of
    each phase (the globaltimer's ticks average out over the launches), of a
    whole evaluation and of the set-up before the loop (the compaction), the
    evaluations, and the timer's tick (the smallest step seen between two
    stamps, ns)."""
    import torch

    from lidar_slam_tpu_torch.ops.cuda import ndt_newton as N

    ref = call(None)
    stamps = torch.empty(N.stamp_slots(max_iter), dtype=torch.int64, device=dev)
    spans, setup, ticks = [], [], []
    for _ in range(reps):
        out = call(stamps)
        check(torch.equal(out, ref), "ndt_newton: a stamped launch's result differs from the unstamped one")
        head, per = N.split(stamps)
        setup.append(head)
        spans.append(per)
        steps = np.diff(np.sort(stamps[1:].cpu().numpy()))
        ticks.append(steps[steps > 0].min())
    per = np.concatenate(spans)
    res = {name: float(per[:, j].mean() / 1e3) for j, name in enumerate(N.SPLIT)}
    res.update(evaluation=float(per.sum(axis=1).mean() / 1e3), setup=float(np.mean(setup) / 1e3),
               evaluations=len(spans[0]), tick_ns=int(min(ticks)))
    return res


def split_text(sp):
    from lidar_slam_tpu_torch.ops.cuda.ndt_newton import SPLIT

    return ", ".join(f"{name} {sp[name]:.2f}" for name in ("setup", *SPLIT, "evaluation"))


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
    from lidar_slam_tpu_torch.ops.cuda.ndt_fused import STENCIL_OFFSETS
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
            res["call"] = (args, kw)
            res["grid"] = N.grid(len(STENCIL_OFFSETS[stencil]))
            res["split"] = newton_split(lambda stamps: N.ndt_newton(*args, **kw, stamps=stamps), cfg.max_iter,
                                        frame.points.device)
            log(f"[newton {stencil}] grid: {res['grid']['blocks']} blocks ({res['grid']['blocks_per_sm']} an SM x "
                f"{res['grid']['sms']} SMs) in clusters of {res['grid']['cluster']} ({res['grid']['clusters']} "
                f"resident at once)")
            log(f"[newton {stencil}] frame 0 split, us an evaluation (mean of 20 stamped launches, "
                f"{res['split']['evaluations']} evaluations each, timer tick {res['split']['tick_ns']} ns): "
                f"{split_text(res['split'])}")
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


def scan_match_config():
    """Phases 3-5 and 8-9 (bench.py:164-191, 315-332): the scan-match
    operating point, 1 m NDT voxels on a 256 x 256 x 64 grid, 65 536 compact
    voxels, the fused gather."""
    from lidar_slam_tpu_torch.models.registration import NDTConfig

    return NDTConfig(
        resolution=1.0, grid_dims=(256, 256, 64), point_chunk=8192, max_iter=30,
        stencil="direct7", gather="fused", max_compact_voxels=65536, fused_window=512,
    )


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

    stems = ("ndt_fused", "ndt_newton", "knn_fused", "ndt_gather", "pose_pcg")
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
    stack_corner, stack_surf, _ = downsample_stacks(f.less_sharp, f.less_flat, mapping)
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
    """Phase 8: a map build's key-order check makes no host sync; K3
    against its plain version on phase 3's NDT map and one
    frame's voxel ids (gather_cases), both entries: the presorted one on the
    map's keys (one kernel, no sort, no host sync) and the general one,
    which sorts the keys first. Exact. Returns {stencil: fields of the
    kernels line}: both entries' device times (CUDA events), the kernel's
    alone (torch.profiler), the plain version's, the bound."""
    import torch

    from lidar_slam_tpu_torch.models.registration import empty_ndt_sums, finalize_ndt_sums, scatter_to_sums
    from lidar_slam_tpu_torch.ops.cuda import ndt_gather

    ndt_map, cases = gather_cases(workload, cfg)
    keys, table = ndt_map.keys, ndt_map.packed
    # every map build ends with the keys' order check (a device-side assert): no host sync
    map_cloud = workload[0]
    sums = scatter_to_sums(empty_ndt_sums(ndt_map.origin, cfg, device=keys.device), map_cloud.points,
                           map_cloud.mask, map_cloud.get_weights())
    track_cfg = dataclasses.replace(cfg, dense_stats=False)
    finalize_ndt_sums(sums, track_cfg)
    with counting_syncs() as syncs:
        rebuilt = finalize_ndt_sums(sums, track_cfg)
    check(syncs[0] == 0 and torch.equal(rebuilt.keys, keys),
          f"K3: a map build with its key-order check made {syncs[0]} host syncs (keys equal: "
          f"{torch.equal(rebuilt.keys, keys)})")
    log("[parity K3] a map build (finalize_ndt_sums, its key-order check included): no host sync")
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
        res["call"] = (args, kw)
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


def pose_pcg_work(asm, steps):
    """Bytes and fp32 FLOPs the PCG kernel's solve needs on these blocks in
    `steps` working steps: every valid edge's and prior's blocks, the
    lists, the edge ends and the free mask read once, x written once; the
    node sums and inverses once, then a step's matvec (D_n p_n and both
    off-diagonal products of each valid edge), the preconditioner, the
    three dot products and the three vector updates."""
    n_e, n_p = int(asm["Hii"].abs().sum((1, 2)).gt(0).sum()), int(asm["Hp"].abs().sum((1, 2)).gt(0).sum())
    n, f = asm["n"], int(asm["free"].sum())
    n_bytes = n_e * (3 * 144 + 2 * 24 + 8) + n_p * (144 + 24) + 4 * (2 * n_e + n_p) + 4 * (n + 1) + n + 24 * n
    setup = (2 * n_e + n_p) * 42 + f * 300
    per_step = 2 * 36 * f + 2 * 2 * 36 * n_e + 2 * 36 * f + 3 * 2 * 6 * f + 3 * 2 * 6 * f + 2 * 6 * f
    return n_bytes, setup + steps * per_step


def pose_pcg_phase(dev, smi):
    """Phase 23: the PCG kernel (ops/cuda/pose_pcg.py) at the benchmark
    cell's graph (bench.shuttle_graph: 540 nodes, 629 edges, 540 priors at
    the back end's capacities 2 048 / 4 096 / 2 048; BackEndConfig's
    optimizer) after two LM iterations: x against `_solve_pcg` (both held
    to `_solve_pcg` in float64: the kernel's error at most three times the
    float32 plain version's plus 1e-6 of the largest |x|), the same working
    steps, two launches equal to the bit, no host sync; the kernel's device
    ms (CUDA events; alone: torch.profiler) beside `_solve_pcg`'s and its
    bound; launches on each path, and one an LM iteration in
    `optimize_pose_graph`."""
    import torch

    from lidar_slam_tpu_torch.models import graph_optimizer as G
    from lidar_slam_tpu_torch.ops.cuda import pose_pcg
    from lidar_slam_tpu_torch.pipeline.back_end import BackEndConfig

    cfg = BackEndConfig().optimizer
    b = G.PoseGraphBuilder(2048, 4096, 2048, device=dev)
    shuttle_graph(b, np.random.default_rng(0))
    graph, _ = G.optimize_pose_graph(b.to_graph(), dataclasses.replace(cfg, max_iterations=2))
    asm = G._assemble(graph, cfg)
    lam = torch.full((), cfg.lm_lambda_init, device=dev)
    lists = pose_pcg.incidence(graph.edge_ij, graph.edge_valid, graph.prior_node, graph.prior_valid, asm["n"])
    grad = G._gradient(asm)

    def kernel(count=None):
        return pose_pcg.pose_pcg(asm, graph.edge_ij, lists, lam, cfg.pcg_tol, cfg.pcg_iters, count)

    def plain(count=None):
        return G._solve_pcg(asm, lam, grad, cfg, active_steps=count)

    ck, cp = torch.zeros((), device=dev), torch.zeros((), device=dev)
    with counting_syncs() as syncs:
        xk = kernel(ck)
    xk2, xp = kernel(), plain(cp)
    asm64 = {k: (v.double() if torch.is_tensor(v) and v.is_floating_point() else v) for k, v in asm.items()}
    x64 = G._solve_pcg(asm64, lam.double(), G._gradient(asm64), cfg)
    scale = float(x64.abs().max())
    err_k, err_p = float((xk.double() - x64).abs().max()), float((xp.double() - x64).abs().max())
    steps = int(ck)
    ms = device_ms(kernel)
    plain_ms = device_ms(plain, reps=3)
    events = [v for k, v in device_events(kernel).items() if "pose_pcg" in k]
    # a launch's own device time; a profiler window may drop a launch's record
    alone = sum(us for _, us in events) / max(sum(c for c, _ in events), 1) / 1e3
    plain_events = device_events(plain, reps=1)
    plain_launches = sum(c for c, _ in plain_events.values())
    n_bytes, flops = pose_pcg_work(asm, steps)
    bound_ms, bound_by = bound(n_bytes, flops)
    launches = pose_pcg.launches
    pose_pcg.launches = 0
    _, st = G.optimize_pose_graph(graph, cfg)
    launches_solve = pose_pcg.launches
    log(f"[pose_pcg] {steps} working steps (plain {int(cp)}); |x - x64| {err_k:.3e} (plain {err_p:.3e}) of "
        f"|x64| {scale:.3e}; two launches equal: {bool(torch.equal(xk, xk2))}; {syncs[0]} host syncs; device "
        f"{ms:.4f} ms a solve (alone {alone:.4f}), {1e3 * ms / max(steps, 1):.2f} us a step; _solve_pcg {plain_ms:.2f} "
        f"ms, {plain_launches} launches; bound {bound_ms:.6f} ms ({bound_by}: {n_bytes / 1e6:.3f} MB, "
        f"{flops / 1e6:.2f} MFLOP); optimize_pose_graph: {launches_solve} launches in {st['iterations']} LM "
        f"iterations ({smi})")
    check(steps == int(cp), f"pose_pcg: {steps} working steps, _solve_pcg {int(cp)}")
    check(err_k <= 3.0 * err_p + 1e-6 * scale, f"pose_pcg: x off by {err_k} (plain {err_p}, |x| {scale})")
    check(torch.equal(xk, xk2), "pose_pcg: two launches differ")
    check(syncs[0] == 0, f"pose_pcg: {syncs[0]} host syncs in a solve")
    check(launches_solve == st["iterations"], f"pose_pcg: {launches_solve} launches in {st['iterations']} iterations")
    return {"launches": launches + launches_solve, "launches_solve": launches_solve,
            "iterations": st["iterations"], "max_abs_err": err_k, "plain_max_abs_err": err_p, "steps": steps,
            "ms": ms, "alone_ms": alone, "plain_ms": plain_ms, "plain_launches": plain_launches,
            "bound_ms": bound_ms, "bound_by": bound_by}


def plain_pcg_solve(graph, cfg):
    """`optimize_pose_graph` with `_solve_pcg` in the PCG kernel's place:
    the single-rank plain PCG, which the edge-sharded solve runs on each
    rank (on the card `optimize_pose_graph` launches the kernel)."""
    from lidar_slam_tpu_torch.models import graph_optimizer as G

    def step(poses, lam):
        asm = G._assemble(dataclasses.replace(graph, poses=poses), cfg)
        return G._solve_pcg(asm, lam, G._gradient(asm), cfg)

    poses, stats = G.levenberg_marquardt(
        graph.poses, graph.node_valid & ~graph.node_fixed, step,
        lambda poses: G.graph_chi2(dataclasses.replace(graph, poses=poses), cfg), cfg)
    return dataclasses.replace(graph, poses=poses), stats


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
            res["call"], res["coarse_call"] = calls["fine"], calls["coarse"]
            res["coarse_ms"] = device_ms(lambda: N.ndt_newton(*c_args, **c_kw), reps=20)
            log(f"[matching newton] {int(frame.mask.sum())} frame points x {int((ndt_map.keys >= 0).sum())} voxels "
                f"({cfg.stencil}, {'x'.join(map(str, ndt_map.dims))} grid): ndt_newton {res['ms']:.4f} ms an "
                f"alignment of {res['iterations']} iterations, plain {res['plain_ms']:.2f} ms (device, median); "
                f"bound {res['bound_ms']:.5f} ms ({n_bytes} B, {flops} FLOP in {len(trace)} evaluations: "
                f"{res['bound_by']}); coarse alignment {res['coarse_ms']:.4f} ms")
    return guess


def save_matching_run(path, cfg, traj, frames, gmap, poses, warm, loaded, origins, device):
    """Phase 15's inputs and the port's answers for matching_witness.py
    (.npz): the MatchingConfig's fields (JSON), the truth [F, 4, 4], each
    frame's raw points and mask, the global map's points, the FullPose
    init pose (the first truth pose), the port's Matching.update pose of
    every frame and its position error to the truth, and the first frame
    the pose-error guard covers (the frames before it warm up). Also the
    port's own inputs to each frame's alignment, for `matching_witness.py
    --split`: its motion-model guess (Matching.update's, recomputed from
    the poses), the GPF non-ground mask of its raw rows and the downsampled
    frame (`matching._frame`, recomputed on `device` from `loaded`), the
    centre of the local map each frame was aligned against (`origins`) and
    each such local map's cloud (the crop, voxel filtered: a Matching's
    reset_local_map at that centre, on `device`)."""
    import torch

    from lidar_slam_tpu_torch.models.ground_seg import GroundSegConfig, segment_ground
    from lidar_slam_tpu_torch.ops.pointcloud import PointCloud, finite_mask
    from lidar_slam_tpu_torch.pipeline import matching as M

    centres, index = np.unique(np.stack(origins).astype(np.float32), axis=0, return_inverse=True)
    local = M.Matching(cfg, gmap, device=device)
    clouds = []
    for c in centres:
        local.reset_local_map(c)
        clouds.append((local._local_cloud.points.cpu().numpy(), local._local_cloud.mask.cpu().numpy()))

    poses = np.stack([np.asarray(p, np.float32) for p in poses])
    errs = np.linalg.norm(poses[:, :3, 3] - np.asarray(traj)[:len(poses), :3, 3], axis=1)
    cur, step, predicts = np.asarray(traj[0], np.float32), np.eye(4, dtype=np.float32), []
    for pose in poses:
        predicts.append(cur @ step)
        step, cur = (np.linalg.inv(cur) @ pose).astype(np.float32), pose
    nonground, ds_pts, ds_msk = [], [], []
    for pts, msk in loaded[:len(poses)]:
        mm = msk & finite_mask(pts)
        nonground.append(segment_ground(PointCloud(points=torch.where(mm[:, None], pts, 0.0), mask=mm),
                                        GroundSegConfig())[1].cpu().numpy())
        f = M._frame(pts, msk, cfg)
        ds_pts.append(f.points.cpu().numpy())
        ds_msk.append(f.mask.cpu().numpy())
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path, config=json.dumps(dataclasses.asdict(cfg)), gt=np.asarray(traj, np.float32)[:len(poses)],
        frames_pts=np.stack([np.asarray(f[0], np.float32) for f in frames]),
        frames_msk=np.stack([np.asarray(f[1], bool) for f in frames]), global_map=np.asarray(gmap, np.float32),
        init_pose=np.asarray(traj[0], np.float32), port_poses=poses, port_errors=errs.astype(np.float32),
        guard_from=np.int64(warm), port_predicts=np.stack(predicts), port_nonground=np.stack(nonground),
        port_frame_pts=np.stack(ds_pts), port_frame_msk=np.stack(ds_msk),
        port_local_origins=centres, port_local_index=index.reshape(-1).astype(np.int64),
        port_local_pts=np.stack([c[0] for c in clouds]), port_local_msk=np.stack([c[1] for c in clouds]),
    )


def matching_phase(dev, smi, matching_out=None):
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
    stall (reset_local_map). With `matching_out`, saves the inputs and the
    Matching.update poses of every frame (save_matching_run). Returns the
    kernels-line fields."""
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
    warm_launches, warm_poses, origins = 0, [], []
    for i in range(MATCH_WARM):
        frame = M._frame(*loaded[i], cfg)
        kernel_pose = matching_kernel_parity(m, frame, m.current_pose @ m.predict_step, res)
        before = N.launches
        origins.append(m.local_map_origin.copy())
        pose = m.update(None, preloaded=loaded[i])
        warm_launches += N.launches - before
        warm_poses.append(pose)
        check(np.array_equal(pose, kernel_pose.astype(np.float32)),
              f"matching frame {i}: Matching.update's pose is not the kernel's")
    for level in ("coarse", "fine"):
        gaps, iters, plain_iters = zip(*res[level])
        check_poses(f"matching newton {level}", "radius27", gaps, iters, plain_iters, cfg.ndt.trans_eps)

    reset_launches()
    with counting_syncs() as syncs:
        t0 = time.perf_counter()
        poses = []
        for i in range(MATCH_WARM, MATCH_FRAMES):
            origins.append(m.local_map_origin.copy())
            poses.append(m.update(None, preloaded=loaded[i]))
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
    if matching_out:
        save_matching_run(matching_out, cfg, traj, frames, gmap, warm_poses + poses, MATCH_WARM, loaded, origins, dev)
        log(f"[matching] inputs and the {len(warm_poses + poses)} Matching.update poses saved to {matching_out}")

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


# Phase 18, the CLI from disk: the bounds of the JAX package's own CLI tests
CLI_GNSS_NOISE = 0.10  # the written drive's GNSS position noise, m (tests/test_kitti_e2e.py)
CLI_ODOM_ATE = 0.8  # odometry ATE against the anchored truth, m (tests/test_kitti_e2e.py:132)
CLI_OPT_SLACK, CLI_OPT_ATE = 0.02, 0.5  # optimized keyframes against their odometry, m (:155-158)
CLI_RESUME_ATE = 0.05  # a resumed run against the uninterrupted one, m (tests/test_cli.py:137)
# The mapping process is killed once this many frames are done: past the hairpin's turn, whose entry
# and exit (frames 60 and 76) change the speed five-fold in one frame. The constant-velocity motion
# model then predicts up to 0.8 m off, and whether the front end holds there turns on float32
# rounding (on an H100 the radius27 front end lost up to 1.51 m at frames 76-80 of this drive in
# every uninterrupted run and held there in a run resumed at frame 67), so a resumed run that crossed
# it would compare that coin flip, not the restore. The uninterrupted run's largest frame error is
# logged.
CLI_KILL_AT = 90
CLI_ALOAM_ATE = 1.0  # `mapping --front-end aloam` ATE, m (tests/test_cli.py:52)
CLI_ALOAM_FRAMES = 12
# `matching` is checked over the hairpin's outbound leg (session_workload's n_out), a straight drive
# as in phase 15: at the turn's exit the trajectory's speed jumps from 0.2 to 1 m a frame, the motion
# model predicts 0.8 m short, and both packages' Matching lose track there (the whole drive's error
# is logged)
CLI_MATCH_FRAMES = 60


def cli_config_text():
    """Phase 18's config file: the front_end, back_end and matching sections
    at configs/kitti_hdl64.yaml's values, the loop_closing section at
    loop_config()'s (kitti_hdl64.yaml's diff_num: 100 would close no loop on
    a 132-frame drive). The front end's ndt section also names gather: auto,
    its FrontEndConfig default: a nested section is built from NDTConfig's
    own defaults, so kitti_hdl64.yaml's section alone sets gather
    "two_level", the plain reduction in a host loop, and no ndt_newton."""
    return """# chip_smoke.py phase 18: configs/kitti_hdl64.yaml, loop closing at bench.py's loop_verify_leg
front_end:
  ndt:
    resolution: 1.0
    step_size: 0.1
    trans_eps: 0.01
    max_iter: 30
    outlier_ratio: 0.55
    grid_dims: [256, 256, 64]
    gather: auto   # the FrontEndConfig default
  frame_leaf: 0.5
  local_map_leaf: 0.3
  key_frame_distance: 2.0
  local_frame_num: 20
back_end:
  key_frame_distance: 2.0
  optimize_step_with_loop: 10
  optimize_step_with_gnss: 100
  optimize_step_with_key_frame: 100
loop_closing:
  loop_step: 1
  diff_num: 20
  sc:
    num_exclude_recent: 20
matching:
  box_size: 200.0
"""


def write_cli_drive(root, gt, scans):
    """Phase 18's drive on disk, with the port's KITTI writer: phase 13's
    session (session_workload: the finite returns of each scan) with a
    truck's returns added (a 4 x 2 x 2 m box driving down the corridor at
    0.8 m/s, 200 surface points a frame within the scans' 2-80 m range), so
    that the detector-box channel carries real boxes (bboxes_for), and GNSS
    poses with the truth's rotation and a seeded CLI_GNSS_NOISE position
    noise. Beside the raw *_sync drive, odometry-layout views of it (the
    same .bin files, linked, and the truth in the raw reader's frame, the
    ENU frame of the first GNSS fix, which the map is built in): KITTI raw
    carries no truth, so `matching` reports its error over these, sequence
    00 the first CLI_MATCH_FRAMES frames, 01 the whole drive. Returns
    (drive directory, odometry root, the truth in the reader's frame)."""
    from lidar_slam_tpu_torch.io.kitti_writer import write_kitti_raw_drive
    from lidar_slam_tpu_torch.io.synthetic import SyntheticWorld, bboxes_for

    world = SyntheticWorld.corridor(length=100.0, width=16.0, density=30.0, seed=9)
    world.add_moving_box(center0=(30.0, -3.0, 1.0), size=(4.0, 2.0, 2.0), heading=0.0, velocity=(0.8, 0.0),
                         n_points=200)
    noise = np.random.default_rng(8000).normal(0.0, CLI_GNSS_NOISE, (len(gt), 3))

    def frames():
        for i, (pts, mask) in enumerate(scans):
            t = i * 0.1
            Tinv = np.linalg.inv(gt[i].astype(np.float64))
            box = world.boxes[0].sample_surface(t, np.random.default_rng(7000 + i)) @ Tinv[:3, :3].T + Tinv[:3, 3]
            r = np.linalg.norm(box, axis=1)
            box = box[(r >= 2.0) & (r <= 80.0)].astype(np.float32)
            pose = gt[i].astype(np.float64).copy()
            pose[:3, 3] += noise[i]
            yield {"points": np.concatenate([pts[mask], box]), "pose": pose, "time": t,
                   "bboxes": bboxes_for(world, gt[i], t)}

    drive = write_kitti_raw_drive(os.path.join(root, "raw"), frames())
    truth = gt.astype(np.float64).copy()
    truth[:, :3, 3] -= gt[0, :3, 3] + noise[0]
    odo = os.path.join(root, "odometry")
    os.makedirs(os.path.join(odo, "poses"))
    for seq, n in (("00", CLI_MATCH_FRAMES), ("01", len(gt))):
        velo = os.path.join(odo, "sequences", seq, "velodyne")
        os.makedirs(velo)
        for i in range(n):
            os.link(os.path.join(drive, "velodyne_points", "data", f"{i:010d}.bin"), os.path.join(velo, f"{i:06d}.bin"))
        np.savetxt(os.path.join(odo, "sequences", seq, "times.txt"), np.arange(n) * 0.1)
        np.savetxt(os.path.join(odo, "poses", f"{seq}.txt"), truth[:n, :3, :].reshape(n, 12), fmt="%.9g")
    return drive, odo, truth


def run_cli(argv, serial=False):
    """lidar_slam_tpu_torch.cli.main(argv) in-process, its standard output
    captured; `serial` replaces the prefetch thread by reading each frame on
    the main thread. Returns (exit code, output, the LoopClosing objects
    made, seconds: the frame loop (from the first frame's request to the
    final solve), the final solve, the rest (the map save), and the solves
    the frame loop ran)."""
    import io

    import lidar_slam_tpu_torch.pipeline as pipeline
    from lidar_slam_tpu_torch import cli

    made, stamps, solves = [], {}, []
    base_lc, base_be = pipeline.LoopClosing, pipeline.BackEnd
    base_prefetch, base_source = cli._prefetch, cli._frame_source

    class RecordingLoops(base_lc):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    class TimedBackEnd(base_be):
        def _optimize(self):
            t0 = time.perf_counter()
            out = super()._optimize()
            solves.append(time.perf_counter() - t0)
            return out

        def force_optimize(self):
            stamps["solve"] = time.perf_counter()
            out = super().force_optimize()
            stamps["saved"] = time.perf_counter()
            return out

    def timed_source(args):
        source = base_source(args)
        stamps["first"] = time.perf_counter()
        yield from source

    out = io.StringIO()
    pipeline.LoopClosing, pipeline.BackEnd, cli._frame_source = RecordingLoops, TimedBackEnd, timed_source
    if serial:
        cli._prefetch = lambda source, depth=4: iter(source)
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        end = time.perf_counter()
    finally:
        pipeline.LoopClosing, pipeline.BackEnd = base_lc, base_be
        cli._prefetch, cli._frame_source = base_prefetch, base_source
    secs = {}
    if "solve" in stamps:
        secs = {"loop": stamps["solve"] - stamps["first"], "solve": stamps["saved"] - stamps["solve"],
                "save": end - stamps["saved"], "solves_in_loop": solves[:-1]}
    return rc, out.getvalue(), made, secs


def cli_line(text, prefix):
    lines = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    check(lines, f"cli: no '{prefix}' line in:\n{text[-3000:]}")
    return lines[-1]


def cli_metres(text, prefix):
    return float(cli_line(text, prefix).split(":")[1].split("m")[0])


def cli_run_stats(text):
    """From a mapping run's output: frames, keyframes, loops, wall seconds
    (the mapping-done line) and the run-health summary."""
    done = cli_line(text, "mapping done:")
    frames, secs = done.split(":")[1].split(" frames in ")
    kfs, loops = done.split("fps), ")[1].split(" keyframes, ")
    health = json.loads(cli_line(text, "run health:").split(":", 1)[1])
    return {"frames": int(frames), "seconds": float(secs.split("s")[0]), "keyframes": int(kfs),
            "loops": int(loops.split(" loops")[0]), "health": health}


def stage_ms(health, name):
    st = health["stages"].get(name, {"calls": 0, "mean_ms": 0.0})
    return st["calls"] * st["mean_ms"]


def cli_phase(work, gt, scans, smi, extra=()):
    """Phase 18: the port's CLI from KITTI files on disk. Writes the drive
    (write_cli_drive) and the config (cli_config_text), then:
    `mapping --kitti-raw` in-process (exit 0, a loop closed, 132 frames in
    laser_odom.txt, odometry ATE under CLI_ODOM_ATE, the optimized keyframes
    within CLI_OPT_SLACK of their odometry's ATE and under CLI_OPT_ATE, a
    filtered map of more than 1000 points, two ndt_newton launches a frame
    and one a verification attempt, K1 and K3 none); the same run with the
    frames read on the main thread (what the prefetch thread overlaps);
    `python3 -m lidar_slam_tpu_torch mapping` killed once its progress file
    shows CLI_KILL_AT frames done, then `--resume`d (`resumed:` printed, every
    frame in the stitched trajectory, within CLI_RESUME_ATE of the
    uninterrupted run); `matching --kitti-raw` as a subprocess (exit 0) and
    `matching --kitti-odometry` in-process over the drive's outbound leg
    (its `localization mean error:` under MATCH_GUARD, two ndt_newton
    launches a localized frame) and over the whole drive (logged); `mapping --synthetic CLI_ALOAM_FRAMES
    --front-end aloam` in-process (`ATE vs ground truth:` under
    CLI_ALOAM_ATE, K2_PER_SWEEP K2 launches a sweep); `inspect` over the
    drive (`inspect: OK`). `extra` is appended to every command line.
    Returns the kernels-line fields."""
    import signal

    import torch

    from lidar_slam_tpu_torch.io.trajectory import ate_rmse, read_kitti_trajectory
    from lidar_slam_tpu_torch.ops.cuda import knn_fused, ndt_fused, ndt_gather, ndt_newton

    repo = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    drive, odo_root, truth = write_cli_drive(os.path.join(work, "kitti"), gt, scans)
    cfg = os.path.join(work, "config.yaml")
    with open(cfg, "w") as f:
        f.write(cli_config_text())
    log(f"[cli] drive of {len(scans)} frames written in {time.perf_counter() - t0:.1f} s ({drive})")
    src = ["--kitti-raw", drive, "--config", cfg, *extra]
    n = len(scans)

    # mapping, in-process: the launches of its kernels counted
    out_a = os.path.join(work, "map")
    reset_launches()
    rc, text, lcs, secs = run_cli(["mapping", *src, "--out", out_a])
    launches, k1, k3 = ndt_newton.launches, ndt_fused.launches, ndt_gather.launches
    check(rc == 0, f"cli mapping: exit {rc}")
    run = cli_run_stats(text)
    attempts = sum(lc.attempts for lc in lcs)
    for ln in text.splitlines():
        if ln.startswith(("loop closure:", "mapping done:", "kernels:")):
            log(f"[cli mapping] {ln}")
    odom = read_kitti_trajectory(os.path.join(out_a, "trajectory", "laser_odom.txt"))
    check(len(odom) == n, f"cli mapping: laser_odom.txt holds {len(odom)} frames, expected {n}")
    ate_odo = ate_rmse(odom, truth)
    frame_err = np.linalg.norm(odom[:, :3, 3] - np.einsum("ij,njk->nik", np.linalg.inv(truth[0]), truth)[:, :3, 3], axis=1)
    opt = read_kitti_trajectory(os.path.join(out_a, "trajectory", "optimized.txt"))
    kf_dir = os.path.join(out_a, "key_frames")
    kf_idx = []
    for k in range(run["keyframes"]):
        with np.load(os.path.join(kf_dir, f"key_frame_{k}.npz"), allow_pickle=True) as z:
            kf_idx.append(int(round(float(z["time"]) / 0.1)))
    check(len(opt) == len(kf_idx), f"cli mapping: {len(opt)} optimized poses for {len(kf_idx)} keyframes")
    ate_opt, ate_kf = ate_rmse(opt, truth[kf_idx]), ate_rmse(odom[kf_idx], truth[kf_idx])
    with np.load(os.path.join(out_a, "map", "filtered_map.npz")) as z:
        n_map = len(z["points"])
    # the back half: the frame loop's wall less the front end's stage (BackEnd.update, LoopClosing, the
    # solves a loop insertion starts, which no stage of the run health covers, and the progress files)
    h = run["health"]
    loop_ms = stage_ms(h, "front_end") + stage_ms(h, "back_end") + stage_ms(h, "loop_closing")
    back_ms = secs["loop"] * 1e3 - stage_ms(h, "front_end")
    log(f"[cli mapping] {n} frames from disk: the frame loop {secs['loop'] * 1e3 / n:.2f} ms a frame of wall "
        f"(stages: front end {stage_ms(h, 'front_end') / n:.2f}, all {loop_ms / n:.2f}), then the final solve "
        f"{secs['solve']:.2f} s and the map save {secs['save']:.2f} s; back half {back_ms / run['keyframes']:.2f} ms "
        f"a keyframe of wall (stages {(loop_ms - stage_ms(h, 'front_end')) / run['keyframes']:.2f}; the pose-graph "
        f"solves in the loop {[round(t, 3) for t in secs['solves_in_loop']]} s); "
        f"{run['keyframes']} keyframes, {run['loops']} loops, {attempts} verification attempts; ATE "
        f"odometry {ate_odo:.4f} m (a frame's error to the truth: mean {frame_err.mean():.4f}, max "
        f"{frame_err.max():.4f} m at frame {int(frame_err.argmax())}), keyframes odometry {ate_kf:.4f} -> optimized "
        f"{ate_opt:.4f} m; filtered map {n_map} points; ndt_newton {launches} launches in {2 * (n - 1) + attempts} "
        f"alignments, K1 {k1}, K3 {k3} ({smi})")
    log(f"[cli mapping] run health: {json.dumps(h)} ({smi})")
    check("loop closure:" in text, "cli mapping: no loop closed")
    check(ate_odo < CLI_ODOM_ATE, f"cli mapping: odometry ATE {ate_odo} m")
    check(ate_opt <= ate_kf + CLI_OPT_SLACK and ate_opt < CLI_OPT_ATE,
          f"cli mapping: optimized keyframe ATE {ate_opt} m against their odometry's {ate_kf} m")
    check(n_map > 1000, f"cli mapping: filtered map of {n_map} points")
    check(launches == 2 * (n - 1) + attempts,
          f"cli mapping: {launches} ndt_newton launches in {2 * (n - 1) + attempts} alignments")
    check(k1 == 0 and k3 == 0, f"cli mapping: K1 launched {k1} times, K3 {k3}")

    # the same run with every frame read and uploaded on the main thread
    rc_s, text_s, _, secs_s = run_cli(["mapping", *src, "--out", os.path.join(work, "serial")], serial=True)
    check(rc_s == 0, f"cli mapping without the prefetch thread: exit {rc_s}")
    run_s = cli_run_stats(text_s)
    hs = run_s["health"]
    loop_s = stage_ms(hs, "front_end") + stage_ms(hs, "back_end") + stage_ms(hs, "loop_closing")
    log(f"[cli prefetch] the frame loop's wall with the prefetch thread {secs['loop'] * 1e3 / n:.2f} ms a frame "
        f"(stages {loop_ms / n:.2f}), with every frame read and uploaded on the main thread "
        f"{secs_s['loop'] * 1e3 / n:.2f} (stages {loop_s / n:.2f}); final solve {secs_s['solve']:.2f} s ({smi})")

    # a mapping process killed half way, then resumed
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    cmd = [sys.executable, "-m", "lidar_slam_tpu_torch", "mapping", *src, "--out", os.path.join(work, "killed")]
    progress = os.path.join(work, "killed", "progress.json")
    t0 = time.perf_counter()
    with open(os.path.join(work, "killed.log"), "w") as logf:
        proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT, env=env, cwd=repo)
        done = 0
        try:
            while time.perf_counter() - t0 < 300 and proc.poll() is None:
                try:
                    with open(progress) as f:
                        done = json.load(f)["frames_done"]
                except (OSError, ValueError, KeyError):
                    done = 0
                if done >= CLI_KILL_AT:
                    break
                time.sleep(0.05)
        finally:
            alive = proc.poll() is None
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=60)
    check(alive and done >= CLI_KILL_AT, f"cli resume: the run was not killed mid-run ({done} frames done, "
          f"exit {proc.returncode}): {open(os.path.join(work, 'killed.log')).read()[-2000:]}")
    r = subprocess.run([*cmd, "--resume"], capture_output=True, text=True, env=env, cwd=repo, timeout=600)
    check(r.returncode == 0, f"cli resume: exit {r.returncode}: {r.stdout[-2000:]}{r.stderr[-2000:]}")
    check("resumed:" in r.stdout, f"cli resume: no 'resumed:' line: {r.stdout[-2000:]}")
    stitched = read_kitti_trajectory(os.path.join(work, "killed", "trajectory", "laser_odom.txt"))
    check(len(stitched) == n, f"cli resume: the stitched laser_odom.txt holds {len(stitched)} frames")
    ate_res = ate_rmse(stitched, odom, align=False)
    log(f"[cli resume] killed with {done} of {n} frames done, {cli_line(r.stdout, 'resumed:')}; the stitched "
        f"trajectory {ate_res:.5f} m ATE from the uninterrupted run; {time.perf_counter() - t0:.1f} s for both "
        f"processes ({smi})")
    check(ate_res < CLI_RESUME_ATE, f"cli resume: {ate_res} m from the uninterrupted run")

    # localization in the map: the raw drive as a user runs it, then the
    # odometry view, which carries the truth
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "lidar_slam_tpu_torch", "matching", *src, "--map", out_a],
                       capture_output=True, text=True, env=env, cwd=repo, timeout=600)
    check(r.returncode == 0, f"cli matching: exit {r.returncode}: {r.stdout[-2000:]}{r.stderr[-2000:]}")
    log(f"[cli matching] --kitti-raw: exit 0, {r.stdout.count('frame ')} pose lines, "
        f"{time.perf_counter() - t0:.1f} s of process wall")
    for seq in ("00", "01"):
        reset_launches()
        t0 = time.perf_counter()
        rc, text, _, _ = run_cli(["matching", "--kitti-odometry", f"{odo_root}:{seq}", "--config", cfg, *extra,
                               "--map", out_a])
        check(rc == 0, f"cli matching --kitti-odometry {seq}: exit {rc}")
        line = cli_line(text, "localization mean error:")
        err, n_loc = cli_metres(text, "localization mean error:"), int(line.split(" over ")[1].split()[0])
        what = "the outbound leg" if seq == "00" else "the whole hairpin (not checked: see CLI_MATCH_FRAMES)"
        log(f"[cli matching] --kitti-odometry, {what}: {line}; {ndt_newton.launches} ndt_newton launches; "
            f"{(time.perf_counter() - t0) * 1e3 / (n_loc + 1):.2f} ms a frame of wall with the map's load ({smi})")
        if seq == "00":
            launches_m = ndt_newton.launches
            check(err < MATCH_GUARD, f"cli matching: mean error {err} m")
            check(launches_m == 2 * n_loc, f"cli matching: {launches_m} ndt_newton launches in {n_loc} frames")

    # A-LOAM through the CLI
    reset_launches()
    t0 = time.perf_counter()
    rc, text, _, _ = run_cli(["mapping", "--synthetic", str(CLI_ALOAM_FRAMES), "--front-end", "aloam",
                           "--config", os.path.join(repo, "configs", "synthetic_small.yaml"), *extra,
                           "--out", os.path.join(work, "aloam")])
    launches_k2 = knn_fused.launches
    check(rc == 0, f"cli aloam: exit {rc}")
    ate_aloam = cli_metres(text, "ATE vs ground truth:")
    log(f"[cli aloam] {cli_line(text, 'mapping done:')}; ATE {ate_aloam:.4f} m; K2 {launches_k2} launches in "
        f"{CLI_ALOAM_FRAMES} sweeps; {time.perf_counter() - t0:.1f} s with the sweeps' simulation ({smi})")
    check(ate_aloam < CLI_ALOAM_ATE, f"cli aloam: ATE {ate_aloam} m")
    check(launches_k2 == K2_PER_SWEEP * CLI_ALOAM_FRAMES,
          f"cli aloam: {launches_k2} K2 launches in {CLI_ALOAM_FRAMES} sweeps")

    rc, text, _, _ = run_cli(["inspect", "--kitti-raw", drive, *extra])
    check(rc == 0 and "inspect: OK" in text, f"cli inspect: exit {rc}: {text[-2000:]}")
    log(f"[cli inspect] {text.count('frame ')} frames, inspect: OK")
    log(f"[cli] phase 18: {time.perf_counter() - t_phase:.1f} s ({smi})")
    return {"launches": launches + launches_m, "launches_mapping": launches, "launches_matching": launches_m,
            "launches_aloam": launches_k2}


def converged_gap(res, ref):
    """(the largest pose gap, m or rad, over the alignments that converged in
    both lists of results, how many did)."""
    both = [(a, b) for a, b in zip(res, ref) if a.converged and b.converged]
    gaps = [max(pose_gap(a.pose.numpy(), b.pose.numpy())) for a, b in both]
    return max(gaps, default=0.0), len(both)


def mesh_phase(workload, loaded, traj, smi, parallel_out=None):
    """Phase 19 (see the module docstring): mesh_rank on one rank under
    NCCL, then on two gloo ranks sharing the card; the inputs go to the
    ranks as host arrays. With `parallel_out`, rank 0 of the two saves the
    local map's inputs and both maps there (save_local_maps). Returns
    {world size: rank 0's results}."""
    import torch

    from lidar_slam_tpu_torch.parallel.launch import launch

    map_cloud, all_pts, all_msk, gt, guess0 = workload
    inputs = dict(
        map_pts=map_cloud.points[map_cloud.mask].cpu().numpy(), frames_pts=all_pts.cpu().numpy(),
        frames_msk=all_msk.cpu().numpy(), gt=gt, guess0=guess0,
        fe_pts=np.stack([p.cpu().numpy() for p, _ in loaded]), fe_msk=np.stack([m.cpu().numpy() for _, m in loaded]),
        fe_traj=traj, parallel_out=parallel_out,
    )
    torch.cuda.empty_cache()
    out = {}
    for world, device in ((1, None), (2, "cuda:0")):
        t0 = time.perf_counter()
        try:
            res = launch("chip_smoke:mesh_rank", world, args=(inputs, smi), device=device, timeout=MESH_TIMEOUT)
        except (RuntimeError, TimeoutError) as e:
            raise CheckFailed(f"phase 19 on {world} rank(s): {e}") from None
        log(f"[mesh {world}] launch, every check and the ranks' exit: {time.perf_counter() - t0:.1f} s ({smi})")
        out[world] = res
    return out


def mesh_rank(mesh, inp, smi):
    """One rank of phase 19. Every rank runs every step (the collectives
    need them all); rank 0 logs and returns the numbers."""
    import torch

    from lidar_slam_tpu_torch.models import graph_optimizer as G
    from lidar_slam_tpu_torch.models.registration import build_ndt_map, ndt_align
    from lidar_slam_tpu_torch.models.registration.ndt import (
        _matrix_to_pose, _reduce, ndt_align_host_loop, ndt_derivatives,
    )
    from lidar_slam_tpu_torch.ops import PointCloud
    from lidar_slam_tpu_torch.ops.cuda import ndt_fused, ndt_newton
    from lidar_slam_tpu_torch.parallel import (
        optimize_pose_graph_schur, optimize_pose_graph_sharded, schur_prepare, sharded_build_local_map,
        sharded_build_ndt_map, sharded_ndt_align, sharded_ndt_derivatives,
    )
    from lidar_slam_tpu_torch.parallel.collectives import all_gather, all_sum, sum_scatter
    from lidar_slam_tpu_torch.parallel.dryrun import dryrun_rank
    from lidar_slam_tpu_torch.parallel.sharded_ndt import _shards
    from lidar_slam_tpu_torch.pipeline import front_end_drive, init_front_end_drive
    from lidar_slam_tpu_torch.pipeline.front_end import _preprocess

    dev, world, lead = mesh.device, mesh.size, mesh.rank == 0
    tag = f"[mesh {world} {mesh.backend}]"
    out = {}

    def say(msg):
        if lead:
            log(f"{tag} {msg} ({smi})")

    def every_rank(n):
        """n from every rank, in rank order."""
        return all_gather(torch.tensor([n], dtype=torch.int64, device=dev), mesh).tolist()

    cfg = dataclasses.replace(tracking_config().ndt, gather="fused")
    cap = -(-len(inp["map_pts"]) // 8) * 8
    map_cloud = PointCloud.from_points(inp["map_pts"], capacity=cap, device=dev)
    ndt_map = build_ndt_map(map_cloud, cfg)
    all_pts = torch.as_tensor(inp["frames_pts"], device=dev)
    all_msk = torch.as_tensor(inp["frames_msk"], device=dev)
    frames = [_preprocess(all_pts[i], all_msk[i], FRAME_CAP, 0.5) for i in range(N_FRAMES)]
    rng = np.random.default_rng(19)
    guesses = []
    for i in range(MESH_FRAMES):
        g = inp["gt"][i].copy()
        g[:3, 3] += rng.normal(0, 0.1, 3).astype(np.float32)
        guesses.append(g)

    # K1 against its plain version on this rank's shard of frame 0's points
    pose6 = _matrix_to_pose(guesses[0])
    sp, sm, sw = _shards(frames[0], mesh)
    shard_points = every_rank(int(sm.sum()))
    check(min(shard_points) > 0, f"{tag}: valid points of frame 0 by rank {shard_points}: a rank has none")
    k = _reduce(ndt_map, sp, sm, sw, pose6, cfg).cpu().numpy()
    p = _reduce(ndt_map, sp, sm, sw, pose6, dataclasses.replace(cfg, gather="two_level")).cpu().numpy()
    rel = []
    for name, sl in (("score", slice(0, 1)), ("grad", slice(1, 7)), ("hess", slice(7, 28))):
        tol = TOL[name]
        check(not (np.abs(k[sl] - p[sl]) > tol["atol"] + tol["rtol"] * np.abs(p[sl])).any(),
              f"{tag} rank {mesh.rank}: K1 {name} on its shard: kernel {k[sl]} vs plain {p[sl]}")
        rel.append(float(np.max(np.abs(k[sl] - p[sl])) / max(float(np.max(np.abs(p[sl]))), 1e-30)))
    out["k1_shard_rel_err"] = max(rel)
    out["k1_shard_points"] = shard_points

    # the derivatives at one pose, and the alignments: K1 once an evaluation
    sd = sharded_ndt_derivatives(ndt_map, frames[0], pose6, cfg, mesh)
    ud = ndt_derivatives(ndt_map, frames[0].points, frames[0].mask, pose6, cfg, True, return_unresolved=True)
    d_gap = max(float(np.max(np.abs(a.numpy() - b.numpy()))) for a, b in zip(sd, ud))
    check(d_gap == 0.0 if world == 1 else d_gap <= TOL["hess"]["atol"] + TOL["hess"]["rtol"] * float(ud[2].abs().max()),
          f"{tag}: sharded derivatives {d_gap} from ndt_derivatives")
    sharded_ndt_align(ndt_map, frames[0], guesses[0], cfg, mesh)  # warm-up (the first collective sets up)
    ndt_fused.launches = ndt_newton.launches = 0
    res = [sharded_ndt_align(ndt_map, frames[i], guesses[i], cfg, mesh) for i in range(MESH_FRAMES)]
    evals = sum(r.iterations + 1 for r in res)
    k1_align = every_rank(ndt_fused.launches)
    check(k1_align == [evals] * world and ndt_newton.launches == 0,
          f"{tag}: K1 launches {k1_align} by rank in {evals} evaluations, ndt_newton {ndt_newton.launches}")
    out["k1_align"], out["evals"] = k1_align, evals
    hl = [ndt_align_host_loop(ndt_map, frames[i], guesses[i], cfg) for i in range(MESH_FRAMES)]
    nn = [ndt_align(ndt_map, frames[i], guesses[i], cfg) for i in range(MESH_FRAMES)]
    gap_hl, n_conv = converged_gap(res, hl)
    gap_nn, _ = converged_gap(res, nn)
    check(n_conv >= MESH_FRAMES // 2, f"{tag}: {n_conv} of {MESH_FRAMES} alignments converged in both runs")
    check(gap_hl <= cfg.trans_eps and gap_nn <= cfg.trans_eps,
          f"{tag}: the sharded alignment {gap_hl} from the host loop, {gap_nn} from ndt_newton")
    if world == 1:
        same = all(np.array_equal(a.pose.numpy(), b.pose.numpy()) for a, b in zip(res, hl))
        check(same, f"{tag}: the sharded alignment is not the host loop's, bit for bit")
        with counting_syncs() as syncs:
            r0 = sharded_ndt_align(ndt_map, frames[0], guesses[0], cfg, mesh)
        events = device_events(lambda: sharded_ndt_align(ndt_map, frames[0], guesses[0], cfg, mesh), reps=1)
        k1_prof = sum(c for name, (c, _) in events.items() if "ndt_fused_kernel" in name)
        check(syncs[0] == r0.iterations + 1 and k1_prof == r0.iterations + 1,
              f"{tag}: {syncs[0]} host syncs and {k1_prof} K1 kernels (torch.profiler) in {r0.iterations + 1} "
              f"evaluations")
        out["syncs"], out["k1_profiler"], out["evals_one"] = syncs[0], k1_prof, r0.iterations + 1

    # the collectives alone, timed directly: an evaluation's [32] sum and its
    # host copy; a map build's [V, 11] sum_scatter and its [V, 19] rows' all_gather
    v = int(np.prod(cfg.grid_dims))
    out["coll_eval_ms"] = host_ms(lambda: all_sum(torch.zeros(32, device=dev), mesh).cpu(), reps=50)
    sums_v = torch.zeros((v, 11), device=dev)
    rows_v = torch.zeros((v // world, 19), device=dev)
    out["coll_scatter_ms"] = host_ms(lambda: sum_scatter(sums_v, mesh), reps=3)
    out["coll_gather_ms"] = host_ms(lambda: all_gather(rows_v, mesh), reps=3)
    del sums_v, rows_v
    say(f"collectives alone (wall ms, median): an evaluation's all_sum of [32] and its host copy "
        f"{out['coll_eval_ms']:.3f}; a map build's sum_scatter of [{v}, 11] {out['coll_scatter_ms']:.1f} and "
        f"all_gather of [{v // world}, 19] a rank {out['coll_gather_ms']:.1f}")

    def per_frame(fn):
        return host_ms(lambda: [fn(ndt_map, frames[i], guesses[i], cfg) for i in range(MESH_FRAMES)], reps=3) / MESH_FRAMES

    out["align_ms"] = per_frame(lambda *a: sharded_ndt_align(*a, mesh))
    out["host_loop_ms"] = per_frame(ndt_align_host_loop)
    out["newton_ms"] = per_frame(ndt_align)
    out["iterations"] = [r.iterations for r in res]
    say(f"valid points of frame 0 by rank {out['k1_shard_points']}; K1 on rank 0's shard against its plain "
        f"version: largest |diff| / largest |plain| of score, gradient, Hessian {out['k1_shard_rel_err']:.3e}; "
        f"derivatives {d_gap:.3e} from ndt_derivatives; {MESH_FRAMES} sharded "
        f"alignments, iterations {out['iterations']}: K1 launches by rank {k1_align} in {evals} evaluations"
        + (f", {out['syncs']} host syncs and {out['k1_profiler']} K1 kernels (torch.profiler) in one alignment of "
           f"{out['evals_one']} evaluations" if world == 1 else "")
        + f"; from the host loop {gap_hl:.2e}, from ndt_newton {gap_nn:.2e} (m / rad, {n_conv} converged); wall "
        f"ms an alignment: "
        f"sharded {out['align_ms']:.3f}, ndt_align_host_loop {out['host_loop_ms']:.3f}, ndt_align (ndt_newton) "
        f"{out['newton_ms']:.3f}")

    # the map builds, against build_ndt_map of the same points
    def map_gaps(m, ref, name, frame):
        """MAP_TOL on the voxel statistics; the inverse covariances through
        their use, an alignment from the same guess on either map."""
        for f in ("valid", "keys", "index"):
            check(torch.equal(getattr(m, f), getattr(ref, f)), f"{tag} {name}: {f} differs from build_ndt_map's")
        gaps = {f: float((getattr(m, f) - getattr(ref, f)).abs().max()) for f in ("count", "mean", "icov", "packed")}
        check(gaps["count"] <= MAP_TOL["count"] and gaps["mean"] <= MAP_TOL["mean"],
              f"{tag} {name}: {gaps} from build_ndt_map's")
        a, b = (ndt_align(mm, frame, guesses[0], cfg) for mm in (m, ref))
        gaps["align"] = max(pose_gap(a.pose.numpy(), b.pose.numpy()))
        check(gaps["align"] <= cfg.trans_eps or not (a.converged and b.converged),
              f"{tag} {name}: an alignment on it {gaps['align']} from one on build_ndt_map's")
        return gaps, all(torch.equal(getattr(m, f), getattr(ref, f)) for f in ("count", "mean", "icov", "packed"))

    reps = 3 if world == 1 else 1
    origin = ndt_map.origin
    m = sharded_build_ndt_map(map_cloud, origin, cfg, mesh)
    gaps, bits = map_gaps(m, build_ndt_map(map_cloud, cfg, origin=origin), "sharded_build_ndt_map", frames[0])
    out["map_ms"] = host_ms(lambda: sharded_build_ndt_map(map_cloud, origin, cfg, mesh), reps=reps)
    out["map_ref_ms"] = host_ms(lambda: build_ndt_map(map_cloud, cfg, origin=origin), reps=reps)
    say(f"sharded_build_ndt_map ({int(map_cloud.mask.sum())} points, {int(m.valid.sum())} valid of "
        f"{int(np.prod(cfg.grid_dims))} voxels): {out['map_ms']:.1f} ms against build_ndt_map's "
        f"{out['map_ref_ms']:.1f} (wall); max |diff| {gaps}, the same bits: {bits}")
    kf = torch.stack([f.points for f in frames])
    kf_m = torch.stack([f.mask for f in frames])
    kf_w = torch.ones(kf_m.shape, device=dev)
    poses = np.asarray(inp["gt"], np.float32)
    res_f = float(cfg.resolution)
    origin_l = (np.floor((poses[N_FRAMES // 2, :3, 3] - 0.5 * np.asarray(cfg.grid_dims, np.float32) * res_f) / res_f)
                * res_f).astype(np.float32)
    valid = np.ones(N_FRAMES, bool)
    lm = sharded_build_local_map(kf, kf_m, kf_w, poses, valid, origin_l, cfg, mesh)
    P = torch.as_tensor(poses, device=dev)
    world_pts = torch.einsum("kij,kpj->kpi", P[:, :3, :3], kf) + P[:, None, :3, 3]
    flat = PointCloud(points=world_pts.reshape(-1, 3), mask=kf_m.reshape(-1), weights=kf_w.reshape(-1))
    gaps_l, bits_l = map_gaps(lm, build_ndt_map(flat, cfg, origin=origin_l), "sharded_build_local_map", frames[0])
    out["local_map_ms"] = host_ms(lambda: sharded_build_local_map(kf, kf_m, kf_w, poses, valid, origin_l, cfg, mesh),
                                  reps=reps)
    say(f"sharded_build_local_map ({N_FRAMES} keyframes x {FRAME_CAP} points, {int(lm.valid.sum())} valid "
        f"voxels): {out['local_map_ms']:.1f} ms (wall); max |diff| {gaps_l}, the same bits: {bits_l}")
    if lead and world == 2 and inp.get("parallel_out"):
        save_local_maps(inp["parallel_out"], (kf, kf_m, kf_w, poses, valid, origin_l), frames[0], guesses[0], cfg,
                        build_ndt_map(flat, cfg, origin=origin_l), lm)
        say(f"the local map's inputs and both maps saved to {inp['parallel_out']}")

    # the pose graphs: phase 12's circles
    rng_g = np.random.default_rng(0)
    b366 = G.PoseGraphBuilder(384, 384, 8, device=dev)
    circle_graph(b366, 366, 60.0, rng_g)
    b2048 = G.PoseGraphBuilder(2048, 2056, 8, device=dev)
    circle_graph(b2048, 2048, 120.0, rng_g)
    cfg_pcg = G.GraphOptimizerConfig(max_iterations=MESH_PCG_ITERS, solver="pcg")
    g = b2048.to_graph()
    go, st = optimize_pose_graph_sharded(g, cfg_pcg, mesh)
    ref, rst = G.optimize_pose_graph(g, cfg_pcg)  # on the card: the PCG kernel
    dpos = float((go.poses[:2048, :3, 3] - ref.poses[:2048, :3, 3]).abs().max())
    if world == 1:
        plain, pst = plain_pcg_solve(g, cfg_pcg)
        dplain = float((go.poses[:2048, :3, 3] - plain.poses[:2048, :3, 3]).abs().max())
        check(torch.equal(go.poses, plain.poses) and st["chi2_after"] == pst["chi2_after"],
              f"{tag}: the edge-sharded PCG is not the single-rank plain PCG, bit for bit ({dplain} m)")
    check(dpos <= GRAPH_TOL["2048 nodes"][0], f"{tag}: the edge-sharded PCG {dpos} m from the single-rank one")
    check(st["chi2_after"] < st["chi2_before"], f"{tag}: the edge-sharded PCG did not lower chi2")
    out["pcg_ms_it"] = host_ms(lambda: optimize_pose_graph_sharded(g, cfg_pcg, mesh), reps=1) / st["iterations"]
    out["pcg_ref_ms_it"] = host_ms(lambda: G.optimize_pose_graph(g, cfg_pcg), reps=1) / rst["iterations"]
    cfg_s = G.GraphOptimizerConfig(max_iterations=MESH_SCHUR_ITERS, solver="dense")
    g366 = b366.to_graph()
    sg = schur_prepare(g366, world, sep_cap=16)
    gs, sst = optimize_pose_graph_schur(sg, cfg_s, mesh)
    sref, srst = G.optimize_pose_graph(g366, cfg_s)
    dpos_s = float((gs.poses[:366, :3, 3] - sref.poses[:366, :3, 3]).abs().max())
    check(dpos_s <= SCHUR_TOL and sst["chi2_after"] < 0.2 * sst["chi2_before"],
          f"{tag}: the Schur solve {dpos_s} m from the dense LM, chi2 {sst['chi2_before']} -> {sst['chi2_after']}")
    out["schur_ms_it"] = host_ms(lambda: optimize_pose_graph_schur(sg, cfg_s, mesh), reps=1) / sst["iterations"]
    out["dense_ms_it"] = host_ms(lambda: G.optimize_pose_graph(g366, cfg_s), reps=1) / srst["iterations"]
    say(f"edge-sharded PCG (2 048 nodes, {st['iterations']} LM iterations, chi2 {st['chi2_before']:.2f} -> "
        f"{st['chi2_after']:.4f}): {out['pcg_ms_it']:.1f} ms an iteration against the single-rank PCG's "
        f"{out['pcg_ref_ms_it']:.1f}, poses {dpos:.2e} m apart; Schur (366 nodes, "
        f"{int(sg.sep_valid.sum())} separators, {sst['iterations']} iterations, chi2 {sst['chi2_before']:.2f} -> "
        f"{sst['chi2_after']:.5f}): {out['schur_ms_it']:.1f} ms an iteration against the dense LM's "
        f"{out['dense_ms_it']:.1f} ({srst['iterations']} iterations), poses {dpos_s:.2e} m apart (wall)")

    # the production drive over phase 6's frames, alignments sharded
    fe_cfg = tracking_config()
    traj = inp["fe_traj"]
    pts_seq = torch.as_tensor(inp["fe_pts"][3:18], device=dev)
    msk_seq = torch.as_tensor(inp["fe_msk"][3:18], device=dev)
    st0 = init_front_end_drive(fe_cfg, init_pose=traj[3], device=dev)
    ndt_fused.launches = ndt_newton.launches = 0
    front_end_drive(st0, pts_seq, msk_seq, fe_cfg, mesh=mesh)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, poses_d, kfs, unres = front_end_drive(st0, pts_seq, msk_seq, fe_cfg, mesh=mesh)
    torch.cuda.synchronize()
    out["drive_ms"] = (time.perf_counter() - t0) * 1e3 / len(pts_seq)
    k1_drive = every_rank(ndt_fused.launches)
    check(min(k1_drive) > 0 and len(set(k1_drive)) == 1 and ndt_newton.launches == 0,
          f"{tag}: the sharded drive launched K1 {k1_drive} times by rank, ndt_newton {ndt_newton.launches}")
    out["k1_drive"] = k1_drive
    t0 = time.perf_counter()
    _, poses_u, kfs_u, _ = front_end_drive(st0, pts_seq, msk_seq, fe_cfg)
    torch.cuda.synchronize()
    out["drive_ref_ms"] = (time.perf_counter() - t0) * 1e3 / len(pts_seq)
    poses_d, poses_u = poses_d.numpy(), poses_u.numpy()
    gap_d = float(np.abs(poses_d[:, :3, 3] - poses_u[:, :3, 3]).max())
    errs = [np.linalg.norm(poses_d[k][:3, 3] - traj[3 + k][:3, 3]) for k in range(3, len(poses_d))]
    check(float(unres.max()) == 0.0 and kfs.tolist() == kfs_u.tolist() and gap_d <= LAYOUT_TOL,
          f"{tag}: the sharded drive {gap_d} m from the single-rank drive, keyframes {kfs.tolist()} / {kfs_u.tolist()}")
    check(np.mean(errs) < 0.15, f"{tag}: the sharded drive's error guard ({np.mean(errs):.4f} m)")
    say(f"front_end_drive(mesh=) over phase 6's frames 3-17: {out['drive_ms']:.2f} ms a frame against the "
        f"single-rank drive's {out['drive_ref_ms']:.2f} (ndt_newton; wall), {int(kfs.sum())} keyframes as the "
        f"single-rank drive, positions {gap_d:.2e} m from it, error mean {np.mean(errs):.4f} m; K1 launches by "
        f"rank {k1_drive} in two drives")

    t0 = time.perf_counter()
    dry = dryrun_rank(mesh)
    say(f"dryrun_multichip({world}): ok in {time.perf_counter() - t0:.1f} s, map {dry['map_voxels']} voxels, "
        f"PCG chi2 {dry['pcg_chi2'][0]:.2f} -> {dry['pcg_chi2'][1]:.4f}, Schur chi2 {dry['schur_chi2'][0]:.2f} -> "
        f"{dry['schur_chi2'][1]:.4f}")
    return out


def save_local_maps(path, keyframes, frame, guess, cfg, one_rank, two_ranks):
    """Phase 19's local map for parallel_witness.py (.npz): the keyframes
    (points, masks, weights, poses, valid flags), the grid corner, the
    frame and guess its alignment starts from, the NDT config, and the
    one-rank map (build_ndt_map) and the two-rank map (sharded_build_local_map):
    keys, packed rows, and the port's alignment on each from the guess."""
    from lidar_slam_tpu_torch.models.registration import ndt_align

    kf, kf_m, kf_w, poses, valid, origin = keyframes
    maps = {}
    for name, m in (("one_rank", one_rank), ("two_ranks", two_ranks)):
        r = ndt_align(m, frame, guess, cfg)
        maps.update({f"{name}_keys": m.keys.cpu().numpy(), f"{name}_packed": m.packed.cpu().numpy(),
                     f"{name}_pose": r.pose.numpy(), f"{name}_converged": r.converged,
                     f"{name}_iterations": r.iterations})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, kf_points=kf.cpu().numpy(), kf_mask=kf_m.cpu().numpy(), kf_weights=kf_w.cpu().numpy(),
                        kf_poses=np.asarray(poses, np.float32), kf_valid=np.asarray(valid), origin=np.asarray(origin),
                        frame_points=frame.points.cpu().numpy(), frame_mask=frame.mask.cpu().numpy(),
                        guess=np.asarray(guess, np.float32), ndt=json.dumps(dataclasses.asdict(cfg)), **maps)


def bench_phase(smi):
    """Phase 20: `python3 -m lidar_slam_tpu_torch bench` in a subprocess
    (BENCH_TIMEOUT). Exit 0; each of bench.py's metric lines once, with its
    unit, in the bench's order (the headline last) and the card's name and
    power limit in its `device` field; both headlines over the port's CPU
    path (baseline "cpu"); every leg's logged launch counts as its path must
    launch them, among them: each scan-match drive one ndt_newton launch a
    frame and K1 none, the parity gate K1 once, the evaluation probe K1
    EVAL_CHAIN x EVAL_REPS times, A-LOAM K2 10 times a sweep, matching two
    ndt_newton launches a frame. Returns the launches by kernel summed over
    the legs, by leg, and the metric lines."""
    from lidar_slam_tpu_torch import bench as B

    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-m", "lidar_slam_tpu_torch", "bench"], capture_output=True, text=True,
                              timeout=BENCH_TIMEOUT, cwd=os.path.dirname(os.path.abspath(__file__)))
    except subprocess.TimeoutExpired as e:
        raise CheckFailed(f"bench: no exit in {BENCH_TIMEOUT} s; its log ends {(e.stderr or '')[-2000:]}") from None
    seconds = time.perf_counter() - t0
    for ln in proc.stderr.splitlines():
        if (ln.startswith(("[launches]", "[leg]", "[cpu]", "[roofline]", "[eval_probe]", "FAILED")) or "ms/frame" in ln
                or "iterations per frame" in ln or "error per frame" in ln):
            log(f"[bench] {ln}")
    for ln in proc.stdout.splitlines():
        log(f"[bench] {ln}")
    check(proc.returncode == 0, f"bench: exit {proc.returncode}; its log ends {proc.stderr[-3000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check([(r["metric"], r["unit"]) for r in lines] == list(B.METRICS),
          f"bench: metric lines {[(r['metric'], r['unit']) for r in lines]}, expected {list(B.METRICS)}")
    check(all(r["device"] == smi for r in lines), f"bench: device fields {sorted({r['device'] for r in lines})}")
    by_name = {r["metric"]: r for r in lines}
    for head, base in (("ndt_scan_match_fps", "ndt_cpu_fps"), ("ndt_scan_match_fps_radius27", "ndt_cpu_fps_radius27")):
        r = by_name[head]
        check(r.get("baseline") == "cpu" and abs(r["vs_baseline"] - r["value"] / by_name[base]["value"]) <= 1e-9 * r["value"],
              f"bench: {head} is not over the port's CPU path: {r}")
    legs = {}
    for ln in proc.stderr.splitlines():
        if ln.startswith("[launches] "):
            rec = json.loads(ln[len("[launches] "):])
            legs[rec["leg"]] = rec
    check(all(rec["ok"] for rec in legs.values()), f"bench: launches off their paths: {legs}")
    per_sweep = 2 + 2 * (B.ALOAM_SWEEPS - 2)
    want = {
        "cuda direct7 fused": {"ndt_newton": 2 * B.N_FRAMES, "ndt_reduce_fused": 0},
        "cuda radius27 fused": {"ndt_newton": 2 * B.N_FRAMES, "ndt_reduce_fused": 0},
        "parity": {"ndt_reduce_fused": 1},
        "eval_probe": {"ndt_reduce_fused": B.EVAL_CHAIN * B.EVAL_REPS},
        "aloam": {"window_knn": 10 * per_sweep},
        "matching": {"ndt_newton": 2 * (B.MATCH_FRAMES + 3 * (B.MATCH_FRAMES - 3))},
    }
    for leg, counts in want.items():
        got = legs.get(leg, {}).get("launches", {})
        check(all(got.get(k) == v for k, v in counts.items()), f"bench {leg}: launches {got}, expected {counts}")
    check(legs.get("front_end", {}).get("launches", {}).get("ndt_newton", 0) > 0
          and legs.get("loop_verify", {}).get("launches", {}).get("ndt_newton", 0) > 0,
          "bench: the front end or loop verification launched no ndt_newton")
    total = {k: sum(rec["launches"][k] for rec in legs.values()) for k in next(iter(legs.values()))["launches"]}
    head = by_name["ndt_scan_match_fps"]
    log(f"[bench] phase 20: exit 0 in {seconds:.1f} s, {len(lines)} metric lines, ndt_scan_match_fps "
        f"{head['value']:.2f} ({head['vs_baseline']:.2f} x the port's CPU path); launches {total} ({smi})")
    return {"launches": total, "legs": legs, "lines": by_name, "seconds": seconds, "log": proc.stderr}


# Phase 21, the endurance harness on its drive's first out-and-back: at least this many loops
ENDURANCE_MIN_LOOPS = 1


def endurance_phase(work, smi):
    """Phase 21: endurance.py's harness (run_mapping, report, check) on the
    first out-and-back of its drive (first_lap_frames: leg A, the U-turn and
    leg B), with its world, widths and config (configs/kitti_hdl64.yaml,
    `gather: auto` named): `mapping` through lidar_slam_tpu_torch.cli.main
    with the drive as its frame source. Every check of endurance.py but its
    keyframe floor, and ENDURANCE_MIN_LOOPS loops in place of its
    MIN_LOOPS: exit 0, every loop within LOOP_TOL of the truth with fitness
    <= 0.2, the optimized keyframes' ATE under 0.5 m, two ndt_newton launches
    a frame after the first and one a verification attempt, K1, K2 and K3
    none, the front_end stage's mean under 100 ms, device memory_allocated
    growing by less than 64 MiB from keyframe 50 to the end, every scan with
    at least 100k returns. Returns the kernels-line fields."""
    import endurance as E

    t0 = time.perf_counter()
    drive = E.endurance_drive()
    n = E.first_lap_frames(drive)
    os.makedirs(work, exist_ok=True)
    config = os.path.join(work, "config.yaml")
    with open(config, "w") as f:
        f.write(E.config_text())
    run = E.run_mapping(drive, os.path.join(work, "map"), config, n_frames=n)
    rep = E.report(run, drive)
    E.print_report(rep, " phase 21")
    fails = E.check(rep, min_keyframes=0, min_loops=ENDURANCE_MIN_LOOPS)
    log(f"[endurance phase 21] {n} frames of {len(drive)}: {time.perf_counter() - t0:.1f} s with the world's "
        f"build ({smi})")
    check(not fails, f"endurance, first out-and-back: {fails}")
    return {"launches": run.launches["ndt_newton"], "keyframes": rep["keyframes"], "loops": len(rep["loops"])}


def aloam_endurance_drive():
    """Phase 22's drive, its first out-and-back's sweeps started now in
    endurance.SIM_WORKERS processes at endurance.SIM_NICE, so that they are
    simulated while the earlier phases run (Drive.start; main() stops them
    at the end, done or not)."""
    import endurance as E

    drive = E.aloam_drive()
    drive.start(E.first_lap_frames(drive))
    return drive


def aloam_endurance_phase(work, smi, drive):
    """Phase 22: endurance.py's harness (run_mapping, report, check) with
    `mapping --front-end aloam` on the first out-and-back of its A-LOAM
    drive (aloam_drive: the endurance world at ALOAM_DENSITY, spinning
    sweeps simulated by SIM_WORKERS processes), the CLI's A-LOAM front end
    at the drive's 131 072 rows. Every check of endurance.py but its
    keyframe floor, with ENDURANCE_MIN_LOOPS loops and at least one
    verification attempt: exit 0, every loop within LOOP_TOL with fitness
    <= 0.2, the optimized keyframes' ATE under 0.5 m, window_knn exactly
    K2_PER_SWEEP launches a sweep and ndt_newton one an attempt, K1 and K3
    none, no sweep cut, no map at capacity, memory_allocated growing by less
    than 64 MiB from keyframe 50 to the end, every sweep with at least 100k
    returns. Returns the kernels-line fields."""
    import endurance as E

    t0 = time.perf_counter()
    n = E.first_lap_frames(drive)
    os.makedirs(work, exist_ok=True)
    config = os.path.join(work, "config.yaml")
    with open(config, "w") as f:
        f.write(E.config_text())
    run = E.run_mapping(drive, os.path.join(work, "map"), config, n_frames=n, front_end="aloam")
    rep = E.report(run, drive)
    E.print_report(rep, " phase 22")
    fails = E.check(rep, min_keyframes=0, min_loops=ENDURANCE_MIN_LOOPS)
    if rep["attempts"] < 1:
        fails.append("no loop-closure attempt")
    seconds = time.perf_counter() - t0
    log(f"[endurance phase 22] {n} frames of {len(drive)}, A-LOAM: {seconds:.1f} s, the sweeps simulated by "
        f"{drive.workers} processes since phase 2; window_knn {run.launches['window_knn']} launches in {n} sweeps, "
        f"ndt_newton {run.launches['ndt_newton']} in {rep['attempts']} attempts ({smi})")
    check(not fails, f"A-LOAM endurance, first out-and-back: {fails}")
    return {"launches": run.launches["window_knn"], "launches_ndt_newton": run.launches["ndt_newton"],
            "keyframes": rep["keyframes"], "loops": len(rep["loops"]), "seconds": seconds}


def reset_launches():
    from lidar_slam_tpu_torch.ops.cuda import knn_fused, ndt_fused, ndt_gather, ndt_newton, pose_pcg

    for m in (ndt_fused, ndt_newton, knn_fused, ndt_gather, pose_pcg):
        m.launches = 0


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch / CUDA port on one GPU.")
    ap.add_argument("--session-out", help="save phase 13's runs (.npz) for session_witness.py")
    ap.add_argument("--matching-out", help="save phase 15's inputs and poses (.npz) for matching_witness.py")
    ap.add_argument("--parallel-out", help="save phase 19's local map, its inputs and both of the port's maps "
                    "(.npz) for parallel_witness.py")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs only on a GPU", file=sys.stderr)
        return 2
    import lidar_slam_tpu_torch

    check("jax" not in sys.modules, "the port imported jax")
    dev = lidar_slam_tpu_torch.device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = device_label(dev)  # name and power limit as nvidia-smi gives them: the bench's device field
    log(f"[device] {kind} (count {count}); {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    build_kernels()
    aloam_sweeps = aloam_endurance_drive()
    try:
        return phases(args, dev, kind, count, smi, t_start, aloam_sweeps)
    finally:
        aloam_sweeps.stop()


def phases(args, dev, kind, count, smi, t_start, aloam_sweeps) -> int:
    """Phases 3-22 and the kernels line (main's docstring)."""
    import torch

    from lidar_slam_tpu_torch.ops.cuda import knn_fused, ndt_fused, ndt_gather, ndt_newton

    cfg = scan_match_config()
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
    reset_launches()
    pcg = pose_pcg_phase(dev, smi)
    t0 = time.perf_counter()
    gt_s, scans_s = session_workload()
    log(f"[workload] session: {len(scans_s)} scans simulated in {time.perf_counter() - t0:.1f} s")
    session = mapping_session(dev, os.path.join(work, "session"), gt_s, scans_s, smi, args.session_out)
    shutil.rmtree(os.path.join(work, "session"), ignore_errors=True)

    # this slice's paths: map-matching localization, the rebuilt local map
    # and session restore, the LM solver; counts reset inside each
    reset_launches()
    matching = matching_phase(dev, smi, args.matching_out)
    rebuilt = rebuilt_front_end(dev, traj_front, loaded_front, smi)
    launches_lm = lm_phase(workload, cfg, drives, smi)
    log(f"[launches] ndt_newton: {matching['launches']} in the matching paths, {rebuilt['launches']} in the "
        f"rebuilt-map front end; K1: {launches_lm} in the LM alignments ({smi})")

    # this slice's path: the CLI from KITTI files on disk (phase 13's drive
    # written out); counts reset inside
    cli = cli_phase(os.path.join(work, "cli"), gt_s, scans_s, smi)
    del scans_s
    shutil.rmtree(work, ignore_errors=True)
    log(f"[launches] ndt_newton: {cli['launches']} in the CLI's mapping and matching; K2: {cli['launches_aloam']} "
        f"in its A-LOAM mapping ({smi})")

    # this slice's paths: the multi-rank layer, in rank processes whose
    # counts start at 0 and are reset inside
    mesh = mesh_phase(workload, loaded_front, traj_front, smi, args.parallel_out)
    k1_mesh = {w: sum(r["k1_align"]) + sum(r["k1_drive"]) for w, r in mesh.items()}
    log(f"[launches] K1: {k1_mesh[1]} in the sharded paths on one rank, {k1_mesh[2]} on two "
        f"({mesh[2]['k1_align']} and {mesh[2]['k1_drive']} by rank in the alignments and the drives) ({smi})")

    # this slice's path: the bench entry point, in its own process; its counts are its legs'
    bench = bench_phase(smi)
    log(f"[launches] the bench: {bench['launches']} ({smi})")

    # this slice's path: the mapping CLI over the endurance drive's first out-and-back; counts reset inside
    endurance = endurance_phase(os.path.join(work, "endurance"), smi)
    shutil.rmtree(work, ignore_errors=True)
    log(f"[launches] ndt_newton: {endurance['launches']} in the endurance drive's first out-and-back ({smi})")

    # this slice's path: `mapping --front-end aloam` over the A-LOAM drive's first out-and-back; counts reset inside
    aloam_endurance = aloam_endurance_phase(os.path.join(work, "endurance_aloam"), smi, aloam_sweeps)
    shutil.rmtree(work, ignore_errors=True)
    log(f"[launches] window_knn: {aloam_endurance['launches']}, ndt_newton: {aloam_endurance['launches_ndt_newton']} "
        f"in the A-LOAM drive's first out-and-back ({smi})")

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
            + session["launches_drift"] + matching["launches"] + rebuilt["launches"] + cli["launches"]
            + bench["launches"]["ndt_newton"] + endurance["launches"] + aloam_endurance["launches_ndt_newton"],
            "max_abs_err": max(n7["max_abs_err"], n27["max_abs_err"], loop["max_abs_err"], matching["max_abs_err"]),
            "ms": n7["ms"],
            "plain_ms": n7["plain_ms"],
            "bound_ms": n7["bound_ms"],
            "bound_by": n7["bound_by"],
            "library_ms": None,
            "iterations": n7["iterations"],
            "ms_per_iteration": n7["ms_per_iteration"],
            "grid": n7["grid"],
            "grid_radius27": n27["grid"],
            "split_us": n7["split"],
            "split_us_radius27": n27["split"],
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
            "launches_cli_mapping": cli["launches_mapping"],
            "launches_cli_matching": cli["launches_matching"],
            "launches_bench": bench["launches"]["ndt_newton"],
            "launches_endurance": endurance["launches"],
            "launches_endurance_aloam": aloam_endurance["launches_ndt_newton"],
        },
        {
            "name": "ndt_reduce_fused",
            "route": "cuda",
            "source": "lidar_slam_tpu_torch/csrc/ndt_fused.cu",
            "replaces": "lidar_slam_tpu/ops/pallas/ndt_fused.py:297",
            "launches": launches_k1 + launches_lm + k1_mesh[1] + k1_mesh[2] + bench["launches"]["ndt_reduce_fused"],
            "max_abs_err": max(d7[0], r27[0]),
            "max_abs_err_pose_on_card": max(d7[5], r27[5]),
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
            "launches_sharded_world1": k1_mesh[1],
            "launches_sharded_world2": k1_mesh[2],
            "k1_shard_rel_err_world1": mesh[1]["k1_shard_rel_err"],
            "k1_shard_rel_err_world2": mesh[2]["k1_shard_rel_err"],
            "sharded_align_ms_world1": mesh[1]["align_ms"],
            "sharded_align_ms_world2": mesh[2]["align_ms"],
            "launches_bench": bench["launches"]["ndt_reduce_fused"],
            "bench_eval_ms": bench["lines"]["ndt_mfu"]["eval_ms"],
        },
        {
            "name": "window_knn",
            "route": "cuda",
            "source": "lidar_slam_tpu_torch/csrc/knn_fused.cu",
            "replaces": "lidar_slam_tpu/ops/pallas/knn_fused.py:117",
            "launches": launches_k2 + cli["launches_aloam"] + bench["launches"]["window_knn"]
            + aloam_endurance["launches"],
            "max_abs_err": max(c["max_abs_err"] for c in knn),
            "ms": k2["ms"],
            "plain_ms": k2["plain_ms"],
            "bound_ms": k2["bound_ms"],
            "bound_by": k2["bound_by"],
            "library_ms": None,
            "alone_ms": k2["alone_ms"],
            "launches_cli_aloam": cli["launches_aloam"],
            "launches_bench": bench["launches"]["window_knn"],
            "launches_endurance_aloam": aloam_endurance["launches"],
            "cases": [{key: v for key, v in c.items() if key != "max_abs_err"} for c in knn],
        },
        {
            "name": "gather_stats_onehot",
            "route": "cuda",
            "source": "lidar_slam_tpu_torch/csrc/ndt_gather.cu",
            "replaces": "lidar_slam_tpu/ops/pallas/ndt_reduce.py:49",
            "launches": launches_k3 + bench["launches"]["gather_stats_onehot"],
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
        {
            "name": "pose_pcg",
            "route": "cuda",
            "source": "lidar_slam_tpu_torch/csrc/pose_pcg.cu",
            "replaces": None,
            "replaces_loop": "lidar_slam_tpu/models/graph_optimizer.py (_solve_pcg's lax.while_loop)",
            "launches": pcg["launches"],
            "max_abs_err": pcg["max_abs_err"],
            "plain_max_abs_err": pcg["plain_max_abs_err"],
            "ms": pcg["ms"],
            "plain_ms": pcg["plain_ms"],
            "bound_ms": pcg["bound_ms"],
            "bound_by": pcg["bound_by"],
            "library_ms": None,
            "alone_ms": pcg["alone_ms"],
            "steps": pcg["steps"],
            "plain_launches": pcg["plain_launches"],
            "launches_solve": pcg["launches_solve"],
            "iterations_solve": pcg["iterations"],
        },
    ]}))
    log(f"[chip_smoke] phases 1-22 in {time.perf_counter() - t_start:.1f} s, phase 22 {aloam_endurance['seconds']:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
