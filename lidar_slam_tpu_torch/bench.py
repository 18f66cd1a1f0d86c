"""The port's benchmark suite: bench.py's legs on the card, bench.py's metric lines.

    python3 -m lidar_slam_tpu_torch bench [--device cpu]
    python3 -m lidar_slam_tpu_torch.bench [--device cpu]

Runs on the first CUDA card (`--device cpu` runs every leg on the CPU;
without a card and without that flag it exits 2 naming the missing card).
Prints one JSON line a metric on standard output, with bench.py's names,
units and extra fields, each line with a `device` field: the card's name
and power limit as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` gives them, or "cpu". The headline,
`ndt_scan_match_fps`, prints last, with `vs_baseline` = its frames/s over
the port's own CPU path (`BENCH_MODE=cpu`: the same workload on the CPU
with gather="two_level", in a subprocess run after the card's legs, so that
it does not take their host cores). Logs, per-frame readings and each leg's
kernel launch counts go to standard error.

Every guard of bench.py is checked and a failed one ends the run with an
exception (exit code 1). The legs bench.py wraps in `try` (the solver
sweep, Scan Context growth, A-LOAM, matching, loop verification) log their
failure and let the run go on; so do a leg whose kernel launches on the
card differ from what its path must launch and a failed CPU baseline.
`main` then returns 1: no failure ends in exit 0.

Timing: every timed region lies between `torch.cuda.synchronize()` calls
(host wall clock); the evaluation probe is timed with CUDA events. Uploads
(`FrontEnd.preload`, `Matching.preload`) stay outside the timed windows.

Environment knobs (bench.py's): NDT_STENCIL, NDT_GATHER, NDT_MAX_ITER,
NDT_MAX_COMPACT, NDT_FUSED_WINDOW, and BENCH_MODE=cpu for the CPU baseline
alone. The sizes are module constants and the legs' configurations come
from module functions (`ndt_config`, `front_end_config`, `aloam_configs`,
`matching_config`, `loop_config`), all at bench.py's operating point;
tests shrink them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List

import numpy as np
import torch

RAW_CAP = 131072  # a raw scan's padded rows
FRAME_CAP = 32768  # a preprocessed frame's rows
N_FRAMES = 20  # the scan-match drive
GRID = (256, 256, 64)  # the tracking NDT grid (1 m voxels)
POSE_GRAPH = (366, 384, 2048)  # pose_graph_leg: dense-LM nodes, their capacity, PCG nodes
SOLVER_SWEEP = ((512, 80.0), (2048, 120.0), (8192, 200.0))  # (nodes, circle radius): PCG at each
DENSE_MAX = 1024  # the sweep's dense Cholesky runs at <= this many nodes
SCHUR_NODES = 512
SC_HISTORY = (200, 800, 3200)  # stored Scan Context descriptors
ALOAM_AZIMUTH, ALOAM_SWEEPS = 1024, 12  # A-LOAM: azimuth bins (x 64 rings); sweeps, 2 of them priming
FRONT_END_FRAMES = 18  # front_end_leg: 6 warm, the rest timed; its drives run frames 3 on
MATCH_AZIMUTH, MATCH_FRAMES = 2048, 16  # matching: azimuth bins (x 64 rings); frames, 3 of them warm
LOOP_SCAN_POINTS = 16384  # loop_verify_leg's scans
EVAL_CHAIN, EVAL_REPS = 20, 3  # eval_probe: evaluations a chain, chains timed
CPU_TIMEOUT = 3600.0  # s, the CPU baseline's subprocess
# the sizes the CPU baseline's subprocess is given, so that it runs the workload of this process
WORKLOAD_SIZES = ("RAW_CAP", "FRAME_CAP", "N_FRAMES", "GRID")

# One H100 SXM (the data sheet): HBM bytes/s and fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# fp32 FLOPs the NDT reduction needs (an FMA counts 2): each valid point is transformed
# and its cell found once (the kernels redo that for each stencil offset, which the
# function does not need; the neighbour's index is integer work); a (point, voxel) pair
# on a valid voxel takes the Mahalanobis term (and the radius27 gate); an accepted pair
# adds the score, gradient and 21 Hessian terms
FLOPS_POINT, FLOPS_VALID, FLOPS_GATE, FLOPS_ACCEPTED = 24, 37, 5, 413

# bench.py's metric lines, (name, unit), in the order this module prints them
METRICS = (
    ("ndt_mfu", "fraction_f32_peak"),
    ("pose_graph_2048_ms_per_iter", "ms/iter"),
    ("pose_graph_ms_per_iter", "ms/iter"),
    ("pose_graph_schur_ms_per_iter", "ms/iter"),
    ("pose_graph_8192_ms_per_iter", "ms/iter"),
    ("sc_detect_ms_800", "ms"),
    ("aloam_pipeline_fps", "frames/s"),
    ("map_update_ms", "ms/keyframe"),
    ("front_end_e2e_fps", "frames/s"),
    ("front_end_drive_fps", "frames/s"),
    ("matching_drive_fps", "frames/s"),
    ("matching_init_ms", "ms"),
    ("matching_refresh_ms", "ms"),
    ("matching_fps", "frames/s"),
    ("loop_verify_ms", "ms"),
    ("ndt_cpu_fps_radius27", "frames/s"),
    ("ndt_scan_match_fps_radius27", "frames/s"),
    ("ndt_cpu_fps", "frames/s"),
    ("ndt_scan_match_fps", "frames/s"),
)


class GuardFailed(Exception):
    """A bench.py guard that did not hold."""


@dataclasses.dataclass
class Card:
    """Where the legs run and what they print: the device, its label (the
    `device` field of every line) and the failures of the legs that let the
    run go on."""

    dev: torch.device
    label: str
    failed: List[str] = dataclasses.field(default_factory=list)

    @property
    def cuda(self) -> bool:
        return self.dev.type == "cuda"


def _emit(card, metric, value, unit, vs_baseline=None, **extra):
    rec = {"metric": metric, "value": float(value), "unit": unit}
    if vs_baseline is not None:
        rec["vs_baseline"] = float(vs_baseline)
    rec.update(extra)
    rec["device"] = card.label
    print(json.dumps(rec), flush=True)


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _guard(cond, msg):
    if not cond:
        raise GuardFailed(msg)


def device_label(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them ("cpu" for
    the CPU; the name alone if nvidia-smi gives nothing)."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    index = dev.index or 0
    return out[index] if index < len(out) else f"{torch.cuda.get_device_name(dev)}, power limit not read"


def _sync(card):
    if card.cuda:
        torch.cuda.synchronize(card.dev)


def _wall(card, fn):
    """(seconds, result) of fn(), host wall clock between synchronisations."""
    _sync(card)
    t0 = time.perf_counter()
    out = fn()
    _sync(card)
    return time.perf_counter() - t0, out


def _kernels():
    from .ops.cuda import knn_fused, ndt_fused, ndt_gather, ndt_newton, pose_pcg

    return {"ndt_newton": ndt_newton, "ndt_reduce_fused": ndt_fused, "window_knn": knn_fused,
            "gather_stats_onehot": ndt_gather, "pose_pcg": pose_pcg}


def _reset_launches():
    for mod in _kernels().values():
        mod.launches = 0


def _launches(card, leg, **expect):
    """Logs the wrappers' launch counts since the last reset beside what the
    leg's path must launch (`expect`: kernel -> count, None for a count the
    path does not fix; unnamed kernels 0; on the CPU every count is 0), and
    records a mismatch as a failure of the leg."""
    counts = {name: mod.launches for name, mod in _kernels().items()}
    want = {name: expect.get(name, 0) if card.cuda else 0 for name in counts}
    ok = all(v is None or counts[k] == v for k, v in want.items())
    _log(f"[launches] {json.dumps({'leg': leg, 'launches': counts, 'expected': want, 'ok': ok})}")
    if not ok:
        card.failed.append(f"{leg}: kernel launches {counts}, expected {want}")


def _align_expect(cfg, dev, n_alignments):
    """What `n_alignments` ndt_align calls under `cfg` launch on `dev`."""
    from .models.registration.ndt import takes_newton_kernel

    if takes_newton_kernel(cfg, dev):
        return {"ndt_newton": n_alignments}
    gather = cfg.resolve_gather(dev)
    return {"ndt_reduce_fused": None} if gather == "fused" else {"gather_stats_onehot": None} if gather == "onehot" else {}


def bound(n_bytes, flops):
    """(bound ms, what sets it): the larger of bytes over the HBM rate and
    fp32 FLOPs over the fp32 peak of one H100."""
    b, f = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return (b, "bytes") if b >= f else (f, "operations")


def ndt_work(frame, ndt_map, poses, cfg):
    """Bytes and fp32 FLOPs the NDT reduction needs on these inputs at each
    pose of `poses` (host [6] arrays), summed: each source row read once
    (mask; xyz and weight of the valid ones), each index word and stats row
    (48 B read of 64) touched at any pose once, the pose and the result (at
    most 48 floats) once; FLOPs per pair as counted in FLOPS_*."""
    from .ops.cuda import ndt_fused, ndt_newton

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


def circle_graph(builder, n, radius, rng):
    """bench.py:207-233 / 276-297 / 577-597: n poses on a circle, odometry
    edges with N(0, 0.02) se(3) noise chained into the initial guess, one
    loop edge from the last node to the first; node 0 fixed."""
    from .geom import se3_exp

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


def shuttle_graph(builder, rng, n=540, loops=90, lap=139):
    """The back end's graph at the end of a shuttle drive (slam_bench's
    `ndt_mapping.shuttle`): n keyframes 2 m apart around a 120 m racetrack
    with 6 m turns (`lap` keyframes a lap), odometry edges with drift
    chained into the initial guess, `loops` loop edges from a keyframe to
    its place a lap earlier, and a GNSS XYZ prior (0.1 m noise) on every
    node; BackEndConfig's noises, node 0 fixed."""
    from .geom import se3_exp
    from .pipeline.back_end import BackEndConfig

    cfg = BackEndConfig()
    straight, r = 120.0, 6.0
    length = 2 * straight + 2 * np.pi * r

    def pose(s):
        s = s % length
        if s < straight:
            x, y, th = s, -r, 0.0
        elif s < straight + np.pi * r:
            a = (s - straight) / r
            x, y, th = straight + r * np.sin(a), -r * np.cos(a), a
        elif s < 2 * straight + np.pi * r:
            x, y, th = straight - (s - straight - np.pi * r), r, np.pi
        else:
            a = (s - 2 * straight - np.pi * r) / r
            x, y, th = -r * np.sin(a), r * np.cos(a), np.pi + a
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]]
        T[:3, 3] = [x, y, 0.0]
        return T

    gt = [pose(k * length / lap) for k in range(n)]
    est = [gt[0]]
    builder.add_se3_node(gt[0], fixed=True)
    builder.add_se3_prior_xyz_edge(0, gt[0][:3, 3] + rng.normal(0, 0.1, 3), noise=cfg.gnss_noise)
    for i in range(1, n):
        Z = np.linalg.inv(gt[i - 1]) @ gt[i]
        drift = np.concatenate([rng.normal(0, 0.02, 3), rng.normal(0, 0.002, 3)]).astype(np.float32)
        Zn = se3_exp(torch.as_tensor(drift)).numpy() @ Z
        est.append((est[-1] @ Zn).astype(np.float32))
        builder.add_se3_node(est[-1])
        builder.add_se3_edge(i - 1, i, Zn, noise=cfg.odom_edge_noise)
        builder.add_se3_prior_xyz_edge(i, gt[i][:3, 3] + rng.normal(0, 0.1, 3), noise=cfg.gnss_noise)
    for k in np.sort(rng.choice(np.arange(lap, n), size=min(loops, n - lap), replace=False)):
        builder.add_se3_edge(int(k) - lap, int(k), np.linalg.inv(gt[k - lap]) @ gt[k], noise=cfg.close_loop_noise)


def build_workload(dev):
    """bench.py:63-95: the corridor map cloud (20 keyframes, 0.3 m leaf) on
    `dev`, N_FRAMES raw scans padded to RAW_CAP on `dev`, their ground
    truth and the perturbed first guess (host)."""
    from .io import SyntheticWorld, make_trajectory, simulate_scan
    from .ops import PointCloud, voxel_downsample

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


def ndt_config(stencil="direct7", gather="fused", max_iter=30, max_compact=65536, fused_window=512):
    """bench.py:906-915: the tracking operating point on GRID."""
    from .models.registration import NDTConfig

    return NDTConfig(resolution=1.0, grid_dims=tuple(GRID), point_chunk=8192, max_iter=max_iter, stencil=stencil,
                     gather=gather, max_compact_voxels=max_compact, fused_window=fused_window)


def front_end_config():
    """bench.py:325-333: FrontEndConfig at the tracking operating point (ndt
    gather "auto": one ndt_newton launch an alignment on the card)."""
    from .pipeline.front_end import FrontEndConfig

    return FrontEndConfig(ndt=ndt_config(gather="auto"), raw_capacity=RAW_CAP, frame_capacity=FRAME_CAP)


def aloam_configs():
    """bench.py:446-449: A-LOAM's feature extraction (64 rings, 65 536 rows),
    default odometry and mapping."""
    from .pipeline.aloam import AloamMappingConfig, AloamOdometryConfig, FeatureExtractionConfig

    fe_cfg = FeatureExtractionConfig(n_scans=64, min_range=2.5, capacity=65536, max_sharp=1024,
                                     max_less_sharp=8192, max_flat=2048, max_less_flat=16384)
    return fe_cfg, AloamOdometryConfig(), AloamMappingConfig()


def matching_config():
    """bench.py:721: MatchingConfig() (224 x 224 x 48 radius27 fine map, GPF,
    270 yaws; ndt gather "auto": two ndt_newton launches a frame on the card)."""
    from .pipeline.matching import MatchingConfig

    return MatchingConfig()


def loop_config():
    """bench.py:821-823: LoopClosingConfig() with loop_step 1, diff_num 20
    and the Scan Context exclude-recent window scaled to the short drive's
    diff_num (the default 50 would exclude it all)."""
    from .models.scan_context import ScanContextConfig
    from .pipeline.loop_closing import LoopClosingConfig

    return LoopClosingConfig(loop_step=1, diff_num=20, sc=ScanContextConfig(num_exclude_recent=20))


def make_drive(ndt_map, cfg):
    """bench.py:98-143: the sequential drive, frame after frame: finite mask
    and 0.5 m voxel downsample into FRAME_CAP rows, ndt_align from the
    motion-model prediction (on the card one ndt_newton launch and one
    result copy), the pose chained into the next frame's prediction.
    drive(pts [F, RAW_CAP, 3], msk [F, RAW_CAP], guess [4, 4]) -> (poses
    [F, 4, 4], iterations [F], unresolved [F]), numpy."""
    from .models.registration import ndt_align
    from .pipeline.front_end import _preprocess

    def drive(pts_seq, msk_seq, guess_init):
        last = predict = torch.as_tensor(np.asarray(guess_init, np.float32))
        poses, iters, unres = [], [], []
        for points, mask in zip(pts_seq, msk_seq):
            frame = _preprocess(points, mask, FRAME_CAP, 0.5)
            r = ndt_align(ndt_map, frame, predict, cfg)
            step = torch.linalg.solve(last, r.pose)
            last, predict = r.pose, r.pose @ step
            poses.append(r.pose.numpy())
            iters.append(r.iterations)
            unres.append(r.unresolved)
        return np.stack(poses), np.asarray(iters), np.asarray(unres)

    return drive


def scan_match_leg(card, name, cfg, workload, err_limit=0.10, warm=None):
    """bench.py:146-161: one operating point. A warm-up drive over the first
    `warm` frames (default all), then the timed drive. Returns (frames/s,
    mean iterations). Guards: unresolved 0 on every frame, mean error <=
    err_limit."""
    from .models.registration import build_ndt_map

    map_cloud, all_pts, all_msk, gt, guess0 = workload
    warm = N_FRAMES if warm is None else warm
    t, ndt_map = _wall(card, lambda: build_ndt_map(map_cloud, cfg))
    _log(f"[{name}] map build: {t:.3f} s, {int(ndt_map.valid.sum())} valid voxels")
    drive = make_drive(ndt_map, cfg)
    _reset_launches()
    t, _ = _wall(card, lambda: drive(all_pts[:warm], all_msk[:warm], guess0))
    _log(f"[{name}] warm-up drive of {warm} frames: {t:.3f} s")
    dt, (poses, iters, unres) = _wall(card, lambda: drive(all_pts, all_msk, guess0))
    _launches(card, name, **_align_expect(cfg, card.dev, warm + N_FRAMES))
    errs = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    _log(f"[{name}] {dt / N_FRAMES * 1e3:.3f} ms/frame, iterations mean {np.mean(iters):.2f}, error mean "
         f"{errs.mean():.4f} max {errs.max():.4f} m, unresolved max {float(unres.max())}")
    _log(f"[{name}] iterations per frame {iters.tolist()}")
    _log(f"[{name}] error per frame (m) {np.array2string(errs, precision=4, max_line_width=200)}")
    _guard(float(unres.max()) == 0.0, f"{name}: the reduction dropped derivative terms (unresolved={unres.max()})")
    _guard(errs.mean() <= err_limit, f"{name}: pose error guard failed ({errs.mean():.4f} m)")
    return N_FRAMES / dt, float(np.mean(iters))


def _frame0(cfg, workload):
    """The operating point of the parity gate and the probe: the NDT map,
    frame 0 preprocessed and sorted by voxel id under the first guess, and
    the guess's translation as a [6] pose (bench.py:172-178)."""
    from .models.registration import build_ndt_map
    from .models.registration.ndt import sort_points_by_vid
    from .pipeline.front_end import _preprocess

    map_cloud, all_pts, all_msk, _, guess0 = workload
    ndt_map = build_ndt_map(map_cloud, cfg)
    frame = _preprocess(all_pts[0], all_msk[0], FRAME_CAP, 0.5)
    pts, msk, w = sort_points_by_vid(ndt_map, frame.points, frame.mask, frame.get_weights(), guess0)
    pose6 = np.zeros(6, np.float32)
    pose6[:3] = guess0[:3, 3]
    return ndt_map, frame, pts, msk, w, pose6


def _gather_expect(cfg, dev, n_evaluations):
    gather = cfg.resolve_gather(dev)
    return ({"ndt_reduce_fused": n_evaluations} if gather == "fused"
            else {"gather_stats_onehot": None} if gather == "onehot" else {})


def derivative_parity_gate(card, cfg, workload):
    """bench.py:164-191: ndt_derivatives through cfg's gather (K1 on the
    card for "fused") against gather="two_level" (the plain reduction) at
    the operating point, with bench.py's tolerances."""
    from .models.registration import ndt_derivatives

    ndt_map, _, pts, msk, w, pose6 = _frame0(cfg, workload)
    _reset_launches()
    s_f, g_f, h_f, u_f = ndt_derivatives(ndt_map, pts, msk, pose6, cfg, True, weights=w, return_unresolved=True)
    _launches(card, "parity", **_gather_expect(cfg, card.dev, 1))
    cfg_x = dataclasses.replace(cfg, gather="two_level")
    s_x, g_x, h_x = ndt_derivatives(ndt_map, pts, msk, pose6, cfg_x, True, weights=w)
    _guard(float(u_f) == 0.0, f"parity: unresolved {float(u_f)}")
    np.testing.assert_allclose(float(s_f), float(s_x), rtol=2e-4)
    np.testing.assert_allclose(g_f.numpy(), g_x.numpy(), rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(h_f.numpy(), h_x.numpy(), rtol=2e-3, atol=1e-2)
    _log(f"[parity] {cfg.gather} == two_level at the operating point (score {float(s_f):.4f}, "
         f"|g| {float(torch.linalg.norm(g_f)):.4f})")


def eval_chain(ndt_map, pts, msk, w, pose, cfg, n):
    """n K1 evaluations in a row, each at the pose the last one's score
    moved (pose + 1e-9 score, bench.py:301-310): the pose stays on the
    points' device and nothing is read on the host. Returns the last pose."""
    from .ops.cuda.ndt_fused import ndt_reduce_fused

    d1, d2 = cfg.gauss_params()
    kw = dict(dims=ndt_map.dims, resolution=ndt_map.resolution, d1=float(np.float32(d1)), d2=float(np.float32(d2)),
              stencil=cfg.stencil, weight_derivatives=cfg.weight_derivatives)
    for _ in range(n):
        out = ndt_reduce_fused(pts, msk, w, ndt_map.index, ndt_map.packed, ndt_map.origin, None, None, None, None,
                               pose=pose, **kw)
        pose = torch.add(pose, out[0], alpha=1e-9)
    return pose


def eval_probe(card, cfg, workload):
    """bench.py:476-517: the time of one derivative evaluation, K1 alone
    (the kernel the mfu line counts): EVAL_CHAIN evaluations chained
    through the pose on the device, EVAL_REPS chains, CUDA events around
    each (a queued sleep first, so the events bracket device work only).
    Returns (ms an evaluation, bytes and fp32 FLOPs an evaluation needs)."""
    ndt_map, frame, pts, msk, w, pose6 = _frame0(cfg, workload)
    pose = torch.from_numpy(pose6).to(card.dev)
    eval_chain(ndt_map, pts, msk, w, pose, cfg, EVAL_CHAIN)  # warm-up
    _sync(card)
    _reset_launches()
    times = []
    for _ in range(EVAL_REPS):
        if card.cuda:
            torch.cuda._sleep(50_000_000)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            eval_chain(ndt_map, pts, msk, w, pose, cfg, EVAL_CHAIN)
            b.record()
            torch.cuda.synchronize(card.dev)
            times.append(a.elapsed_time(b))
        else:
            t, _ = _wall(card, lambda: eval_chain(ndt_map, pts, msk, w, pose, cfg, EVAL_CHAIN))
            times.append(t * 1e3)
    _launches(card, "eval_probe", ndt_reduce_fused=EVAL_CHAIN * EVAL_REPS)
    eval_ms = float(np.mean(times)) / EVAL_CHAIN
    n_bytes, flops = ndt_work(frame, ndt_map, [pose6], cfg)
    _log(f"[eval_probe] {eval_ms:.4f} ms an evaluation ({EVAL_REPS} chains of {EVAL_CHAIN}: "
         f"{', '.join(f'{t:.4f}' for t in times)} ms)")
    return eval_ms, n_bytes, flops


def ndt_mfu(card, fps, iters_mean, eval_ms, n_bytes, flops):
    """bench.py:520-566 recounted for the port's K1, which gathers each
    (point, voxel) pair directly (no one-hot selection contraction, no
    matrix unit): the fp32 FLOPs and bytes one evaluation needs (ndt_work)
    against one H100's fp32 peak and HBM rate. The line carries the count's
    basis."""
    bound_ms, bound_by = bound(n_bytes, flops)
    mfu = flops / (eval_ms / 1e3) / PEAK_FP32
    evals = iters_mean + 1.0
    ms_frame = 1e3 / fps
    _log(f"[roofline] per evaluation: {flops / 1e6:.2f} MFLOP fp32, {n_bytes / 1e6:.3f} MB -> bound {bound_ms:.5f} ms "
         f"({bound_by}); measured {eval_ms:.4f} ms; frame {ms_frame:.3f} ms = {evals:.1f} evaluations "
         f"({evals * eval_ms:.3f} ms at the probe's rate) + {ms_frame - evals * eval_ms:.3f} ms other; "
         f"fp32 utilization {mfu * 100:.2f} % of the evaluation time")
    _emit(card, "ndt_mfu", mfu, "fraction_f32_peak", eval_ms=eval_ms, gflop_per_eval=flops / 1e9,
          frame_other_ms=ms_frame - evals * eval_ms, flop_per_eval=flops, bytes_per_eval=n_bytes,
          peak_fp32_flop_per_s=PEAK_FP32, peak_bytes_per_s=PEAK_BYTES, bound_ms=bound_ms, bound_by=bound_by)


def pose_graph_leg(card):
    """bench.py:194-312: POSE_GRAPH[0] nodes at capacity POSE_GRAPH[1] (the
    dense Cholesky LM, max 50 iterations): chi2 below 5 % of its start,
    then 8 solves back to back with one synchronize at the end, ms an
    iteration over their iterations; then POSE_GRAPH[2] nodes with PCG
    (emits pose_graph_2048_ms_per_iter). Returns (ms/iter, iterations)."""
    from .models.graph_optimizer import GraphOptimizerConfig, PoseGraphBuilder, optimize_pose_graph

    n, cap, n2 = POSE_GRAPH
    rng = np.random.default_rng(0)
    b = PoseGraphBuilder(max_nodes=cap, max_edges=cap, max_priors=8, device=card.dev)
    circle_graph(b, n, 60.0, rng)
    cfg = GraphOptimizerConfig(max_iterations=50)
    graph = b.to_graph()
    _reset_launches()
    optimize_pose_graph(graph, cfg)  # warm-up
    dt, (_, stats) = _wall(card, lambda: optimize_pose_graph(graph, cfg))
    iters = int(stats["iterations"])
    _log(f"[pose_graph] {n} nodes/{n} edges: {dt * 1e3:.1f} ms, {iters} LM iterations, "
         f"chi2 {stats['chi2_before']:.2f} -> {stats['chi2_after']:.5f}")
    _guard(stats["chi2_after"] < stats["chi2_before"] * 0.05, f"pose graph: chi2 {stats['chi2_after']} not < 5 %")

    reps = 8
    dtc, tot = _wall(card, lambda: sum(int(optimize_pose_graph(graph, cfg)[1]["iterations"]) for _ in range(reps)))
    ms_per_iter = dtc * 1e3 / max(tot, 1)
    _log(f"[pose_graph] chained x{reps}: {dtc * 1e3:.1f} ms, {tot} iterations -> {ms_per_iter:.3f} ms/iter")

    b2 = PoseGraphBuilder(max_nodes=n2, max_edges=n2 + 8, max_priors=8, device=card.dev)
    circle_graph(b2, n2, 120.0, rng)
    cfg2 = GraphOptimizerConfig(max_iterations=30, solver="pcg")
    g2 = b2.to_graph()
    optimize_pose_graph(g2, cfg2)  # warm-up
    dt2, (_, st2) = _wall(card, lambda: optimize_pose_graph(g2, cfg2))
    it2 = int(st2["iterations"])
    _launches(card, "pose_graph", pose_pcg=2 * it2)  # the PCG solve's warm-up and timed run, one an iteration
    _log(f"[pose_graph] {n2} nodes (PCG): {dt2 * 1e3:.1f} ms, {it2} LM iterations "
         f"({dt2 * 1e3 / max(it2, 1):.2f} ms/iter), chi2 {st2['chi2_before']:.1f} -> {st2['chi2_after']:.4f}")
    _emit(card, "pose_graph_2048_ms_per_iter", dt2 * 1e3 / max(it2, 1), "ms/iter", iterations=it2)
    return ms_per_iter, iters


def _loop_graph(dev, n, radius, seed=0):
    """bench.py:569-598: a noisy circle of n nodes and one loop edge, at capacity n."""
    from .models.graph_optimizer import PoseGraphBuilder

    b = PoseGraphBuilder(max_nodes=n, max_edges=n + 8, max_priors=8, device=dev)
    circle_graph(b, n, radius, np.random.default_rng(seed))
    return b


def pose_graph_solver_sweep(card):
    """bench.py:601-666: PCG at each SOLVER_SWEEP size and dense Cholesky at
    <= DENSE_MAX nodes (20 LM iterations at most), then the two-level Schur
    solve on a one-rank mesh (no process group) at SCHUR_NODES. Emits
    pose_graph_schur_ms_per_iter and pose_graph_8192_ms_per_iter."""
    from .models.graph_optimizer import GraphOptimizerConfig, optimize_pose_graph
    from .parallel import make_mesh, optimize_pose_graph_schur, schur_prepare

    def time_solve(solve):
        solve()  # warm-up
        dt, (_, stats) = _wall(card, solve)
        it = max(int(stats["iterations"]), 1)
        _guard(stats["chi2_after"] < stats["chi2_before"], f"solver sweep: chi2 rose ({stats})")
        return dt * 1e3 / it, it

    _reset_launches()
    results = {}
    pcg_iterations = 0
    for n, radius in SOLVER_SWEEP:
        graph = _loop_graph(card.dev, n, radius, seed=n).to_graph()
        pcg = GraphOptimizerConfig(max_iterations=20, solver="pcg")
        results[(n, "pcg")], it = time_solve(lambda: optimize_pose_graph(graph, pcg))
        pcg_iterations += 2 * it  # the warm-up and the timed solve
        line = f"[solver_sweep] n={n}: pcg {results[(n, 'pcg')]:.2f} ms/iter ({it} iters)"
        if n <= DENSE_MAX:
            dense = GraphOptimizerConfig(max_iterations=20, solver="dense")
            results[(n, "dense")], it = time_solve(lambda: optimize_pose_graph(graph, dense))
            line += f", dense {results[(n, 'dense')]:.2f} ms/iter ({it} iters)"
        _log(line)

    try:
        sg = schur_prepare(_loop_graph(card.dev, SCHUR_NODES, 80.0, seed=7).to_graph(), n_devices=1, sep_cap=16)
        mesh1 = make_mesh(1, device=card.dev)
        schur_ms, it_s = time_solve(lambda: optimize_pose_graph_schur(sg, GraphOptimizerConfig(max_iterations=20), mesh1))
        _log(f"[solver_sweep] schur(1 block) n={SCHUR_NODES}: {schur_ms:.2f} ms/iter ({it_s} iters)")
        _emit(card, "pose_graph_schur_ms_per_iter", schur_ms, "ms/iter", nodes=SCHUR_NODES,
              note="single-card 1-block form; multi-block parity on CPU ranks")
    except Exception as e:  # noqa: BLE001 - bench.py's leg boundary: log it and go on
        _log(f"[solver_sweep] schur leg FAILED: {e!r}")
        card.failed.append(f"schur: {e!r}")
    _launches(card, "solver_sweep", pose_pcg=pcg_iterations)
    _emit(card, "pose_graph_8192_ms_per_iter", results[(SOLVER_SWEEP[-1][0], "pcg")], "ms/iter", solver="pcg")
    return results


def sc_growth_leg(card):
    """bench.py:669-703: Scan Context retrieval ms at SC_HISTORY stored
    descriptors (uniform random, 50 newest excluded), 10 detections each."""
    from .models.scan_context import ScanContextConfig, detect_loop, ring_key

    sccfg = ScanContextConfig()
    rng = np.random.default_rng(0)
    out = {}
    _reset_launches()
    for hist in SC_HISTORY:
        descs = torch.from_numpy(
            rng.uniform(0, 8, (hist, sccfg.num_rings, sccfg.num_sectors)).astype(np.float32)).to(card.dev)
        rks = ring_key(descs)
        valid = torch.arange(hist, device=card.dev) < hist - 50
        detect_loop(descs[-1], rks[-1], descs, rks, valid, sccfg)  # warm-up
        dt, _ = _wall(card, lambda: [detect_loop(descs[-1], rks[-1], descs, rks, valid, sccfg) for _ in range(10)])
        out[hist] = dt / 10 * 1e3
    _launches(card, "sc_growth")
    small, mid, large = SC_HISTORY
    _log(f"[sc_growth] detect ms at {small}/{mid}/{large} descriptors: "
         f"{out[small]:.3f} / {out[mid]:.3f} / {out[large]:.3f}")
    _emit(card, "sc_detect_ms_800", out[mid], "ms", ms_200=out[small], ms_3200=out[large])
    return out


def aloam_leg(card):
    """bench.py:437-473: A-LOAM at bench.py's world (density 30) and feature
    extraction; two sweeps prime the state, then update_batch over the other
    ALOAM_SWEEPS - 2 (a warm-up, then the timed run from the same primed
    state: K2 10 launches a sweep). Guard: mean error < 0.3 m. Returns
    frames/s."""
    from .io import SyntheticWorld, make_trajectory, simulate_spinning_scan
    from .pipeline.aloam import AloamPipeline

    world = SyntheticWorld.corridor(length=60.0, width=18.0, density=30.0, seed=2)
    traj = make_trajectory(ALOAM_SWEEPS, speed=0.8)
    frames = [simulate_spinning_scan(world, traj[i], t=i * 0.1, n_scans=64, n_azimuth=ALOAM_AZIMUTH, seed=i)
              for i in range(ALOAM_SWEEPS)]
    pipe = AloamPipeline(*aloam_configs(), device=card.dev)
    pipe.set_init_pose(traj[0])
    _reset_launches()
    t0 = time.perf_counter()
    for i in range(2):  # state prime (per-sweep step)
        pipe.update(*frames[i])
    primed = pipe.state
    pipe.update_batch(frames[2:])  # warm-up
    pipe.state = primed
    _log(f"[aloam] warm-up: {time.perf_counter() - t0:.2f} s")
    dt, poses = _wall(card, lambda: pipe.update_batch(frames[2:]))
    n = ALOAM_SWEEPS - 2
    _launches(card, "aloam", window_knn=10 * (2 + 2 * n))
    errs = [np.linalg.norm(poses[i][:3, 3] - traj[2 + i][:3, 3]) for i in range(n)]
    _log(f"[aloam] {dt / n * 1e3:.2f} ms/frame (update_batch), error mean {np.mean(errs):.4f} m")
    _log(f"[aloam] error per sweep (m) {np.array2string(np.asarray(errs), precision=4, max_line_width=200)}")
    _guard(np.mean(errs) < 0.3, f"A-LOAM error guard ({np.mean(errs):.4f} m)")
    return n / dt


def front_end_leg(card):
    """bench.py:315-434: FrontEnd.update over FRONT_END_FRAMES frames (6
    warm, the rest timed), front_end_drive over frames 3 on (best of 2), and
    the isolated incremental map update of the last keyframe (fine + coarse,
    10 timed). Returns (e2e frames/s, map-update ms, drive frames/s)."""
    from .io import SyntheticWorld, make_trajectory, simulate_scan
    from .pipeline.front_end import (
        FrontEnd,
        _incremental_map_update,
        coarse_tracking_cfg,
        front_end_drive,
        init_front_end_drive,
    )

    cfg = front_end_config()
    world = SyntheticWorld.corridor(length=120.0, width=18.0, density=40.0, seed=0)
    traj = make_trajectory(40, speed=0.8)  # KITTI-like ~0.8 m/frame at 10 Hz
    scans = [simulate_scan(world, traj[i], max_range=80.0, n_points=RAW_CAP, seed=3000 + i, noise=0.02)[:2]
             for i in range(FRONT_END_FRAMES)]
    fe = FrontEnd(cfg, device=card.dev)
    fe.set_init_pose(traj[0])
    loaded = [fe.preload(p, m) for p, m in scans]  # the CLI's prefetch upload: outside the timed window
    _reset_launches()
    t0 = time.perf_counter()
    for i in range(6):  # warm-up, through a deferred keyframe update
        fe.update(None, preloaded=loaded[i])
    _log(f"[front_end] warm-up: {time.perf_counter() - t0:.2f} s")
    n_kf0 = fe.n_keyframes

    def timed():
        return [fe.update(None, preloaded=loaded[i])[0] for i in range(6, FRONT_END_FRAMES)]

    dt, poses = _wall(card, timed)
    errs = [np.linalg.norm(p[:3, 3] - traj[6 + k][:3, 3]) for k, p in enumerate(poses)]
    n_timed, n_drive = FRONT_END_FRAMES - 6, FRONT_END_FRAMES - 3
    _log(f"[front_end] e2e {dt / n_timed * 1e3:.2f} ms/frame ({fe.n_keyframes - n_kf0} keyframes), "
         f"error mean {np.mean(errs):.4f} m")
    _guard(np.mean(errs) < 0.15, f"front-end e2e error guard ({np.mean(errs):.4f} m)")

    pts_seq = torch.stack([p for p, _ in loaded[3:]])
    msk_seq = torch.stack([m for _, m in loaded[3:]])
    warm_pts = torch.stack([p for p, _ in loaded[:3]] + [loaded[0][0]] * (n_drive - 3))
    warm_msk = torch.stack([m for _, m in loaded[:3]] + [loaded[0][1]] * (n_drive - 3))
    front_end_drive(init_front_end_drive(cfg, init_pose=traj[0], device=card.dev), warm_pts, warm_msk, cfg)
    # the state's set-up (an empty grid) is one-time work, outside the timed runs
    st2 = init_front_end_drive(cfg, init_pose=traj[3], device=card.dev)
    dtd = float("inf")
    for _ in range(2):
        t, (_, dposes, dkfs, dunres) = _wall(card, lambda: front_end_drive(st2, pts_seq, msk_seq, cfg))
        dtd = min(dtd, t)
    # two alignments a frame with a map: every update but the first, every frame of the 3 drives but the first
    _launches(card, "front_end", **_align_expect(cfg.ndt, card.dev, 2 * (FRONT_END_FRAMES - 1 + 3 * (n_drive - 1))))
    # the drive restarts from an empty map at frame 3's pose: its transient is skipped
    errs_d = [np.linalg.norm(dposes[k][:3, 3].numpy() - traj[3 + k][:3, 3]) for k in range(3, n_drive)]
    _log(f"[front_end] drive {dtd / n_drive * 1e3:.2f} ms/frame ({int(dkfs.sum())} keyframes), error mean "
         f"{np.mean(errs_d):.4f} m, unresolved max {float(dunres.max())}")
    _guard(float(dunres.max()) == 0.0, "front-end drive: unresolved > 0")
    _guard(np.mean(errs_d) < 0.15, f"front-end drive error guard ({np.mean(errs_d):.4f} m)")

    slot = (fe.kf_cursor - 1) % cfg.local_frame_num
    origin_kf = FrontEnd._lattice_origin(np.asarray(fe.kf_poses[slot])[:3, 3], cfg.ndt, snap_mult=2.0)
    fine_cfg = dataclasses.replace(cfg.ndt, dense_stats=False)  # the tracking maps skip the dense stats
    coarse_cfg = coarse_tracking_cfg(cfg.ndt)

    def update():
        return _incremental_map_update(
            fe.fine_sums, fe.kf_world[slot], fe.kf_masks[slot], fe.kf_weights[slot],
            fe.kf_points[slot], fe.kf_masks[slot], fe.kf_weights[slot], fe.kf_poses[slot], origin_kf,
            fine_cfg, coarse_cfg,
        )

    update()  # warm-up
    reps = 10
    dtu, _ = _wall(card, lambda: [update() for _ in range(reps)])
    upd_ms = dtu / reps * 1e3
    _log(f"[front_end] incremental map update: {upd_ms:.2f} ms/keyframe (fine + coarse)")
    return n_timed / dt, upd_ms, n_drive / dtd


def matching_leg(card):
    """bench.py:706-800: Matching.update over MATCH_FRAMES frames (3 warm,
    the rest timed; guard 0.3 m), matching_drive over those (best of 2; emits
    matching_drive_fps), the OnlyPosition yaw search (emits
    matching_init_ms) and the local-map refresh (emits
    matching_refresh_ms). Returns Matching.update's frames/s."""
    from .io import SyntheticWorld, make_trajectory, simulate_spinning_scan
    from .ops import PointCloud, voxel_downsample
    from .pipeline.matching import Matching, matching_drive

    world = SyntheticWorld.corridor(length=120.0, width=18.0, density=30.0, seed=5)
    traj = make_trajectory(MATCH_FRAMES, speed=1.0)
    frames = [simulate_spinning_scan(world, traj[i], t=i * 0.1, n_scans=64, n_azimuth=MATCH_AZIMUTH, seed=700 + i)
              for i in range(MATCH_FRAMES)]
    # the world surface stands in for the viewer's filtered map
    m = Matching(matching_config(), world.points, device=card.dev)
    m.set_gnss_pose(traj[0])
    loaded = [m.preload(*f) for f in frames]  # the prefetch upload: outside the timed window
    _reset_launches()
    t0 = time.perf_counter()
    for i in range(3):
        m.update(None, preloaded=loaded[i])
    _log(f"[matching] warm-up: {time.perf_counter() - t0:.2f} s")
    n = MATCH_FRAMES - 3
    dt, poses = _wall(card, lambda: [m.update(None, preloaded=loaded[i]) for i in range(3, MATCH_FRAMES)])
    errs = [np.linalg.norm(poses[k][:3, 3] - traj[3 + k][:3, 3]) for k in range(n)]
    _log(f"[matching] {dt / n * 1e3:.2f} ms/frame, error mean {np.mean(errs):.4f} m")
    _guard(np.mean(errs) < 0.3, f"matching error guard ({np.mean(errs):.4f} m)")

    # the chained drive: the same work, between local-map refreshes
    pts_seq = torch.stack([p for p, _ in loaded[3:]])
    msk_seq = torch.stack([k for _, k in loaded[3:]])
    mcfg = m.cfg
    coarse_cfg = m._coarse_cfg() if mcfg.coarse_to_fine else None
    init = np.asarray(traj[3], np.float32)

    def drive():
        return matching_drive(m.ndt_map, m.coarse_ndt_map, pts_seq, msk_seq, init, mcfg, coarse_cfg)

    drive()  # warm-up
    dtd = float("inf")
    for _ in range(2):
        t, (dposes, dunres) = _wall(card, drive)
        dtd = min(dtd, t)
    per_frame = 2 if mcfg.coarse_to_fine else 1
    _launches(card, "matching", **_align_expect(mcfg.ndt, card.dev, per_frame * (MATCH_FRAMES + 3 * n)))
    errs_d = [np.linalg.norm(dposes[k][:3, 3].numpy() - traj[3 + k][:3, 3]) for k in range(n)]
    _guard(float(dunres.max()) == 0.0, "matching drive: unresolved > 0")
    _guard(np.mean(errs_d) < 0.3, f"matching drive error guard ({np.mean(errs_d):.4f} m)")
    _log(f"[matching] drive {dtd / n * 1e3:.2f} ms/frame, error mean {np.mean(errs_d):.4f} m")
    _emit(card, "matching_drive_fps", n / dtd, "frames/s", vs_baseline=n / dtd / 10.0)

    # the OnlyPosition yaw initialization (init-time only in production)
    pj, mj = loaded[3]
    m._pending_scan = voxel_downsample(PointCloud(points=pj, mask=mj), mcfg.frame_leaf,
                                       out_capacity=mcfg.frame_capacity)
    pos3 = np.asarray(traj[3][:3, 3], np.float32)
    m._initial_yaw(pos3)  # warm-up
    dti, yaws = _wall(card, lambda: [m._initial_yaw(pos3) for _ in range(5)])  # each reads its yaw on the host
    init_ms = dti / 5 * 1e3
    _log(f"[matching] yaw init ({mcfg.yaw_samples}-sample search): {init_ms:.2f} ms, yaw {yaws[-1]:.3f}")
    _emit(card, "matching_init_ms", init_ms, "ms")

    # the ResetLocalMap stall: host crop + voxel filter + fine/coarse map rebuild
    dtr, _ = _wall(card, lambda: [m.reset_local_map(pos3) for _ in range(3)])
    refresh_ms = dtr / 3 * 1e3
    travel = mcfg.box_size / 2.0 - mcfg.refresh_margin
    _log(f"[matching] local-map refresh: {refresh_ms:.2f} ms (every {travel:.0f} m of travel -> "
         f"{refresh_ms / max(travel, 1e-9):.3f} ms/frame at 1 m/frame)")
    _emit(card, "matching_refresh_ms", refresh_ms, "ms", amortized_ms_per_frame=refresh_ms / max(travel, 1e-9))
    return n / dt


def loop_verify_leg(card):
    """bench.py:803-851: LoopClosing over the 42-keyframe hairpin (one
    ndt_newton launch a verification attempt on the card) until a loop is
    detected; then Scan Context retrieval (5 timed) and the submap NDT
    verification of the detected pair (1 warm, 5 timed). Returns
    (detect ms, verify ms)."""
    from .io import KeyframeStore, SyntheticWorld, make_hairpin_trajectory, simulate_scan
    from .pipeline.loop_closing import LoopClosing

    world = SyntheticWorld.corridor(length=60.0, width=16.0, density=30.0, seed=9)
    gt = make_hairpin_trajectory(n_out=14, n_turn=16, n_back=12, speed=1.0, turn_radius=1.0)
    with tempfile.TemporaryDirectory() as root:
        store = KeyframeStore(root)
        lc = LoopClosing(loop_config(), store, device=card.dev)
        _reset_launches()
        detected = None
        for i in range(len(gt)):
            pts, mask, _ = simulate_scan(world, gt[i], t=i * 0.1, max_range=45.0, n_points=LOOP_SCAN_POINTS,
                                         seed=900 + i)
            kept = pts[mask]
            store.save(i, kept, np.ones(len(kept), bool), gt[i], time=i * 0.1)
            loop = lc.update(i, gt[i])
            if loop is not None and detected is None:
                detected = (loop.index0, loop.index1)
        _guard(detected is not None, "loop_verify_leg: no loop detected on the hairpin")

        idx0, idx1 = detected
        dt, _ = _wall(card, lambda: [lc.sc.detect() for _ in range(5)])
        detect_ms = dt / 5 * 1e3
        lc._verify(idx0, idx1, 0.0)  # warm-up
        dt, outs = _wall(card, lambda: [lc._verify(idx0, idx1, 0.0) for _ in range(5)])
        verify_ms = dt / 5 * 1e3
        out = outs[-1]
        _launches(card, "loop_verify", ndt_newton=lc.attempts)
        _guard(out is not None, "loop_verify_leg: verification rejected a true loop")
        _log(f"[loop] sc retrieval {detect_ms:.2f} ms, submap NDT verify {verify_ms:.2f} ms "
             f"(pair {idx0}->{idx1}, fitness {out.fitness:.3f}; {lc.attempts} verification attempts)")
    return detect_ms, verify_ms


def cpu_mode():
    """bench.py:854-875: the port's CPU path, gather="two_level" on the CPU,
    at the workload of the process that started this one (WORKLOAD_SIZES in
    BENCH_SIZES). It compiles nothing, so one warm frame replaces bench.py's
    compile run. Prints ndt_cpu_fps and ndt_cpu_fps_radius27."""
    sizes = json.loads(os.environ.get("BENCH_SIZES", "{}"))
    module = sys.modules[__name__]
    for name in WORKLOAD_SIZES:
        if name in sizes:
            setattr(module, name, tuple(sizes[name]) if isinstance(sizes[name], list) else sizes[name])
    card = Card(torch.device("cpu"), "cpu")
    _log(f"[cpu] torch {torch.__version__}, {torch.get_num_threads()} threads")
    cfg = ndt_config(gather="two_level")
    workload = build_workload(card.dev)
    fps, _ = scan_match_leg(card, "cpu two_level", cfg, workload, warm=1)
    _emit(card, "ndt_cpu_fps", fps, "frames/s")
    # the radius27 leg (radiusSearch semantics), so that the card's radius27 number has its baseline
    fps27, _ = scan_match_leg(card, "cpu radius27 two_level", dataclasses.replace(cfg, stencil="radius27"),
                              workload, warm=1)
    _emit(card, "ndt_cpu_fps_radius27", fps27, "frames/s")
    return 0


def cpu_baseline(card):
    """The CPU baseline's subprocess (BENCH_MODE=cpu, no card visible), run
    after the card's legs. Returns (ndt_cpu_fps, ndt_cpu_fps_radius27), None
    for a line it did not print."""
    module = sys.modules[__name__]
    sizes = {name: getattr(module, name) for name in WORKLOAD_SIZES}
    env = dict(os.environ, BENCH_MODE="cpu", BENCH_SIZES=json.dumps(sizes), CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-m", "lidar_slam_tpu_torch.bench"], env=env, stdout=subprocess.PIPE,
                              text=True, timeout=CPU_TIMEOUT, cwd=Path(__file__).resolve().parents[1])
        out, rc = proc.stdout, proc.returncode
    except subprocess.TimeoutExpired as e:
        out, rc = e.stdout or "", "timeout"
    _log(f"[cpu] baseline subprocess: exit {rc}, {time.perf_counter() - t0:.1f} s")
    if rc != 0:
        card.failed.append(f"CPU baseline: exit {rc}")
    values = {}
    for line in out.splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and rec.get("metric") in ("ndt_cpu_fps", "ndt_cpu_fps_radius27"):
            values[rec["metric"]] = rec["value"]
    return values.get("ndt_cpu_fps"), values.get("ndt_cpu_fps_radius27")


def run(card):
    """bench.py:878-1001's legs in bench.py's order; the CPU baseline after
    the card's legs. Returns the exit code."""
    stencil = os.environ.get("NDT_STENCIL", "direct7")
    gather = os.environ.get("NDT_GATHER", "fused")
    cfg = ndt_config(stencil=stencil, gather=gather, max_iter=int(os.environ.get("NDT_MAX_ITER", "30")),
                     max_compact=int(os.environ.get("NDT_MAX_COMPACT", "65536")),
                     fused_window=int(os.environ.get("NDT_FUSED_WINDOW", "512")))
    t0 = time.perf_counter()
    workload = build_workload(card.dev)
    _log(f"[workload] {int(workload[0].mask.sum())} map points, {N_FRAMES} scans: {time.perf_counter() - t0:.1f} s")

    def leg(name, fn, go_on=False):
        """fn()'s result, its seconds logged. With go_on (bench.py's `try`
        legs) a failure is logged and recorded, and None returned."""
        t0 = time.perf_counter()
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - bench.py's leg boundary: log it, go on, fail at the end
            if not go_on:
                raise
            _log(f"[{name}] FAILED: {e!r}")
            card.failed.append(f"{name}: {e!r}")
            return None
        finally:
            _log(f"[leg] {name}: {time.perf_counter() - t0:.1f} s")

    # the headline first (it matters most if anything downstream dies); its line prints last
    fps, iters_mean = leg("scan_match", lambda: scan_match_leg(card, f"{card.dev.type} {stencil} {gather}", cfg,
                                                               workload))
    leg("parity", lambda: derivative_parity_gate(card, cfg, workload))
    eval_ms, n_bytes, flops = leg("eval_probe", lambda: eval_probe(card, cfg, workload))
    ndt_mfu(card, fps, iters_mean, eval_ms, n_bytes, flops)
    fps_r27, _ = leg("scan_match_radius27", lambda: scan_match_leg(
        card, f"{card.dev.type} radius27 {gather}", dataclasses.replace(cfg, stencil="radius27"), workload))

    ms_per_iter, g_iters = leg("pose_graph", lambda: pose_graph_leg(card))
    # the reference's laptop log: 3.66 ms/iter at the same node and edge count
    _emit(card, "pose_graph_ms_per_iter", ms_per_iter, "ms/iter", vs_baseline=3.66 / ms_per_iter,
          iterations=g_iters)

    leg("solver_sweep", lambda: pose_graph_solver_sweep(card), go_on=True)
    leg("sc_growth", lambda: sc_growth_leg(card), go_on=True)
    aloam_fps = leg("aloam", lambda: aloam_leg(card), go_on=True)
    if aloam_fps is not None:
        _emit(card, "aloam_pipeline_fps", aloam_fps, "frames/s", vs_baseline=aloam_fps / 10.0)

    e2e_fps, upd_ms, drive_fps = leg("front_end", lambda: front_end_leg(card))
    _emit(card, "map_update_ms", upd_ms, "ms/keyframe")
    _emit(card, "front_end_e2e_fps", e2e_fps, "frames/s", vs_baseline=e2e_fps / 10.0)
    _emit(card, "front_end_drive_fps", drive_fps, "frames/s", vs_baseline=drive_fps / 10.0)

    match_fps = leg("matching", lambda: matching_leg(card), go_on=True)
    if match_fps is not None:
        _emit(card, "matching_fps", match_fps, "frames/s", vs_baseline=match_fps / 10.0)
    loop = leg("loop", lambda: loop_verify_leg(card), go_on=True)
    if loop is not None:
        detect_ms, verify_ms = loop
        # budget: the reference's generic 100 ms real-time stage warning
        _emit(card, "loop_verify_ms", detect_ms + verify_ms, "ms", vs_baseline=100.0 / max(detect_ms + verify_ms, 1e-9),
              sc_detect_ms=detect_ms, ndt_verify_ms=verify_ms)

    cpu_fps, cpu_fps27 = leg("cpu_baseline", lambda: cpu_baseline(card))
    if cpu_fps27:
        _emit(card, "ndt_cpu_fps_radius27", cpu_fps27, "frames/s", ran_on="cpu")
        _log(f"radius27 {card.dev.type}/CPU speedup: {fps_r27 / cpu_fps27:.2f}x")
        _emit(card, "ndt_scan_match_fps_radius27", fps_r27, "frames/s", vs_baseline=fps_r27 / cpu_fps27, baseline="cpu")
    else:
        _log("WARNING: CPU radius27 leg missing: vs_baseline is fps/10 Hz, NOT x CPU")
        _emit(card, "ndt_scan_match_fps_radius27", fps_r27, "frames/s", vs_baseline=fps_r27 / 10.0,
              baseline="realtime_10hz")
    if cpu_fps:
        _emit(card, "ndt_cpu_fps", cpu_fps, "frames/s", ran_on="cpu")
        _log(f"{card.dev.type}/CPU speedup: {fps / cpu_fps:.2f}x")
        _emit(card, "ndt_scan_match_fps", fps, "frames/s", vs_baseline=fps / cpu_fps, baseline="cpu")
    else:
        _log("WARNING: CPU baseline missing: vs_baseline is fps/10 Hz, NOT x CPU")
        _emit(card, "ndt_scan_match_fps", fps, "frames/s", vs_baseline=fps / 10.0, baseline="realtime_10hz")
    if card.failed:
        _log(f"FAILED: {card.failed}")
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lidar_slam_tpu_torch.bench", description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card; 'cpu' runs every leg on the CPU)")
    args = ap.parse_args(argv)
    if os.environ.get("BENCH_MODE") == "cpu":
        return cpu_mode()
    from . import device

    try:
        dev = device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    card = Card(dev, device_label(dev))
    _log(f"device: {card.label}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if card.cuda:
        from .cli import _build_kernels

        t0 = time.perf_counter()
        _build_kernels(["knn_fused", "ndt_fused", "ndt_gather", "ndt_newton"], log=False)
        _log(f"kernels built or found in {time.perf_counter() - t0:.1f} s")
    return run(card)


if __name__ == "__main__":
    sys.exit(main())
