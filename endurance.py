#!/usr/bin/env python3
"""The endurance run: the port's `mapping` command over a kilometre-long
drive at a real HDL-64 sweep density, with every pose-graph solve, the
device and host memory and the saved map's cut reported.

    python3 endurance.py [--out RECORD.npz]       # on a GPU
    JAX_PLATFORMS=cpu python3 endurance_witness.py RECORD.npz

The drive (endurance_drive) is a synthetic street corridor 16 m wide with
three trucks driving down it, and shuttle laps along it: straight legs of
LEG metres in two lanes TURN_RADIUS either side of the centre line, joined
by U-turns of that radius, at a car's speed profile (CRUISE metres a frame,
10.5 m/s at 10 Hz; the speed changes by at most ACCEL a frame per frame; the
U-turns at TURN_SPEED, 5.7 degrees of yaw a frame). Every frame carries a
131 072-row sweep with at least MIN_RETURNS finite returns, the trucks'
detector boxes and a GNSS fix (the truth's rotation, a seeded GNSS_NOISE
position noise). The drive runs until the back end's 2 m keyframe gate,
applied to the truth, leaves MIN_KEYFRAMES + KEYFRAME_MARGIN keyframes.
Scans are simulated lazily, one a frame, on the CLI's prefetch thread.

run_mapping drives `lidar_slam_tpu_torch.cli.main(["mapping", ...])`
in-process with the frame source replaced by the drive (config_text:
configs/kitti_hdl64.yaml with `gather: auto` named in the front end's ndt
section); everything else runs as a user runs it: the prefetch thread, the
upload, the watchdog, the keyframe store, the viewer, the final solve and
the map save. It records every pose-graph solve (the frame, the graph's
counts, LM iterations, seconds and whether the `back_end` stage or a loop
insertion started it), samples memory after the first frame, every
SAMPLE_EVERY keyframes and before the map save, and counts the kernels'
launches. report() computes
the trajectory errors, the loops' errors against the truth and the checks;
check() lists the checks that failed. `--out` saves the record that
endurance_witness.py replays through the JAX back end.

Exits non-zero when a check fails; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np

# The drive
CORRIDOR_LENGTH = 180.0  # m; the ground and walls start at x = -10
CORRIDOR_WIDTH = 16.0
DENSITY = 250.0  # world points a square metre-ish (SyntheticWorld.corridor): >= 100k returns at the legs' ends
WORLD_SEED = 13
X0 = 20.0  # the legs run from X0 to X0 + LEG
LEG = 130.0
TURN_RADIUS = 3.0
CRUISE = 1.05  # m a frame: two frames are 2.1 m, clear of the 2 m keyframe gate (at 1.0 every leg keyframe sits on it)
TURN_SPEED = 0.3  # m a frame in a U-turn: 0.1 rad of yaw a frame at TURN_RADIUS
ACCEL = 0.03  # m a frame per frame, 3 m/s^2
Z = 1.8
# trucks: 4 x 2 x 2 m boxes with 200 surface points a frame, as chip_smoke.py phase 18's
TRUCKS = (((25.0, 0.0, 1.0), 0.0, (0.8, 0.0)), ((155.0, 0.0, 1.0), math.pi, (-0.8, 0.0)),
          ((70.0, 0.0, 1.0), 0.0, (0.4, 0.0)))
RAW_ROWS = 131072  # an HDL-64 sweep's padded rows
MAX_RANGE = 80.0
SCAN_SEED = 20000
GNSS_NOISE = 0.10  # m (chip_smoke.py CLI_GNSS_NOISE)
GNSS_SEED = 8001
KEYFRAME_GATE = 2.0  # the back end's key_frame_distance (an L1 distance)
MIN_KEYFRAMES = 500
KEYFRAME_MARGIN = 10  # so that the odometry's own gate still leaves MIN_KEYFRAMES
MIN_RETURNS = 100_000

# The checks
MIN_LOOPS = 3
LOOP_TOL = 0.2  # m, an accepted loop's relative pose against the truth's (PERF.md section 2)
FITNESS_LIMIT = 0.2
OPT_ATE = 0.5  # m, the optimized keyframes (tests/test_kitti_e2e.py:159)
OPT_SLACK = 0.02  # m, reported: optimized against odometry (tests/test_kitti_e2e.py:155-158)
FRONT_END_MS = 100.0  # the front_end stage's mean (PERF.md section 2)
MEMORY_GROWTH = 64 * 2**20  # bytes of memory_allocated, keyframe SAMPLE_EVERY to the end
LOST_STEP = 0.3  # m, a frame-to-frame motion error that counts the frame as lost
LOST_REPLAY = 20  # frames before a lost frame from which replay_front_end starts
SAMPLE_EVERY = 50  # keyframes between memory samples


def config_text() -> str:
    """configs/kitti_hdl64.yaml with `gather: auto` named in the front end's
    ndt section: a nested section is built from NDTConfig's own defaults,
    so the file alone sets gather "two_level", the plain reduction in a
    host loop, where the FrontEndConfig default aligns in one ndt_newton
    launch (ROADMAP section C). The loop-closing section is the file's."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "kitti_hdl64.yaml")
    with open(path) as f:
        text = f.read()
    anchor = "    grid_dims: [256, 256, 64]\n"
    if text.count(anchor) != 1:
        raise ValueError(f"{path}: no single front_end ndt grid_dims line to name gather after")
    return text.replace(anchor, anchor + "    gather: auto   # the FrontEndConfig default\n")


# -- the drive ------------------------------------------------------------------------------------
@dataclass(frozen=True)
class Shuttle:
    """The lap's geometry: leg A along y = -radius heading +x from x0 to
    x0 + leg, U-turn A about (x0 + leg, 0), leg B along y = +radius heading
    -x, U-turn B about (x0, 0); both turns to the left."""

    x0: float = X0
    leg: float = LEG
    radius: float = TURN_RADIUS

    @property
    def arc(self) -> float:
        return math.pi * self.radius

    @property
    def lap(self) -> float:
        return 2.0 * (self.leg + self.arc)

    def segment(self, s: float):
        """(segment name, lap number, distance into the segment) at arc
        length s from the start."""
        lap, r = divmod(s, self.lap)
        for name, length in (("leg A", self.leg), ("U-turn A", self.arc), ("leg B", self.leg), ("U-turn B", self.arc)):
            if r < length:
                return name, int(lap), r
            r -= length
        return "U-turn B", int(lap), self.arc

    def pose(self, s: float, z: float = Z) -> np.ndarray:
        name, _, r = self.segment(s)
        x1 = self.x0 + self.leg
        if name == "leg A":
            x, y, yaw = self.x0 + r, -self.radius, 0.0
        elif name == "leg B":
            x, y, yaw = x1 - r, self.radius, math.pi
        else:
            cx = x1 if name == "U-turn A" else self.x0
            a = (-math.pi / 2 if name == "U-turn A" else math.pi / 2) + r / self.radius
            x, y, yaw = cx + self.radius * math.cos(a), self.radius * math.sin(a), a + math.pi / 2
        c, sn = math.cos(yaw), math.sin(yaw)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = [[c, -sn, 0.0], [sn, c, 0.0], [0.0, 0.0, 1.0]]
        T[:3, 3] = [x, y, z]
        return T

    def to_next_turn(self, s: float) -> float:
        """Metres from s to the start of the next U-turn; 0 inside one."""
        name, _, r = self.segment(s)
        return 0.0 if name.startswith("U-turn") else self.leg - r


def _brake_limit(d: float, cruise: float, turn: float, accel: float) -> float:
    """The largest speed from which braking by `accel` a frame covers no
    more than `d` metres before the speed is down to `turn`."""

    def braking_distance(v):
        total = 0.0
        while v > turn + 1e-12:
            total += v
            v -= accel
        return total

    lo, hi = turn, cruise
    if braking_distance(hi) <= d:
        return hi
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if braking_distance(mid) <= d else (lo, mid)
    return lo


def shuttle_arclength(n_frames: int, shuttle: Shuttle = Shuttle(), cruise: float = CRUISE, turn: float = TURN_SPEED,
                      accel: float = ACCEL) -> np.ndarray:
    """The arc length of every frame: from rest (the first step is `accel`),
    the speed rises and falls by at most `accel` a frame, up to `cruise` on
    the legs and `turn` in the U-turns, braking ahead of each turn so that
    no step at more than `turn` enters one."""
    s = np.zeros(n_frames)
    v = 0.0
    for k in range(1, n_frames):
        d = shuttle.to_next_turn(s[k - 1])
        limit = turn if d <= 0.0 else _brake_limit(d, cruise, turn, accel)
        v = min(v + accel, cruise, limit)
        s[k] = s[k - 1] + v
    return s


def gate_keyframes(poses, gate: float = KEYFRAME_GATE) -> list:
    """The frames at which the back end's keyframe gate (an L1 distance
    above `gate` from the last keyframe's position) makes a keyframe."""
    out, last = [], None
    for i, T in enumerate(np.asarray(poses, np.float32)):
        if last is None or np.abs(T[:3, 3] - last).sum() > gate:
            out.append(i)
            last = T[:3, 3].copy()
    return out


@dataclass
class Drive:
    """A world, the truth a frame, the GNSS fixes and the scans' settings;
    `frames()` simulates each frame's sweep when it is asked for."""

    world: object
    gt: np.ndarray  # [N, 4, 4] float32
    arclength: np.ndarray  # [N]
    shuttle: Shuttle
    gnss: np.ndarray  # [N, 4, 4] float64: the truth's rotation, the noisy position
    n_points: int = RAW_ROWS
    max_range: float = MAX_RANGE
    seed: int = SCAN_SEED
    world_params: dict = field(default_factory=dict)  # SyntheticWorld.corridor's and the trucks'
    source_s: list = field(default_factory=list)  # seconds to simulate each frame asked for
    returns: list = field(default_factory=list)  # finite returns of each frame asked for

    def __len__(self) -> int:
        return len(self.gt)

    def scan(self, i: int):
        """Frame i's sweep: (points [n_points, 3], mask, detector boxes)."""
        from lidar_slam_tpu_torch.io.synthetic import simulate_scan

        return simulate_scan(self.world, self.gt[i], t=i * 0.1, max_range=self.max_range, n_points=self.n_points,
                             seed=self.seed + i, noise=0.02)

    def frames(self, n: int = None):
        """The frame source's dicts, as the KITTI raw reader's with the
        detector boxes: each sweep's finite returns, time, GNSS."""
        for i in range(len(self) if n is None else n):
            t0 = time.perf_counter()
            pts, mask, boxes = self.scan(i)
            frame = {"points": pts[mask], "time": i * 0.1, "gnss_position": self.gnss[i, :3, 3].copy(),
                     "gnss_pose": self.gnss[i].copy(), "bboxes": boxes}
            self.source_s.append(time.perf_counter() - t0)
            self.returns.append(len(frame["points"]))
            yield frame

    def where(self, i: int) -> str:
        name, lap, r = self.shuttle.segment(self.arclength[i])
        return f"lap {lap + 1} {name} at {r:.1f} m"

    def lap_of(self, i: int) -> int:
        return self.shuttle.segment(self.arclength[i])[1]


def endurance_drive(min_keyframes: int = MIN_KEYFRAMES + KEYFRAME_MARGIN, n_frames: int = None,
                    shuttle: Shuttle = Shuttle(), length: float = CORRIDOR_LENGTH, width: float = CORRIDOR_WIDTH,
                    density: float = DENSITY, n_points: int = RAW_ROWS, max_range: float = MAX_RANGE,
                    cruise: float = CRUISE, turn: float = TURN_SPEED, accel: float = ACCEL,
                    trucks=TRUCKS, seed: int = WORLD_SEED) -> Drive:
    """The drive, made from its seeds: `n_frames` frames, or as many as the
    keyframe gate needs to leave `min_keyframes` keyframes on the truth."""
    from lidar_slam_tpu_torch.io.synthetic import SyntheticWorld

    world = SyntheticWorld.corridor(length=length, width=width, density=density, seed=seed)
    for center, heading, velocity in trucks:
        world.add_moving_box(center0=center, size=(4.0, 2.0, 2.0), heading=heading, velocity=velocity,
                             n_points=200)
    if n_frames is None:
        # a lap's frames are at least its length over the cruise speed; keep adding laps
        n = int(shuttle.lap / cruise)
        while True:
            s = shuttle_arclength(n, shuttle, cruise, turn, accel)
            kfs = gate_keyframes([shuttle.pose(v) for v in s])
            if len(kfs) >= min_keyframes:
                n_frames = kfs[min_keyframes - 1] + 1
                break
            n *= 2
    s = shuttle_arclength(n_frames, shuttle, cruise, turn, accel)
    gt = np.stack([shuttle.pose(v) for v in s])
    gnss = gt.astype(np.float64)
    gnss[:, :3, 3] += np.random.default_rng(GNSS_SEED).normal(0.0, GNSS_NOISE, (n_frames, 3))
    return Drive(world=world, gt=gt, arclength=s, shuttle=shuttle, gnss=gnss, n_points=n_points, max_range=max_range,
                 world_params=dict(length=length, width=width, density=density, seed=seed, trucks=trucks))


def first_lap_frames(drive: Drive) -> int:
    """The frames of the drive's first out-and-back: leg A, U-turn A and
    leg B, up to the start of U-turn B."""
    end = drive.shuttle.leg * 2 + drive.shuttle.arc
    return int(np.searchsorted(drive.arclength, end))


# -- the run ----------------------------------------------------------------------------------------
def _vm_rss() -> int:
    """This process's resident set, bytes (/proc/self/status)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/self/status has no VmRSS line")


def _tree_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(root) for f in files)


@dataclass
class Run:
    """What run_mapping recorded."""

    rc: int
    n_frames: int
    device: str
    out_dir: str
    config: str
    kf_frames: list  # the frame of each keyframe
    loop_edges: list  # (frame, index0, index1, relative pose [4, 4]) a loop insertion
    loops: list  # LoopClosing.detected
    attempts: int
    solves: list  # one dict a pose-graph solve
    memory: list  # one dict a sample
    health: dict  # RunHealth.summary()
    launches: dict  # by kernel
    saved_map: dict  # Viewer.save_map's
    optimized: np.ndarray  # [K, 4, 4] the final solve's keyframe poses
    loop_s: float  # the frame loop: the first frame's request to the final solve
    final_s: float  # the final solve, the map save and the trajectories
    source_ms: list  # the drive's simulation of each frame


def run_mapping(drive: Drive, out_dir: str, config_path: str, n_frames: int = None, device: str = None,
                sample_every: int = SAMPLE_EVERY) -> Run:
    """`lidar_slam_tpu_torch.cli.main(["mapping", ...])` over the drive's
    first `n_frames` frames (all by default), in-process, its frame source
    replaced by the drive and BackEnd, LoopClosing, Viewer and RunHealth by
    recording subclasses; `device` is the CLI's --device (the first card
    by default)."""
    import torch

    import lidar_slam_tpu_torch.pipeline as pipeline
    import lidar_slam_tpu_torch.utils.watchdog as watchdog
    from lidar_slam_tpu_torch import cli
    from lidar_slam_tpu_torch.ops.cuda import knn_fused, ndt_fused, ndt_gather, ndt_newton

    n = len(drive) if n_frames is None else n_frames
    on_card = device is None or str(device).startswith("cuda")
    kernels = {"ndt_newton": ndt_newton, "ndt_reduce_fused": ndt_fused, "window_knn": knn_fused,
               "gather_stats_onehot": ndt_gather}
    st = {"frame": -1, "kf_frames": [], "loop_edges": [], "solves": [], "memory": [], "by": "back_end"}
    objs = {}

    def sample(label):
        be, lc = objs["be"], objs.get("lc")
        g = be.graph
        rec = {"label": label, "frame": st["frame"], "keyframes": len(be.key_frames),
               "allocated": None, "max_allocated": None, "reserved": None, "vm_rss": _vm_rss(),
               "store_bytes": _tree_bytes(out_dir), "sc_count": None if lc is None else lc.sc.count,
               "sc_capacity": None if lc is None else lc.sc.capacity, "nodes": g.n_nodes, "max_nodes": g.max_nodes,
               "edges": g.n_edges, "max_edges": g.max_edges, "priors": g.n_priors, "max_priors": g.max_priors}
        if on_card:
            rec.update(allocated=torch.cuda.memory_allocated(), max_allocated=torch.cuda.max_memory_allocated(),
                       reserved=torch.cuda.memory_reserved())
        st["memory"].append(rec)

    base_be, base_lc, base_viewer = pipeline.BackEnd, pipeline.LoopClosing, pipeline.Viewer
    base_health, base_source = watchdog.RunHealth, cli._frame_source

    class RecordingBackEnd(base_be):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            objs["be"] = self

        def update(self, *a, **k):
            st["frame"] += 1
            new = super().update(*a, **k)
            if new:
                st["kf_frames"].append(st["frame"])
            if st["frame"] == 0:
                sample("frame 0")
            return new

        def insert_loop_pose(self, index0, index1, relative_pose):
            st["loop_edges"].append((st["frame"], index0, index1, np.asarray(relative_pose, np.float32)))
            st["by"] = "insert_loop_pose"
            try:
                super().insert_loop_pose(index0, index1, relative_pose)
            finally:
                st["by"] = "back_end"

        def force_optimize(self):
            st["t_final"] = time.perf_counter()
            st["by"] = "final"
            return super().force_optimize()

        def _optimize(self):
            g = self.graph
            counts = {"frame": st["frame"], "nodes": g.n_nodes, "edges": g.n_edges, "priors": g.n_priors,
                      "by": st["by"]}
            t0 = time.perf_counter()
            out = super()._optimize()
            st["solves"].append({**counts, "iterations": int(out["iterations"]), "seconds": time.perf_counter() - t0,
                                 "chi2_before": out["chi2_before"], "chi2_after": out["chi2_after"]})
            return out

    class RecordingLoops(base_lc):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            objs["lc"] = self

        def update(self, kf_index, *a, **k):
            out = super().update(kf_index, *a, **k)
            if (kf_index + 1) % sample_every == 0:
                sample(f"keyframe {kf_index + 1}")
            return out

    class RecordingViewer(base_viewer):
        def save_map(self):
            sample("end, before save_map")
            objs["map"] = super().save_map()
            return objs["map"]

    class RecordingHealth(base_health):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            objs["health"] = self

    def source(args):
        st["t_first"] = time.perf_counter()
        yield from drive.frames(n)

    with open(config_path) as f:
        config = f.read()
    argv = ["mapping", "--synthetic", str(n), "--config", config_path, "--out", out_dir]
    if device is not None:
        argv += ["--device", str(device)]
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for m in kernels.values():
        m.launches = 0
    drive.source_s.clear()
    drive.returns.clear()
    pipeline.BackEnd, pipeline.LoopClosing, pipeline.Viewer = RecordingBackEnd, RecordingLoops, RecordingViewer
    watchdog.RunHealth, cli._frame_source = RecordingHealth, source
    try:
        rc = cli.main(argv)
    finally:
        pipeline.BackEnd, pipeline.LoopClosing, pipeline.Viewer = base_be, base_lc, base_viewer
        watchdog.RunHealth, cli._frame_source = base_health, base_source
    end = time.perf_counter()
    be, lc = objs["be"], objs["lc"]
    return Run(rc=rc, n_frames=n, device="cuda" if on_card else str(device), out_dir=out_dir, config=config,
               kf_frames=st["kf_frames"], loop_edges=st["loop_edges"], loops=list(lc.detected), attempts=lc.attempts,
               solves=st["solves"], memory=st["memory"], health=objs["health"].summary(),
               launches={k: m.launches for k, m in kernels.items()}, saved_map=objs["map"],
               optimized=np.asarray(be.optimized_poses, np.float32), loop_s=st["t_final"] - st["t_first"],
               final_s=end - st["t_final"], source_ms=[t * 1e3 for t in drive.source_s])


# -- the report and the checks ------------------------------------------------------------------------
def report(run: Run, drive: Drive) -> dict:
    """The run's numbers against the truth: the odometry's errors over all
    frames and by lap, its worst frame, its lost frames (a frame-to-frame
    motion error above LOST_STEP), the keyframes' ATE for the odometry and
    the optimized poses, each loop's error against the truth."""
    from lidar_slam_tpu_torch.io.trajectory import ate_rmse, read_kitti_trajectory, umeyama_alignment

    n = run.n_frames
    gt = drive.gt[:n].astype(np.float64)
    odom = read_kitti_trajectory(os.path.join(run.out_dir, "trajectory", "laser_odom.txt"))
    if len(odom) != n:
        raise RuntimeError(f"laser_odom.txt holds {len(odom)} frames, the run {n}")
    R, t, _ = umeyama_alignment(odom[:, :3, 3], gt[:, :3, 3])
    err = np.linalg.norm(odom[:, :3, 3] @ R.T + t - gt[:, :3, 3], axis=1)
    laps = np.asarray([drive.lap_of(i) for i in range(n)])
    motion_err = motion_errors(odom, gt)
    lost = [int(i) for i in np.flatnonzero(motion_err > LOST_STEP)]
    kf = np.asarray(run.kf_frames)
    loops = []
    for (frame, i0, i1, rel), lp in zip(run.loop_edges, run.loops):
        truth = np.linalg.inv(gt[kf[i0]]) @ gt[kf[i1]]
        loops.append({"frame": frame, "index0": i0, "index1": i1, "fitness": float(lp.fitness),
                      "error": float(np.linalg.norm(rel[:3, 3] - truth[:3, 3]))})
    worst = int(err.argmax())
    return {
        "frames": n, "keyframes": len(kf), "attempts": run.attempts, "loops": loops, "rc": run.rc,
        "returns_min": min(drive.returns[:n]), "returns_mean": float(np.mean(drive.returns[:n])),
        "odometry_ate": ate_rmse(odom, gt),
        "odometry_ate_by_lap": {int(k) + 1: float(np.sqrt(np.mean(err[laps == k] ** 2))) for k in np.unique(laps)},
        "worst_frame": {"frame": worst, "error": float(err[worst]), "where": drive.where(worst)},
        "lost_frames": [{"frame": i, "motion_error": float(motion_err[i]), "where": drive.where(i)} for i in lost],
        "keyframe_ate_odometry": ate_rmse(odom[kf], gt[kf]), "keyframe_ate_optimized": ate_rmse(run.optimized, gt[kf]),
        "stages": run.health["stages"], "divergences": run.health["divergences"], "solves": run.solves,
        "memory": run.memory, "saved_map": run.saved_map, "launches": run.launches,
        "ms_per_frame": run.loop_s * 1e3 / n, "source_ms_per_frame": float(np.mean(run.source_ms[:n])),
        "final_s": run.final_s, "device": run.device,
    }


def check(rep: dict, min_keyframes: int = MIN_KEYFRAMES, min_loops: int = MIN_LOOPS,
          min_returns: int = MIN_RETURNS) -> list:
    """The checks that failed, as messages. The launch, front-end time and
    device memory checks hold only for a run on the card."""
    fails = []
    if rep["rc"] != 0:
        fails.append(f"the CLI exited {rep['rc']}")
    if rep["keyframes"] < min_keyframes:
        fails.append(f"{rep['keyframes']} keyframes, fewer than {min_keyframes}")
    if rep["returns_min"] < min_returns:
        fails.append(f"a scan with {rep['returns_min']} finite returns, fewer than {min_returns}")
    good = [lp for lp in rep["loops"] if lp["error"] <= LOOP_TOL and lp["fitness"] <= FITNESS_LIMIT]
    if len(rep["loops"]) < min_loops or len(good) < len(rep["loops"]):
        fails.append(f"loops {rep['loops']}: at least {min_loops} wanted, each within {LOOP_TOL} m of the truth "
                     f"and with fitness <= {FITNESS_LIMIT}")
    if not rep["keyframe_ate_optimized"] < OPT_ATE:
        fails.append(f"the optimized keyframes' ATE {rep['keyframe_ate_optimized']} m, not under {OPT_ATE}")
    if rep["device"] == "cuda":
        want = 2 * (rep["frames"] - 1) + rep["attempts"]
        got = rep["launches"]
        if got["ndt_newton"] != want or any(got[k] for k in got if k != "ndt_newton"):
            fails.append(f"launches {got}: ndt_newton {want} wanted (2 a frame after the first, 1 an attempt), "
                         f"the others none")
        fe = rep["stages"]["front_end"]["mean_ms"]
        if not fe < FRONT_END_MS:
            fails.append(f"the front_end stage's mean {fe} ms, not under {FRONT_END_MS}")
        first = next((m for m in rep["memory"] if m["keyframes"] >= SAMPLE_EVERY), None)
        last = rep["memory"][-1]
        growth = None if first is None else last["allocated"] - first["allocated"]
        if growth is None or not growth < MEMORY_GROWTH:
            fails.append(f"memory_allocated grew by {growth} bytes from keyframe {SAMPLE_EVERY} to the end "
                         f"(at most {MEMORY_GROWTH})")
    return fails


def print_report(rep: dict, label: str = "") -> None:
    """The report as lines, each tagged `[endurance<label>]`."""
    tag = f"[endurance{label}]"
    say = lambda s: print(f"{tag} {s}", flush=True)  # noqa: E731
    mib = lambda b: None if b is None else round(b / 2**20, 2)  # noqa: E731
    say(f"{rep['frames']} frames ({rep['device']}), {rep['keyframes']} keyframes, {rep['attempts']} verification "
        f"attempts, {len(rep['loops'])} loops accepted; returns a scan min {rep['returns_min']} mean "
        f"{rep['returns_mean']:.0f}")
    for lp in rep["loops"]:
        say(f"loop {lp['index0']} <- {lp['index1']} at frame {lp['frame']}: fitness {lp['fitness']:.4f}, relative "
            f"pose {lp['error']:.4f} m from the truth's")
    say(f"odometry ATE {rep['odometry_ate']:.4f} m; by lap "
        f"{ {k: round(v, 4) for k, v in rep['odometry_ate_by_lap'].items()} }; worst frame {rep['worst_frame']['frame']} "
        f"({rep['worst_frame']['where']}) {rep['worst_frame']['error']:.4f} m")
    say(f"lost frames (frame-to-frame motion error over {LOST_STEP} m): "
        f"{[(f['frame'], round(f['motion_error'], 4), f['where']) for f in rep['lost_frames']] or 'none'}")
    say(f"keyframe ATE: odometry {rep['keyframe_ate_odometry']:.4f} m, optimized {rep['keyframe_ate_optimized']:.4f} m "
        f"(tests/test_kitti_e2e.py:155-158 asks optimized <= odometry + {OPT_SLACK}: "
        f"{'held' if rep['keyframe_ate_optimized'] <= rep['keyframe_ate_odometry'] + OPT_SLACK else 'NOT held'}; "
        f"reported, not checked)")
    say(f"frame loop {rep['ms_per_frame']:.2f} ms a frame (wall, the first frame's request to the final solve); the "
        f"drive's simulation {rep['source_ms_per_frame']:.2f} ms a frame on the prefetch thread; final solve, map save "
        f"and trajectories {rep['final_s']:.2f} s")
    for name, s in rep["stages"].items():
        say(f"stage {name}: calls {s['calls']} mean_ms {s['mean_ms']} worst_ms {s['worst_ms']} misses {s['misses']} "
            f"(budget {s['budget_ms']} ms)")
    say(f"divergences {rep['divergences']}")
    for s in rep["solves"]:
        say(f"solve at frame {s['frame']} by {s['by']}: {s['nodes']} nodes, {s['edges']} edges, {s['priors']} priors, "
            f"{s['iterations']} LM iterations, {s['seconds']:.3f} s, chi2 {s['chi2_before']:.4f} -> "
            f"{s['chi2_after']:.4f}")
    for m in rep["memory"]:
        say(f"memory at {m['label']} (frame {m['frame']}, {m['keyframes']} keyframes): allocated "
            f"{mib(m['allocated'])} MiB, max_allocated {mib(m['max_allocated'])} MiB, reserved {mib(m['reserved'])} MiB, "
            f"VmRSS {mib(m['vm_rss'])} MiB, store {mib(m['store_bytes'])} MiB on disk, Scan Context {m['sc_count']} of "
            f"{m['sc_capacity']}, graph nodes {m['nodes']} of {m['max_nodes']}, edges {m['edges']} of "
            f"{m['max_edges']}, priors {m['priors']} of {m['max_priors']}")
    mp = rep["saved_map"]
    say(f"saved map: {mp['map_points'] + mp['map_capacity_dropped']} points offered to the joint map, "
        f"{mp['map_points']} kept, {mp['map_capacity_dropped']} dropped by map_capacity; filtered map "
        f"{mp['filtered_map_points']} points")
    say(f"launches {rep['launches']}")


def save_record(path: str, run: Run, drive: Drive) -> None:
    """The record endurance_witness.py replays: per frame the odometry,
    GNSS position and pose and the truth; the keyframes' frames; each loop
    edge with the frame that inserted it; each solve's frame and starter;
    the final optimized keyframe poses; the config file's text."""
    from lidar_slam_tpu_torch.io.trajectory import read_kitti_trajectory

    n = run.n_frames
    edges = run.loop_edges
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, odom=read_kitti_trajectory(os.path.join(run.out_dir, "trajectory", "laser_odom.txt")).astype(np.float32),
             gnss_position=drive.gnss[:n, :3, 3].astype(np.float32), gnss_pose=drive.gnss[:n].astype(np.float32),
             gt=drive.gt[:n], kf_frames=np.asarray(run.kf_frames, np.int64),
             loop_frames=np.asarray([e[0] for e in edges], np.int64),
             loop_index=np.asarray([e[1:3] for e in edges], np.int64).reshape(-1, 2),
             loop_rel=np.asarray([e[3] for e in edges], np.float32).reshape(-1, 4, 4),
             solve_frames=np.asarray([s["frame"] for s in run.solves], np.int64),
             solve_by=np.asarray([s["by"] for s in run.solves]), optimized=run.optimized,
             config=np.asarray(run.config), drive=np.asarray(json.dumps(
                 {**drive.world_params, "n_points": drive.n_points, "max_range": drive.max_range,
                  "scan_seed": drive.seed})))


def record_diff(path, other) -> list:
    """The arrays of the record at `path` that are not those of `other`
    (another run's record) to the bit, by name."""
    a, b = np.load(path), np.load(other)
    return [k for k in sorted(set(a.files) | set(b.files))
            if k not in a.files or k not in b.files or a[k].shape != b[k].shape or not np.array_equal(a[k], b[k])]


def motion_errors(poses, gt) -> np.ndarray:
    """Each frame's frame-to-frame motion error against the truth's, m
    (0 for the first)."""
    P, G = np.asarray(poses, np.float64), np.asarray(gt, np.float64)
    step = lambda T: np.einsum("nij,njk->nik", np.linalg.inv(T[:-1]), T[1:])[:, :3, 3]  # noqa: E731
    return np.concatenate([[0.0], np.linalg.norm(step(P) - step(G), axis=1)])


def replay_front_end(drive: Drive, record, frame: int, device: str = "cpu", before: int = LOST_REPLAY,
                     state_out: str = None) -> list:
    """The port's FrontEnd, configured by the record's config file and
    started with an empty map at the run's odometry `before` frames ahead of
    `frame`, over the drive's frames up to frame + 1: (frame, the replay's
    motion error, the run's) for each. endurance_witness.py --front-end
    replays the same through the JAX FrontEnd. With `state_out`, saves the
    front end's state at `frame` (save_front_end_state) for
    front_end_witness.py."""
    import tempfile

    from lidar_slam_tpu_torch.config import load_config
    from lidar_slam_tpu_torch.pipeline import FrontEnd
    from lidar_slam_tpu_torch.pipeline import front_end as fe_module

    k0, k1 = frame - before, frame + 2
    if not np.array_equal(record["gt"][k0:k1], drive.gt[k0:k1]):
        raise ValueError("the record is not of this drive")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "config.yaml")
        with open(path, "w") as f:
            f.write(str(record["config"]))
        cfg = load_config(path)
    fe = FrontEnd(cfg.front_end, device=device)
    fe.set_init_pose(record["odom"][k0])
    updates, tracked = [], []
    update, track = fe_module._incremental_map_update, fe_module._track_step

    def recording_update(*args):
        # (fine_sums, old_world, old_mask, old_weights, kf_points, kf_mask, kf_weights, pose, new_origin, cfgs)
        _, _, old_mask, _, kf_points, kf_mask, kf_weights, pose, new_origin = args[:9]
        updates.append(dict(points=kf_points.cpu().numpy(), mask=kf_mask.cpu().numpy(),
                            weights=kf_weights.cpu().numpy(), pose=np.asarray(pose, np.float32),
                            origin=np.asarray(new_origin, np.float32), evicts=bool(old_mask.any())))
        return update(*args)

    def recording_track(*args, **kwargs):
        tracked[:] = [track(*args, **kwargs)]
        return tracked[0]

    poses = []
    try:
        if state_out:
            fe_module._incremental_map_update, fe_module._track_step = recording_update, recording_track
        for i in range(k0, k1):
            pts, mask, boxes = drive.scan(i)
            if state_out and i == frame:
                before_frame = dict(fine_map=fe.ndt_map, coarse_map=fe.coarse_ndt_map, fine_sums=fe.fine_sums,
                                    guess=fe.predict_pose.copy(), n_updates=len(updates))
            poses.append(fe.update(pts[mask], bboxes=boxes)[0])
            if state_out and i == frame:
                before_frame["track"] = tracked[0]
    finally:
        fe_module._incremental_map_update, fe_module._track_step = update, track
    if state_out:
        save_front_end_state(state_out, fe, before_frame, updates, poses[-3:-1], drive.gt[frame - 1:frame + 1], record,
                             frame)
    mine, run = motion_errors(poses, drive.gt[k0:k1]), motion_errors(record["odom"][k0:k1], drive.gt[k0:k1])
    return [(k0 + j, float(mine[j]), float(run[j])) for j in range(k1 - k0)]


def save_front_end_state(path, fe, at, updates, poses, gt, record, frame) -> None:
    """The front end's state at the start of `frame`, as front_end_witness.py
    reads it: the frame's preprocessed points and mask (`_track_step`'s),
    the motion-model guess, the port's coarse and fine poses from it, the
    poses of frame - 1 and frame and the truth's, the coarse and fine maps
    (origin, keys, packed rows) and the fine sums (count, psum, ppsum and
    wsum of their nonzero voxels),
    and the inputs of every `_incremental_map_update` applied before the
    frame: each keyframe's points, weights and mask (the masked rows
    only), pose and new grid corner, and whether it evicted a keyframe.
    Also the record's config file and drive."""
    import torch

    from lidar_slam_tpu_torch.models.registration import ndt_align
    from lidar_slam_tpu_torch.ops import PointCloud
    from lidar_slam_tpu_torch.pipeline.front_end import coarse_tracking_cfg

    f_pts, f_mask, fine_pose, _ = at["track"]
    coarse_cfg = coarse_tracking_cfg(fe.cfg.ndt)
    coarse_pose = ndt_align(at["coarse_map"], PointCloud(points=f_pts, mask=f_mask), at["guess"], coarse_cfg).pose
    ups = updates[:at["n_updates"]]
    sums = at["fine_sums"]
    dense = torch.cat([sums.count[:, None], sums.psum, sums.ppsum, sums.wsum[:, None]], dim=1).cpu().numpy()
    nz = np.flatnonzero(np.any(dense != 0, axis=1))
    maps = {}
    for name in ("fine", "coarse"):
        m = at[f"{name}_map"]
        maps.update({f"{name}_origin": m.origin.numpy(), f"{name}_keys": m.keys.cpu().numpy(),
                     f"{name}_packed": m.packed.cpu().numpy(), f"{name}_dims": np.asarray(m.dims),
                     f"{name}_resolution": np.float32(m.resolution)})
    masks = np.stack([u["mask"] for u in ups])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path, frame=frame, frame_points=f_pts.cpu().numpy(), frame_mask=f_mask.cpu().numpy(), guess=at["guess"],
        coarse_pose=np.asarray(coarse_pose, np.float32), fine_pose=np.asarray(fine_pose, np.float32),
        poses=np.asarray(poses, np.float32), gt=np.asarray(gt, np.float32), **maps,
        sums_origin=sums.origin.numpy(), sums_dims=np.asarray(sums.dims), sums_resolution=np.float32(sums.resolution),
        sums_vid=nz.astype(np.int64), sums=dense[nz],
        kf_pose=np.stack([u["pose"] for u in ups]), kf_origin=np.stack([u["origin"] for u in ups]),
        kf_evicts=np.asarray([u["evicts"] for u in ups]), kf_mask=np.packbits(masks, axis=1),
        kf_capacity=masks.shape[1], kf_points=np.concatenate([u["points"][u["mask"]] for u in ups]),
        kf_weights=np.concatenate([u["weights"][u["mask"]] for u in ups]),
        config=np.asarray(str(record["config"])), drive=np.asarray(str(record["drive"])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="save the record (.npz) for endurance_witness.py")
    ap.add_argument("--work", default=os.path.join("build", "endurance"),
                    help="the mapping run's --out directory (removed at the end)")
    ap.add_argument("--device", default=None, help="the CLI's --device (default: the first CUDA card)")
    ap.add_argument("--replay-front-end", type=int, metavar="FRAME", help="with --record: replay_front_end up to "
                    "FRAME (a lost frame) from --before frames ahead of it, on --device (default cpu)")
    ap.add_argument("--before", type=int, default=LOST_REPLAY, help="with --replay-front-end: frames before FRAME")
    ap.add_argument("--state-out", metavar="F", help="with --replay-front-end: save the front end's state at FRAME "
                    "(.npz, e.g. under build/) for front_end_witness.py")
    ap.add_argument("--record", help="a record endurance.py --out wrote")
    ap.add_argument("--same-as", metavar="REC", help="with --out: fail unless the record equals REC, an earlier "
                    "run's record, array for array to the bit")
    args = ap.parse_args(argv)
    if args.same_as and not args.out:
        ap.error("--same-as needs --out")
    import shutil

    import torch

    if args.replay_front_end is not None:
        rows = replay_front_end(endurance_drive(), np.load(args.record), args.replay_front_end, args.device or "cpu",
                                args.before, args.state_out)
        for i, mine, run in rows:
            print(f"[replay] frame {i}: motion error {mine:.4f} m replayed, {run:.4f} m in the run"
                  + ("  <- lost" if max(mine, run) > LOST_STEP else ""))
        return 0

    if args.device is None and not torch.cuda.is_available():
        print("endurance: CUDA is not available (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    if "jax" in sys.modules:
        raise RuntimeError("the port imported jax")
    t0 = time.perf_counter()
    drive = endurance_drive()
    print(f"[endurance] drive: {len(drive)} frames, {drive.arclength[-1]:.1f} m, "
          f"{drive.arclength[-1] / drive.shuttle.lap:.2f} laps, {len(gate_keyframes(drive.gt))} keyframes on the "
          f"truth's gate, world {len(drive.world.points)} points ({time.perf_counter() - t0:.1f} s)", flush=True)
    config_path = args.work + "-config.yaml"
    os.makedirs(os.path.dirname(os.path.abspath(config_path)), exist_ok=True)
    with open(config_path, "w") as f:
        f.write(config_text())
    try:
        run = run_mapping(drive, args.work, config_path, device=args.device)
        rep = report(run, drive)
        if args.out:
            save_record(args.out, run, drive)
    finally:
        shutil.rmtree(args.work, ignore_errors=True)
        os.remove(config_path)
    print_report(rep)
    if run.device == "cuda":
        from lidar_slam_tpu_torch.bench import device_label

        print(f"[endurance] {device_label(torch.device('cuda'))}")
    fails = check(rep)
    if args.same_as:
        differ = record_diff(args.out, args.same_as)
        print(f"[endurance] the record against {args.same_as}: {len(np.load(args.out).files) - len(differ)} arrays "
              f"equal to the bit, differing {differ}")
        if differ:
            fails.append(f"the record differs from {args.same_as} in {differ}")
    for msg in fails:
        print(f"[endurance] FAILED: {msg}", flush=True)
    print(json.dumps({"ok": not fails, "frames": rep["frames"], "keyframes": rep["keyframes"],
                      "loops": len(rep["loops"]), "keyframe_ate_optimized": rep["keyframe_ate_optimized"]}))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
