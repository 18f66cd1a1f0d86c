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

`--front-end aloam` runs `mapping --front-end aloam` over the same drive
(aloam_drive): the same world at ALOAM_DENSITY, trucks, truth, GNSS and
keyframes, each sweep simulate_spinning_scan's 64 x 2 048 panorama
(N_SCANS x N_AZIMUTH rows, a real HDL-64's ring layout, which A-LOAM's
feature extraction needs), simulated by SIM_WORKERS processes ahead of the
frame loop. The CLI sizes its A-LOAM sweep at its configuration's
`aloam.features.capacity` (131 072 without a section; the JAX CLI's 65 536
under `--synthetic`); run_mapping gives it the drive's RAW_ROWS and checks that no sweep holds more returns than that. It
also records each sweep's corner and surf map fill, and K2 (window_knn)
runs K2_PER_SWEEP times a sweep on the card. `--aloam-states auto
--states-out F` keeps the port's A-LOAM state before and after five frames
(AloamPicks) for aloam_witness.py, which runs the JAX `aloam_step` there.

    python3 endurance.py --front-end aloam --out REC.npz --aloam-states auto --states-out STATES.npz
    JAX_PLATFORMS=cpu python3 endurance_witness.py REC.npz
    JAX_PLATFORMS=cpu python3 aloam_witness.py STATES.npz

Exits non-zero when a check fails; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
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
# The A-LOAM drive: a spinning panorama of N_SCANS rings (hdl64_elevations) by N_AZIMUTH bins, RAW_ROWS rows;
# a real HDL-64 turns ~2 083 azimuths at 10 Hz
N_SCANS = 64
N_AZIMUTH = RAW_ROWS // N_SCANS
SPIN_MIN_RANGE = 2.5  # m, the CLI's FeatureExtractionConfig min_range
ALOAM_DENSITY = 10000.0  # at DENSITY a panorama holds 25-26k returns, under MIN_RETURNS (PERF.md section 4)
SIM_WORKERS = 6  # processes simulating the A-LOAM drive's sweeps ahead of the frame loop
SIM_CHECK_EVERY = 100  # frames between checks that a sweep of the visible points is the whole world's
SIM_NICE = 19  # the simulating processes' niceness: the mapping process keeps its share of the CPU

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
K2_PER_SWEEP = 10  # window_knn: odometry 3 outer rounds x (corner, surf), mapping 2 x (corner, surf), every sweep
ALOAM_GUARD = 0.3  # m, bench.py aloam_leg's mean pose-error guard (reported, not checked)


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
    spinning: bool = False  # simulate_spinning_scan's panorama (the A-LOAM drive), else simulate_scan's returns
    params: dict = field(default_factory=dict)  # endurance_drive's arguments: a worker process rebuilds the drive
    workers: int = 0  # processes that simulate the sweeps ahead of frames(); 0: one at a time, in this process
    source_s: list = field(default_factory=list)  # seconds to simulate each frame asked for
    returns: list = field(default_factory=list)  # finite returns of each frame asked for

    def __len__(self) -> int:
        return len(self.gt)

    def scan(self, i: int, whole_world: bool = False):
        """Frame i's sweep: (points [n_points, 3], mask, detector boxes). A
        spinning sweep is simulated over visible_world(i), which gives the
        whole world's panorama to the bit (SIM_CHECK_EVERY checks it) in
        about half the time; `whole_world` simulates over every point."""
        from lidar_slam_tpu_torch.io.synthetic import bboxes_for, simulate_scan, simulate_spinning_scan

        t = i * 0.1
        if not self.spinning:
            return simulate_scan(self.world, self.gt[i], t=t, max_range=self.max_range, n_points=self.n_points,
                                 seed=self.seed + i, noise=0.02)
        world = self.world if whole_world else self.visible_world(i)
        pts, mask = simulate_spinning_scan(world, self.gt[i], t=t, n_scans=N_SCANS, n_azimuth=self.n_points // N_SCANS,
                                           max_range=self.max_range, min_range=SPIN_MIN_RANGE, noise=0.02,
                                           seed=self.seed + i)
        return pts, mask, bboxes_for(self.world, self.gt[i], t)

    def visible_world(self, i: int):
        """The world with only the static points that frame i's spinning
        sweep can see: within max_range + 1 m and between the lowest and the
        highest beam's gates widened by 0.5 degrees (the poses turn about z
        only). simulate_spinning_scan drops every other point itself, and its
        arithmetic is row by row, so the panorama is the whole world's."""
        from lidar_slam_tpu_torch.io.synthetic import SyntheticWorld, hdl64_elevations

        T = self.gt[i]
        if not np.allclose(T[2, :3], (0.0, 0.0, 1.0)):
            return self.world
        if not hasattr(self, "_by_x"):
            pts = self.world.points
            self._by_x = pts[np.argsort(pts[:, 0], kind="stable")]
        el = hdl64_elevations()
        hi, lo = (math.tan(math.radians(e)) for e in (el.max() + 0.7, el.min() - 0.7))  # the 0.2-degree gate + 0.5
        reach = self.max_range + 1.0
        p = T[:3, 3]
        a, b = np.searchsorted(self._by_x[:, 0], (p[0] - reach, p[0] + reach))
        s = self._by_x[a:b]
        dx, dy, dz = s[:, 0] - p[0], s[:, 1] - p[1], s[:, 2] - p[2]
        h2 = dx * dx + dy * dy
        h = np.sqrt(h2)
        near = max(SPIN_MIN_RANGE - 1.0, 0.0)
        keep = (h2 + dz * dz <= reach**2) & (h2 + dz * dz >= near**2) & (dz <= hi * h + 0.01) & (dz >= lo * h - 0.01)
        return SyntheticWorld(points=s[keep], boxes=self.world.boxes)

    def frame(self, i: int) -> dict:
        """Frame i as the frame source gives it, as the KITTI raw reader's
        with the detector boxes: the sweep's finite returns, time, GNSS;
        and the seconds its simulation took."""
        t0 = time.perf_counter()
        pts, mask, boxes = self.scan(i)
        if self.spinning and i % SIM_CHECK_EVERY == 0:
            whole = self.scan(i, whole_world=True)
            if not (np.array_equal(whole[0], pts) and np.array_equal(whole[1], mask)):
                raise RuntimeError(f"frame {i}: the visible world's sweep is not the whole world's")
        return {"points": pts[mask], "time": i * 0.1, "gnss_position": self.gnss[i, :3, 3].copy(),
                "gnss_pose": self.gnss[i].copy(), "bboxes": boxes, "sim_s": time.perf_counter() - t0}

    def frames(self, n: int = None):
        """The frame source: frame(i) for the first n frames (all by
        default), simulated in `workers` processes ahead of the consumer
        when there are any."""
        n = len(self) if n is None else n
        for f in (self._pooled(n) if self.workers else map(self.frame, range(n))):
            self.source_s.append(f.pop("sim_s"))
            self.returns.append(len(f["points"]))
            yield f

    def start(self, n: int) -> None:
        """Start the worker processes on the first n frames now, all of them
        queued at once, for a frames() call to take later (chip_smoke.py
        simulates phase 22's sweeps while the earlier phases run); stop()
        ends them."""
        ex = self._pool()
        self._started = (ex, [ex.submit(_worker_frame, i) for i in range(n)])

    def stop(self) -> None:
        """End start()'s processes, their frames done or not."""
        started = getattr(self, "_started", None)
        self._started = None
        if started is not None:
            started[0].shutdown(wait=True, cancel_futures=True)

    def _pool(self):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        return ProcessPoolExecutor(self.workers, mp_context=multiprocessing.get_context("spawn"),
                                   initializer=_worker_init, initargs=(self.params,))

    def _pooled(self, n: int):
        """frame(i) for i < n from a pool of `workers` spawned processes at
        SIM_NICE, each of which rebuilds the drive from `params`, at most
        two frames a worker ahead of the consumer (or all that start()
        queued), in order."""
        from collections import deque

        started = getattr(self, "_started", None)
        self._started = None
        ex, queued = started if started is not None else (self._pool(), [])
        pending, ahead = deque(queued[:n]), iter(range(len(queued), n))
        try:
            for i in ahead:
                pending.append(ex.submit(_worker_frame, i))
                if len(pending) >= 2 * self.workers:
                    break
            while pending:
                yield pending.popleft().result()
                for i in ahead:
                    pending.append(ex.submit(_worker_frame, i))
                    break
        finally:
            ex.shutdown(wait=True, cancel_futures=True)

    def where(self, i: int) -> str:
        name, lap, r = self.shuttle.segment(self.arclength[i])
        return f"lap {lap + 1} {name} at {r:.1f} m"

    def lap_of(self, i: int) -> int:
        return self.shuttle.segment(self.arclength[i])[1]

    def in_turn(self, i: int) -> bool:
        return self.shuttle.segment(self.arclength[i])[0].startswith("U-turn")


_WORKER = {}


def _worker_init(params: dict) -> None:
    # the simulation is the harness's work, not the program's: the frame loop's process comes first
    os.nice(SIM_NICE)
    _WORKER["drive"] = endurance_drive(**params)


def _worker_frame(i: int) -> dict:
    return _WORKER["drive"].frame(i)


def endurance_drive(min_keyframes: int = MIN_KEYFRAMES + KEYFRAME_MARGIN, n_frames: int = None,
                    shuttle: Shuttle = Shuttle(), length: float = CORRIDOR_LENGTH, width: float = CORRIDOR_WIDTH,
                    density: float = DENSITY, n_points: int = RAW_ROWS, max_range: float = MAX_RANGE,
                    cruise: float = CRUISE, turn: float = TURN_SPEED, accel: float = ACCEL,
                    trucks=TRUCKS, seed: int = WORLD_SEED, spinning: bool = False) -> Drive:
    """The drive, made from its seeds: `n_frames` frames, or as many as the
    keyframe gate needs to leave `min_keyframes` keyframes on the truth;
    `spinning` sweeps (n_points a multiple of N_SCANS) for A-LOAM."""
    from lidar_slam_tpu_torch.io.synthetic import SyntheticWorld

    params = dict(min_keyframes=min_keyframes, n_frames=n_frames, shuttle=shuttle, length=length, width=width,
                  density=density, n_points=n_points, max_range=max_range, cruise=cruise, turn=turn, accel=accel,
                  trucks=trucks, seed=seed, spinning=spinning)
    if spinning and n_points % N_SCANS:
        raise ValueError(f"a spinning sweep of {n_points} rows is not {N_SCANS} rings")
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
                 world_params=dict(length=length, width=width, density=density, seed=seed, trucks=trucks),
                 spinning=spinning, params=params)


def aloam_drive(workers: int = SIM_WORKERS, **kw) -> Drive:
    """The A-LOAM drive: endurance_drive's at ALOAM_DENSITY with spinning
    sweeps, simulated by `workers` processes."""
    drive = endurance_drive(**{"density": ALOAM_DENSITY, **kw, "spinning": True})
    drive.workers = workers
    return drive


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
    front_end: str = "ndt"
    capacity: int = None  # rows of the A-LOAM front end's padded sweep
    cli_capacity: int = None  # the rows the CLI's own rule asked for
    fill: np.ndarray = None  # [n, 2] the A-LOAM corner and surf maps' points after each frame
    fill_capacity: tuple = None  # (corner, surf) map capacities
    drops: np.ndarray = None  # [n, 2, 4] fold_drops' (voxels offered, dropped, dropped x min, max) a frame and map
    picks: dict = None  # AloamPicks' kept A-LOAM states, by reason
    aloam_configs: tuple = None  # the A-LOAM front end's (feature extraction, odometry, mapping) configs


def fold_drops(before, after, pose, cfg, fill) -> list:
    """What the step's map fold (mapping.map_update) dropped at each map's
    capacity: [[voxels offered, dropped, the dropped voxels' least and
    largest x in the map frame] for the corner and the surf map]. A map
    under its capacity dropped nothing (the fold keeps min(offered,
    capacity) voxels). A full one's fold is replayed on the same inputs
    without the capacity: the state before the frame's maps, the frame's
    features (the state after holds them) and pose (the step's T_map: the
    CLI's odometry starts at the identity). The fold keeps the map around
    the sensor (mapping.keep_near): it drops the voxels farthest from the
    sensor, those outside laserMapping's window first."""
    import torch

    from lidar_slam_tpu_torch.geom.se3 import transform_points
    from lidar_slam_tpu_torch.ops.pointcloud import PointCloud, voxel_downsample
    from lidar_slam_tpu_torch.pipeline.aloam.mapping import downsample_stacks, keep_near

    out, stacks, T = [], None, None
    for j, (name, leaf) in enumerate((("corner", cfg.line_res), ("surf", cfg.plane_res))):
        m, cap = getattr(before, f"{name}_map"), getattr(after, f"{name}_map").capacity
        if fill[j] < cap:
            out.append([float(fill[j]), 0.0, math.nan, math.nan])
            continue
        if stacks is None:
            stacks = downsample_stacks(after.prev_less_sharp, after.prev_less_flat, cfg)
            T = torch.as_tensor(np.asarray(pose, np.float32), device=m.points.device)
        pts = torch.cat([m.points, transform_points(T, stacks[j].points)], dim=0)
        msk = torch.cat([m.mask, stacks[j].mask], dim=0) & torch.all(torch.abs(pts - T[:3, 3]) <= cfg.crop_radius,
                                                                       dim=-1)
        full = voxel_downsample(PointCloud(points=pts, mask=msk), leaf)
        dropped = full.mask & ~keep_near(full, T[:3, 3], cap)[1]
        x = torch.where(dropped, full.points[:, 0], math.nan)
        offered, lo, hi = torch.stack([full.mask.sum().float(), x.nan_to_num(math.inf).min(),
                                       x.nan_to_num(-math.inf).max()]).tolist()
        out.append([offered, offered - cap, lo, hi] if offered > cap else [offered, 0.0, math.nan, math.nan])
    return out


class AloamPicks:
    """The A-LOAM states that aloam_witness.py replays, kept as device
    references while the run goes on (a step never writes a state it was
    given): for each reason, the frame, the state before it, its padded
    sweep, the state after it and its pose. `frames` names frames, or is
    "auto": frame 2, the first frame whose warm start is an odometry
    result; the leg frame whose maps were the fullest when it started; the
    U-turn frame and the frame of any segment with the largest motion
    error; the last frame."""

    def __init__(self, frames, gt, n: int, in_turn):
        self.auto = frames == "auto"
        self.named = {} if self.auto else {int(f): f"frame {int(f)}" for f in frames}
        self.gt, self.n, self.in_turn = np.asarray(gt, np.float64), n, in_turn
        self.kept, self.best, self.prev_pose, self.prev_fill = {}, {}, None, -1

    def after(self, i, before, sweep, after, pose, fill):
        """Frame i's step has run: keep it under each reason it now leads."""
        entry = dict(frame=i, before=before, sweep=sweep, after=after, pose=np.asarray(pose, np.float32))
        reasons = [self.named[i]] if i in self.named else []
        if self.auto:
            if i == 2:
                reasons.append("first warm-started odometry")
            if i == self.n - 1:
                reasons.append("last frame")
            err = 0.0
            if self.prev_pose is not None:
                err = float(motion_errors([self.prev_pose, pose], self.gt[i - 1:i + 1])[1])
            turn = self.in_turn(i)
            score = {"fullest maps on a leg": None if turn else self.prev_fill, "worst U-turn frame":
                     err if turn else None, "worst frame": err if i > 0 else None}
            for reason, s in score.items():
                if s is not None and s > self.best.get(reason, -1.0):
                    self.best[reason] = s
                    reasons.append(reason)
            self.prev_pose, self.prev_fill = np.asarray(pose, np.float64), sum(fill)
        for reason in reasons:
            self.kept[reason] = entry

    def held_bytes(self, live) -> int:
        """Device bytes that only the kept states hold (not `live`'s)."""
        import torch

        def storages(x, out):
            if isinstance(x, torch.Tensor):
                out[x.untyped_storage().data_ptr()] = x.untyped_storage().nbytes()
            elif isinstance(x, (tuple, list)):
                for y in x:
                    storages(y, out)
            elif hasattr(x, "__dataclass_fields__"):
                for name in x.__dataclass_fields__:
                    storages(getattr(x, name), out)
            return out

        held = storages([[e["before"], e["sweep"], e["after"]] for e in self.kept.values()], {})
        live = storages(live, {})
        return sum(b for p, b in held.items() if p not in live)


def run_mapping(drive: Drive, out_dir: str, config_path: str, n_frames: int = None, device: str = None,
                sample_every: int = SAMPLE_EVERY, front_end: str = "ndt", aloam_configs=None,
                aloam_states=None) -> Run:
    """`lidar_slam_tpu_torch.cli.main(["mapping", ...])` over the drive's
    first `n_frames` frames (all by default), in-process, its frame source
    replaced by the drive and BackEnd, LoopClosing, Viewer and RunHealth by
    recording subclasses; `device` is the CLI's --device (the first card
    by default). With `front_end="aloam"`, `mapping --front-end aloam`:
    the CLI's A-LOAM front end (cli._AloamFrontEnd) at the drive's sweep
    rows, or at `aloam_configs` (feature extraction, odometry, mapping), in
    a subclass that records the maps' fill after each frame; `aloam_states`
    ("auto" or frames) keeps AloamPicks' states."""
    import torch

    import lidar_slam_tpu_torch.pipeline as pipeline
    import lidar_slam_tpu_torch.utils.watchdog as watchdog
    from lidar_slam_tpu_torch import cli
    from lidar_slam_tpu_torch.ops.cuda import knn_fused, ndt_fused, ndt_gather, ndt_newton
    from lidar_slam_tpu_torch.pipeline.aloam import AloamPipeline

    if front_end not in ("ndt", "aloam"):
        raise ValueError(f"unknown front end {front_end!r}")
    n = len(drive) if n_frames is None else n_frames
    on_card = device is None or str(device).startswith("cuda")
    kernels = {"ndt_newton": ndt_newton, "ndt_reduce_fused": ndt_fused, "window_knn": knn_fused,
               "gather_stats_onehot": ndt_gather}
    st = {"frame": -1, "kf_frames": [], "loop_edges": [], "solves": [], "memory": [], "by": "back_end", "fill": [],
          "drops": []}
    objs = {}
    picks = None if aloam_states is None else AloamPicks(aloam_states, drive.gt[:n], n, drive.in_turn)

    def sample(label):
        be, lc, fe = objs["be"], objs.get("lc"), objs.get("fe")
        g = be.graph
        rec = {"label": label, "frame": st["frame"], "keyframes": len(be.key_frames),
               "allocated": None, "max_allocated": None, "reserved": None, "vm_rss": _vm_rss(),
               "store_bytes": _tree_bytes(out_dir), "sc_count": None if lc is None else lc.sc.count,
               "sc_capacity": None if lc is None else lc.sc.capacity, "nodes": g.n_nodes, "max_nodes": g.max_nodes,
               "edges": g.n_edges, "max_edges": g.max_edges, "priors": g.n_priors, "max_priors": g.max_priors,
               "corner_map": None, "corner_capacity": None, "surf_map": None, "surf_capacity": None, "held": 0}
        if fe is not None:
            s = fe.state
            rec.update(corner_map=int(s.corner_map.mask.sum()), corner_capacity=s.corner_map.capacity,
                       surf_map=int(s.surf_map.mask.sum()), surf_capacity=s.surf_map.capacity)
            if picks is not None and on_card:
                rec["held"] = picks.held_bytes([s, fe.before])
        if on_card:
            rec.update(allocated=torch.cuda.memory_allocated(), max_allocated=torch.cuda.max_memory_allocated(),
                       reserved=torch.cuda.memory_reserved())
        st["memory"].append(rec)

    class RecordingAloam(AloamPipeline):
        before = None

        def update(self, points, mask=None, bboxes=None, preloaded=None):
            self.before, self.sweep = self.state, preloaded if preloaded is not None else self.preload(points, mask)
            return super().update(points, mask, bboxes, self.sweep)

    def aloam_front_end(config, device=None):
        """cli._AloamFrontEnd's pipeline at the drive's sweep rows (the CLI
        asks its config's `aloam.features.capacity`), or at aloam_configs,
        recording."""
        cfgs = aloam_configs
        if cfgs is None:
            cfgs = (dataclasses.replace(config.features, capacity=drive.n_points), config.odometry, config.mapping)
        st["cli_capacity"] = config.features.capacity
        objs["fe"] = RecordingAloam(*cfgs, device=device)
        return objs["fe"]

    base_be, base_lc, base_viewer = pipeline.BackEnd, pipeline.LoopClosing, pipeline.Viewer
    base_health, base_source, base_aloam = watchdog.RunHealth, cli._frame_source, cli._AloamFrontEnd

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

        def frame(self, pose, *a, **k):
            # the CLI calls this after the front_end stage: the A-LOAM maps' fill, and what a full map's fold
            # dropped, are read here, outside it
            out = super().frame(pose, *a, **k)
            fe = objs.get("fe")
            if fe is not None:
                s = fe.state
                fill = torch.stack([s.corner_map.mask.sum(), s.surf_map.mask.sum()]).tolist()
                st["fill"].append(fill)
                st["drops"].append(fold_drops(fe.before, s, pose, fe.map_cfg, fill))
                if picks is not None:
                    picks.after(len(st["fill"]) - 1, fe.before, fe.sweep, s, pose, fill)
            return out

    def source(args):
        st["t_first"] = time.perf_counter()
        yield from drive.frames(n)

    with open(config_path) as f:
        config = f.read()
    argv = ["mapping", "--synthetic", str(n), "--config", config_path, "--out", out_dir, "--front-end", front_end]
    if device is not None:
        argv += ["--device", str(device)]
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for m in kernels.values():
        m.launches = 0
    drive.source_s.clear()
    drive.returns.clear()
    pipeline.BackEnd, pipeline.LoopClosing, pipeline.Viewer = RecordingBackEnd, RecordingLoops, RecordingViewer
    watchdog.RunHealth, cli._frame_source, cli._AloamFrontEnd = RecordingHealth, source, aloam_front_end
    try:
        rc = cli.main(argv)
    finally:
        pipeline.BackEnd, pipeline.LoopClosing, pipeline.Viewer = base_be, base_lc, base_viewer
        watchdog.RunHealth, cli._frame_source, cli._AloamFrontEnd = base_health, base_source, base_aloam
    end = time.perf_counter()
    be, lc, fe = objs["be"], objs["lc"], objs.get("fe")
    run = Run(rc=rc, n_frames=n, device="cuda" if on_card else str(device), out_dir=out_dir, config=config,
              kf_frames=st["kf_frames"], loop_edges=st["loop_edges"], loops=list(lc.detected), attempts=lc.attempts,
              solves=st["solves"], memory=st["memory"], health=objs["health"].summary(),
              launches={k: m.launches for k, m in kernels.items()}, saved_map=objs["map"],
              optimized=np.asarray(be.optimized_poses, np.float32), loop_s=st["t_final"] - st["t_first"],
              final_s=end - st["t_final"], source_ms=[t * 1e3 for t in drive.source_s], front_end=front_end)
    if fe is not None:
        run.capacity, run.cli_capacity = fe.fe_cfg.capacity, st["cli_capacity"]
        run.fill = np.asarray(st["fill"], np.int64).reshape(-1, 2)
        run.drops = np.asarray(st["drops"], np.float64).reshape(-1, 2, 4)
        run.fill_capacity = (fe.state.corner_map.capacity, fe.state.surf_map.capacity)
        run.picks = None if picks is None else picks.kept
        run.aloam_configs = (fe.fe_cfg, fe.odo_cfg, fe.map_cfg)
    return run


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
        "final_s": run.final_s, "device": run.device, "front_end": run.front_end,
    } | (aloam_report(run, drive, odom, gt) if run.front_end == "aloam" else {})


def aloam_report(run: Run, drive: Drive, odom, gt) -> dict:
    """The A-LOAM front end's numbers: the sweep rows it ran with and the
    frames that held more returns (a cut sweep), the maps' fill against
    their capacities (largest, last, the frames at capacity), what the
    folds at capacity dropped (fold_drops: in how many frames, from which,
    the most voxels in one frame and where, the dropped voxels' x range in
    the map frame), and the mean pose error anchored at frame 0 (the CLI's
    odometry starts at the identity), bench.py aloam_leg's measure."""
    n = run.n_frames
    anchored = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    err = np.linalg.norm(odom[:, :3, 3] - anchored[:, :3, 3], axis=1)
    fill, cap, drops = run.fill, run.fill_capacity, run.drops
    dropped = {}
    for j, k in enumerate(("corner", "surf")):
        d = drops[:, j]
        hit = np.flatnonzero(d[:, 1] > 0)
        dropped[k] = None if not len(hit) else {
            "frames": len(hit), "first": int(hit[0]), "most": int(d[:, 1].max()), "most_at": int(d[:, 1].argmax()),
            "offered_most": int(d[:, 0].max()), "x_min": float(np.nanmin(d[hit, 2])), "x_max": float(np.nanmax(d[hit, 3]))}
    return {
        "capacity": run.capacity, "cli_capacity": run.cli_capacity,
        "cut_frames": [i for i, r in enumerate(drive.returns[:n]) if r > run.capacity],
        "aloam_mean_error": float(err.mean()), "fill_capacity": list(cap),
        "fill_max": {k: [int(fill[:, j].max()), int(fill[:, j].argmax())] for j, k in enumerate(("corner", "surf"))},
        "fill_end": fill[-1].tolist(),
        "at_capacity": [int(i) for i in np.flatnonzero((fill[:, 0] >= cap[0]) | (fill[:, 1] >= cap[1]))],
        "dropped": dropped, "drops_recorded": len(drops) == n,
    }


def check(rep: dict, min_keyframes: int = MIN_KEYFRAMES, min_loops: int = MIN_LOOPS,
          min_returns: int = MIN_RETURNS) -> list:
    """The checks that failed, as messages. The launch, front-end time and
    device memory checks hold only for a run on the card; the front-end
    time only for the NDT front end (A-LOAM's is reported)."""
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
    aloam = rep["front_end"] == "aloam"
    if aloam and rep["cut_frames"]:
        fails.append(f"{len(rep['cut_frames'])} sweeps held more returns than the front end's {rep['capacity']} rows "
                     f"(frames {rep['cut_frames'][:10]}...): cut")
    if aloam and rep["at_capacity"] and not rep["drops_recorded"]:
        fails.append(f"an A-LOAM map reached its capacity {rep['fill_capacity']} at frames {rep['at_capacity'][:10]}: "
                     f"which voxels the fold's out_capacity dropped is not recorded")
    if rep["device"] == "cuda":
        got = rep["launches"]
        if aloam:
            want = {"ndt_newton": rep["attempts"], "ndt_reduce_fused": 0, "window_knn": K2_PER_SWEEP * rep["frames"],
                    "gather_stats_onehot": 0}
            if got != want:
                fails.append(f"launches {got}: {want} wanted (window_knn {K2_PER_SWEEP} a sweep, ndt_newton 1 an "
                             f"attempt)")
        else:
            want = 2 * (rep["frames"] - 1) + rep["attempts"]
            if got["ndt_newton"] != want or any(got[k] for k in got if k != "ndt_newton"):
                fails.append(f"launches {got}: ndt_newton {want} wanted (2 a frame after the first, 1 an attempt), "
                             f"the others none")
            fe = rep["stages"]["front_end"]["mean_ms"]
            if not fe < FRONT_END_MS:
                fails.append(f"the front_end stage's mean {fe} ms, not under {FRONT_END_MS}")
        # what the kept A-LOAM states hold is not the program's
        first = next((m for m in rep["memory"] if m["keyframes"] >= SAMPLE_EVERY), None)
        last = rep["memory"][-1]
        growth = None if first is None else (last["allocated"] - last["held"]) - (first["allocated"] - first["held"])
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
        maps = "" if m["corner_map"] is None else (
            f", corner map {m['corner_map']} of {m['corner_capacity']}, surf map {m['surf_map']} of "
            f"{m['surf_capacity']}" + (f", {mib(m['held'])} MiB held by the kept A-LOAM states" if m["held"] else ""))
        say(f"memory at {m['label']} (frame {m['frame']}, {m['keyframes']} keyframes): allocated "
            f"{mib(m['allocated'])} MiB, max_allocated {mib(m['max_allocated'])} MiB, reserved {mib(m['reserved'])} MiB, "
            f"VmRSS {mib(m['vm_rss'])} MiB, store {mib(m['store_bytes'])} MiB on disk, Scan Context {m['sc_count']} of "
            f"{m['sc_capacity']}, graph nodes {m['nodes']} of {m['max_nodes']}, edges {m['edges']} of "
            f"{m['max_edges']}, priors {m['priors']} of {m['max_priors']}{maps}")
    if rep["front_end"] == "aloam":
        fe = rep["stages"]["front_end"]["mean_ms"]
        say(f"A-LOAM: sweeps of {rep['capacity']} rows (the CLI's rule asked {rep['cli_capacity']}), "
            f"{len(rep['cut_frames'])} sweeps cut; mean pose error anchored at frame 0 {rep['aloam_mean_error']:.4f} m "
            f"(bench.py's guard {ALOAM_GUARD} m, reported); front_end stage mean {fe} ms (limit {FRONT_END_MS} ms, "
            f"reported)")
        say(f"A-LOAM maps of {rep['fill_capacity']} points: largest corner {rep['fill_max']['corner'][0]} (frame "
            f"{rep['fill_max']['corner'][1]}), surf {rep['fill_max']['surf'][0]} (frame {rep['fill_max']['surf'][1]}); "
            f"at the end {rep['fill_end']}; {len(rep['at_capacity'])} frames at capacity")
        for k, d in rep["dropped"].items():
            say(f"A-LOAM {k} map: " + ("its fold dropped nothing" if d is None else
                f"its fold dropped voxels at capacity in {d['frames']} frames from frame {d['first']}: at most "
                f"{d['most']} of {d['offered_most']} offered (frame {d['most_at']}), those of the largest x, "
                f"{d['x_min']:.2f} to {d['x_max']:.2f} m in the map frame (voxel_downsample keeps its keys' x-major "
                f"order)"))
    mp = rep["saved_map"]
    say(f"saved map: {mp['map_points'] + mp['map_capacity_dropped']} points offered to the joint map, "
        f"{mp['map_points']} kept, {mp['map_capacity_dropped']} dropped by map_capacity; filtered map "
        f"{mp['filtered_map_points']} points")
    say(f"launches {rep['launches']}")


def save_record(path: str, run: Run, drive: Drive) -> None:
    """The record endurance_witness.py replays: per frame the odometry,
    GNSS position and pose and the truth; the keyframes' frames; each loop
    edge with the frame that inserted it; each solve's frame and starter;
    the final optimized keyframe poses; the config file's text. An A-LOAM
    run's record also names its front end and holds each sweep's returns
    and the maps' fill after each frame (an NDT record keeps the arrays it
    always had, so that --same-as compares it with earlier ones)."""
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
                  "scan_seed": drive.seed, **({"spinning": True} if drive.spinning else {})})),
             **({} if run.front_end == "ndt" else {
                 "front_end": np.asarray(run.front_end), "returns": np.asarray(drive.returns[:n], np.int64),
                 "fill": run.fill, "fill_capacity": np.asarray(run.fill_capacity), "drops": run.drops}))


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


# the JAX AloamState's fields, in order (lidar_slam_tpu/pipeline/aloam/pipeline.py), which the port's keeps
ALOAM_FIELDS = ("prev_less_sharp", "prev_less_sharp_ring", "prev_less_flat", "prev_less_flat_ring", "T_rel", "T_world",
                "T_map_odom", "corner_map", "surf_map", "has_prev", "map_init")


def state_leaves(state) -> dict:
    """An AloamState's leaves as numpy arrays by name, in ALOAM_FIELDS'
    order; a cloud's as NAME_points and NAME_mask."""
    out = {}
    for name in ALOAM_FIELDS:
        v = getattr(state, name)
        if hasattr(v, "points"):
            out[f"{name}_points"], out[f"{name}_mask"] = v.points.cpu().numpy(), v.mask.cpu().numpy()
        else:
            out[name] = v.cpu().numpy()
    return out


def save_aloam_states(path: str, run: Run, drive: Drive) -> list:
    """The kept A-LOAM states (run.picks) as aloam_witness.py reads them,
    one row a frame: the frame and why it was kept; the state before it
    (before_LEAF, state_leaves'), its padded sweep (points, mask), the
    state after it (after_LEAF) and the port's pose (T_map; the CLI's
    odometry starts at the identity); the run's pose of the frame before
    and the truth of both frames; the ring id and validity of every row
    of the sweep as the step's device computes them (port_ring,
    port_ring_ok); the front end's configs (JSON of their fields) and the
    CLI's sweep rows. Returns the frames."""
    import dataclasses

    from lidar_slam_tpu_torch.io.trajectory import read_kitti_trajectory

    odom = read_kitti_trajectory(os.path.join(run.out_dir, "trajectory", "laser_odom.txt"))
    by_frame = {}
    for reason, e in run.picks.items():
        by_frame.setdefault(e["frame"], (e, []))[1].append(reason)
    frames = sorted(by_frame)
    rows = {"frames": np.asarray(frames, np.int64),
            "reasons": np.asarray(["; ".join(by_frame[f][1]) for f in frames])}
    for f in frames:
        e = by_frame[f][0]
        leaves = {**{f"before_{k}": v for k, v in state_leaves(e["before"]).items()},
                  **{f"after_{k}": v for k, v in state_leaves(e["after"]).items()},
                  "points": e["sweep"][0].cpu().numpy(), "mask": e["sweep"][1].cpu().numpy(), "T_map": e["pose"],
                  "pose_prev": odom[max(f - 1, 0)], "gt": drive.gt[f], "gt_prev": drive.gt[max(f - 1, 0)]}
        for k, v in leaves.items():
            rows.setdefault(k, []).append(v)
    fe, odo, mp = run.aloam_configs
    # the ring formula's verdict on every row, as the step's device computed it: aloam_witness.py moves the
    # rows that sit on the formula's edges to the side this rounding put them
    from lidar_slam_tpu_torch.pipeline.aloam.feature_extraction import _ring_id

    for f in frames:
        ring, ok = _ring_id(by_frame[f][0]["sweep"][0], fe.n_scans)
        rows.setdefault("port_ring", []).append(ring.cpu().numpy())
        rows.setdefault("port_ring_ok", []).append(ok.cpu().numpy())
    cfg = {"feature_extraction": dataclasses.asdict(fe), "odometry": dataclasses.asdict(odo),
           "mapping": dataclasses.asdict(mp), "cli_capacity": run.cli_capacity}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **{k: np.stack(v) if isinstance(v, list) else v for k, v in rows.items()},
                        fields=np.asarray(ALOAM_FIELDS), configs=np.asarray(json.dumps(cfg)))
    return frames


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
    ap.add_argument("--frames", type=int, help="run the drive's first FRAMES frames (all by default)")
    ap.add_argument("--front-end", choices=("ndt", "aloam"), default="ndt",
                    help="the CLI's --front-end; aloam drives aloam_drive's spinning sweeps")
    ap.add_argument("--aloam-states", metavar="FRAMES", help='with --front-end aloam and --states-out: "auto" '
                    "(AloamPicks' five frames) or frames, comma-separated, whose A-LOAM states to save")
    ap.add_argument("--states-out", metavar="F", help="with --aloam-states: the .npz for aloam_witness.py")
    args = ap.parse_args(argv)
    if args.same_as and not args.out:
        ap.error("--same-as needs --out")
    if bool(args.aloam_states) != bool(args.states_out) or (args.aloam_states and args.front_end != "aloam"):
        ap.error("--aloam-states and --states-out go together, with --front-end aloam")
    states = None
    if args.aloam_states:
        states = "auto" if args.aloam_states == "auto" else [int(f) for f in args.aloam_states.split(",")]
    import shutil

    import torch

    if args.replay_front_end is not None:
        if args.front_end != "ndt":
            ap.error("--replay-front-end replays the NDT front end; aloam_witness.py splits an A-LOAM frame")
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
    aloam = args.front_end == "aloam"
    drive = aloam_drive() if aloam else endurance_drive()
    print(f"[endurance] drive: {len(drive)} frames, {drive.arclength[-1]:.1f} m, "
          f"{drive.arclength[-1] / drive.shuttle.lap:.2f} laps, {len(gate_keyframes(drive.gt))} keyframes on the "
          f"truth's gate, world {len(drive.world.points)} points at density {drive.world_params['density']:g}, "
          + (f"{N_SCANS} x {N_AZIMUTH} spinning sweeps by {drive.workers} processes" if aloam else "random returns")
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    config_path = args.work + "-config.yaml"
    os.makedirs(os.path.dirname(os.path.abspath(config_path)), exist_ok=True)
    with open(config_path, "w") as f:
        f.write(config_text())
    try:
        run = run_mapping(drive, args.work, config_path, n_frames=args.frames, device=args.device,
                          front_end=args.front_end, aloam_states=states)
        rep = report(run, drive)
        if args.out:
            save_record(args.out, run, drive)
        if args.states_out:
            saved = save_aloam_states(args.states_out, run, drive)
            print(f"[endurance] A-LOAM states of frames {saved} saved to {args.states_out}: "
                  f"{ {r: e['frame'] for r, e in run.picks.items()} }", flush=True)
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
    print(json.dumps({"ok": not fails, "front_end": rep["front_end"], "frames": rep["frames"], "keyframes": rep["keyframes"],
                      "loops": len(rep["loops"]), "keyframe_ate_optimized": rep["keyframe_ate_optimized"]}))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
