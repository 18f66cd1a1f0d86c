"""The one traffic generator: a recorded drive made from a mix's parameters
and the run's seed.

A mix (`traffic/<name>.json`) names a world, a route, a sensor and a GNSS
receiver. The world is a street corridor (ground, two facades with ledges,
kiosks, poles) with trucks driving down it: the corridor of the program's
synthetic data, rebuilt here so that a later edit to the program moves no
cell. A drive is one recording, the same in every run, as a user replays one
logged drive: the world is a fixed site (`world_seed`), and the mix's
`recording_seed` draws what the sensor did (which returns a sweep kept,
their range noise and dropout, the trucks' surface returns, the GNSS
noise). The mapping run's pose-graph solves turn any change of input bits
into other solve times (PERF.md), so a drive that changed with the run's
seed would change the work measured.

The route is shuttle laps of two straight legs joined by U-turns, at a
car's speed profile. Lap 1 starts from rest; the steady lap is a stretch of
lap 2 whose last frame leads into its first as the drive itself would, so
steady laps follow one another without a seam. Set-up drives `setup_laps`
laps; the window a whole number of steady laps, and a traced run's tail
`trace_laps` more, each lap with sweeps of its own. The window's laps are
fixed by the run's `--seconds` alone (`window_laps`): the same frames in
every run, whatever the host's speed.

Sweeps are made on the device in one pass a frame (the world transformed,
the range gate, the kept returns drawn without replacement, noise and
dropout) and held on the host as the finite returns, the way a LiDAR's
reader hands them over.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


# -- the world ------------------------------------------------------------------------------------
def corridor(length: float, width: float, density: float, seed: int, wall_height: float = 6.0,
             n_poles: int = 40) -> np.ndarray:
    """Static points [M, 3] float32 of a street corridor along +x: the
    ground from x = -10, two facades with piecewise depth and ledges every
    1.5 m, kiosks along the edges and poles."""
    rng = np.random.default_rng(seed)
    n_ground = int(length * width * density / 8)
    ground = np.stack([rng.uniform(-10, length, n_ground), rng.uniform(-width / 2, width / 2, n_ground),
                       rng.normal(0, 0.02, n_ground)], axis=-1)
    parts = [ground]
    n_wall = int(length * wall_height * density / 4)
    for side in (-1, 1):
        x = rng.uniform(-10, length, n_wall)
        depth = 1.5 * np.sin(x * 0.11) + 0.8 * np.sign(np.sin(x * 0.37))
        z = rng.uniform(0, wall_height, n_wall)
        band = rng.uniform(size=n_wall) < 0.35
        z = np.where(band, np.round(z / 1.5) * 1.5 + rng.normal(0, 0.02, n_wall), z)
        ledge = np.where(band, 0.25, 0.0)
        parts.append(np.stack([x, side * (width / 2) + side * (depth - ledge) + rng.normal(0, 0.02, n_wall), z],
                              axis=-1))
    for _ in range(max(4, int(length / 15))):
        bx, by = rng.uniform(0, length), rng.uniform(-width / 2 + 2.0, width / 2 - 2.0)
        sx, sy, sz = rng.uniform(1.0, 3.0, 3) * np.array([1.5, 1.0, 1.0])
        m = 240
        face = rng.integers(0, 4, m)
        u = rng.uniform(-0.5, 0.5, m)
        zz = rng.uniform(0, sz, m)
        px = np.where(face == 0, -sx / 2, np.where(face == 1, sx / 2, u * sx))
        py = np.where(face >= 2, np.where(face == 2, -sy / 2, sy / 2), u * sy)
        parts.append(np.stack([bx + px + rng.normal(0, 0.02, m), by + py + rng.normal(0, 0.02, m), zz], axis=-1))
    for _ in range(n_poles):
        px, py = rng.uniform(0, length), rng.uniform(-width / 2 + 1, width / 2 - 1)
        z = rng.uniform(0, 4.0, 60)
        parts.append(np.stack([px + rng.normal(0, 0.02, 60), py + rng.normal(0, 0.02, 60), z], axis=-1))
    return np.concatenate(parts).astype(np.float32)


@dataclass(frozen=True)
class Truck:
    """A box driving at a constant planar velocity; a sweep sees its four
    sides, `points` returns a sweep."""

    center: tuple
    heading: float
    velocity: tuple
    size: tuple = (4.0, 2.0, 2.0)
    points: int = 200

    def center_at(self, t: float) -> np.ndarray:
        c = np.asarray(self.center, np.float64).copy()
        c[:2] += np.asarray(self.velocity, np.float64) * t
        return c

    def bbox(self, T: np.ndarray, t: float, score: float = 0.9) -> np.ndarray:
        """The detector's box (cx, cy, cz, dx, dy, dz, heading, score) in the
        sensor frame of the world pose T."""
        Tinv = np.linalg.inv(T.astype(np.float64))
        c = Tinv[:3, :3] @ self.center_at(t) + Tinv[:3, 3]
        yaw = self.heading - math.atan2(T[1, 0], T[0, 0])
        return np.asarray([*c, *self.size, yaw, score], np.float32)


# -- the route ------------------------------------------------------------------------------------
@dataclass(frozen=True)
class Shuttle:
    """Leg A along y = -radius heading +x from x0 to x0 + leg, U-turn A
    about (x0 + leg, 0), leg B along y = +radius heading -x, U-turn B about
    (x0, 0); both turns to the left."""

    x0: float
    leg: float
    radius: float

    @property
    def arc(self) -> float:
        return math.pi * self.radius

    @property
    def lap(self) -> float:
        return 2.0 * (self.leg + self.arc)

    def segment(self, s: float):
        lap, r = divmod(s, self.lap)
        for name, length in (("leg A", self.leg), ("U-turn A", self.arc), ("leg B", self.leg), ("U-turn B", self.arc)):
            if r < length:
                return name, int(lap), r
            r -= length
        return "U-turn B", int(lap), self.arc

    def pose(self, s: float, z: float) -> np.ndarray:
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


def arclength(n: int, shuttle: Shuttle, cruise: float, turn: float, accel: float) -> np.ndarray:
    """Each frame's arc length from rest: the speed changes by at most
    `accel` a frame, up to `cruise` on the legs and `turn` in the U-turns,
    braking ahead of each turn."""
    s = np.zeros(n)
    v = 0.0
    for k in range(1, n):
        d = shuttle.to_next_turn(s[k - 1])
        limit = turn if d <= 0.0 else _brake_limit(d, cruise, turn, accel)
        v = min(v + accel, cruise, limit)
        s[k] = s[k - 1] + v
    return s


@dataclass
class Route:
    """Frames [0, lap1) are lap 1 from rest; [lap1, lap1 + steady) the
    steady laps (one, or as few whole laps as return to the first frame's
    place and speed) that follow one another from then on. `poses`
    [lap1 + steady, 4, 4] float32, `join_m` how far the join step between
    two of them is from the drive's own step there."""

    poses: np.ndarray
    lap1: int
    steady: int
    join_m: float


def route(p: dict) -> Route:
    """The shuttle route of a mix's `route` parameters."""
    sh = Shuttle(p["x0_m"], p["leg_m"], p["turn_radius_m"])
    n = int(9 * sh.lap / p["turn_m_per_frame"])
    s = arclength(n, sh, p["cruise_m_per_frame"], p["turn_m_per_frame"], p["accel_m_per_frame2"])
    a = int(np.searchsorted(s, sh.lap))  # the first frame of lap 2
    v = np.diff(s)
    # the steady stretch ends where the drive returns to frame a's place at frame a's speed, whole laps on
    best = None
    for laps in range(1, 7):
        lo, hi = np.searchsorted(s, (laps + 0.9) * sh.lap), np.searchsorted(s, (laps + 1.1) * sh.lap)
        cand = np.arange(lo, hi)
        miss = np.abs(s[cand] - s[a] - laps * sh.lap) + np.abs(v[cand] - v[a])
        k = int(np.argmin(miss))
        if best is None or miss[k] < best[0] - 1e-9:
            best = (float(miss[k]), int(cand[k]), laps)
        if best[0] < 1e-6:
            break
    _, b, laps = best
    poses = np.stack([sh.pose(x, p["z_m"]) for x in s[:b]])
    return Route(poses=poses, lap1=a, steady=b - a, join_m=float(np.abs(s[b] - s[a] - laps * sh.lap)))


# -- the sweeps -----------------------------------------------------------------------------------
@dataclass
class Drive:
    """The frames a cell replays: per frame the sensor's finite returns
    (host float32 [n, 3]), the detector boxes, the GNSS fix (the truth's
    rotation, a noisy position) and the truth. Frames [0, setup) are the
    set-up laps, [setup, setup + window) the measured window's whole steady
    laps, and any after them a traced run's tail."""

    points: list
    bboxes: list
    gnss: np.ndarray  # [n, 4, 4] float64
    truth: np.ndarray  # [n, 4, 4] float32
    setup: int
    window: int
    laps: int  # the window's steady laps
    period_s: float

    @property
    def n(self) -> int:
        return len(self.points)

    def frame(self, i: int) -> dict:
        """The i-th frame handed over, its time stamp rising at the sensor's
        period."""
        return {"points": self.points[i], "time": i * self.period_s, "gnss_position": self.gnss[i, :3, 3].copy(),
                "gnss_pose": self.gnss[i].copy(), "bboxes": self.bboxes[i]}


def window_laps(route_params: dict, seconds: float, steady: int) -> int:
    """The window's whole steady laps for a run of `seconds`: as many as the
    mix's `nominal_frames_per_s` (a rate the program kept on the card) fills,
    at least one. It depends on nothing measured in the run."""
    return max(1, round(seconds * route_params["nominal_frames_per_s"] / steady))


_M64 = (1 << 64) - 1


def _i64(c: int) -> int:
    """A 64-bit constant as torch's signed int64."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 words."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def hashed(key: torch.Tensor) -> torch.Tensor:
    """splitmix64 of int64 keys: the same words on every device."""
    z = key + _i64(0x9E3779B97F4A7C15)
    z = (z ^ _shr(z, 30)) * _i64(0xBF58476D1CE4E5B9)
    z = (z ^ _shr(z, 27)) * _i64(0x94D049BB133111EB)
    return z ^ _shr(z, 31)


def uniform(key: torch.Tensor) -> torch.Tensor:
    """Uniforms in (0, 1), float64, from int64 keys."""
    return (_shr(hashed(key), 11).to(torch.float64) + 0.5) * 2.0**-53


def _stream(seed: int, frame: int, channel: int) -> int:
    """The base key of one frame's channel of random numbers."""
    return _i64((seed * 0x100000001B3 + frame * 0x1000193 + channel * 0x9E3779B1) & _M64)


def _sweep(world, trucks, T, t, seed, frame, rows, max_range, min_range, noise, dropout):
    """One sweep on the world's device: (finite returns [n, 3] float32 on
    the host, boxes [B, 8]). Its random numbers are hashes of (seed, frame,
    channel, index), the same on every device."""
    dev = world.device
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)  # noqa: E731
    parts = [world]
    for k, tr in enumerate(trucks):
        m = tr.points // 4
        hx, hy, hz = (s / 2 for s in tr.size)
        u = uniform(_stream(seed, frame, 10 + 2 * k) + ar(4 * m)).reshape(4, m) * 2.0 - 1.0
        z = uniform(_stream(seed, frame, 11 + 2 * k) + ar(4 * m)).reshape(4, m) * (2 * hz) - hz
        face_x = torch.tensor([hx, -hx], dtype=torch.float64, device=dev)[:, None].expand(2, m)
        face_y = torch.tensor([hy, -hy], dtype=torch.float64, device=dev)[:, None].expand(2, m)
        local = torch.cat([torch.stack([face_x, u[:2] * hy, z[:2]], -1).reshape(-1, 3),
                           torch.stack([u[2:] * hx, face_y, z[2:]], -1).reshape(-1, 3)])
        ch, sh = math.cos(tr.heading), math.sin(tr.heading)
        R = torch.tensor([[ch, -sh, 0.0], [sh, ch, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float64, device=dev)
        parts.append(local @ R.T + torch.as_tensor(tr.center_at(t), device=dev))
    pts = torch.cat(parts)
    Tinv = torch.as_tensor(np.linalg.inv(T.astype(np.float64)), device=dev)
    local = pts @ Tinv[:3, :3].T + Tinv[:3, 3]
    r = torch.linalg.norm(local, dim=1)
    sel = torch.nonzero((r >= min_range) & (r <= max_range))[:, 0]
    if sel.numel() > rows:
        # a draw without replacement: the candidates in the order of their hashed keys
        sel = sel[torch.argsort(hashed(_stream(seed, frame, 1) + sel))[:rows]]
    key = sel * 4
    u1 = uniform(_stream(seed, frame, 2) + key[:, None] + ar(3))
    u2 = uniform(_stream(seed, frame, 3) + key[:, None] + ar(3))
    gauss = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    keep = uniform(_stream(seed, frame, 4) + sel) >= dropout
    out = (local[sel] + noise * gauss)[keep].to(torch.float32).cpu().numpy()
    return out, np.stack([tr.bbox(T, t) for tr in trucks]) if trucks else np.zeros((0, 8), np.float32)


def make_drive(mix: dict, sweep: dict, device, seconds: float, trace: bool = False) -> Drive:
    """The drive of `mix` (a traffic file's parameters: the world, the route,
    the GNSS and the recording's seed) under the sensor of `sweep` (the
    configuration's) for a run of `seconds`, with a traced run's tail when
    `trace`, its sweeps made on `device`: the same drive on every device
    and in every run."""
    w, rt, gn = mix["world"], mix["route"], mix["gnss"]
    seed = int(mix["recording_seed"])
    dev = torch.device(device)
    world = torch.as_tensor(corridor(w["length_m"], w["width_m"], w["density"], w["world_seed"]), device=dev)
    world = world.to(torch.float64)
    trucks = [Truck(tuple(c), float(h), tuple(v)) for c, h, v in w["trucks"]]
    path = route(rt)
    setup = path.lap1 + (rt["setup_laps"] - 1) * path.steady
    laps = window_laps(rt, seconds, path.steady)
    n = setup + (laps + (rt["trace_laps"] if trace else 0)) * path.steady
    poses = np.stack([path.poses[k if k < path.lap1 else path.lap1 + (k - path.lap1) % path.steady]
                      for k in range(n)])
    period = 1.0 / sweep["rate_hz"]
    points, bboxes = [], []
    for i, T in enumerate(poses):
        pts, boxes = _sweep(world, trucks, T, i * period, seed, i, sweep["rows"], sweep["max_range_m"],
                            sweep["min_range_m"], sweep["noise_m"], sweep["dropout"])
        points.append(pts)
        bboxes.append(boxes)
    rng = np.random.default_rng(seed)
    gnss = poses.astype(np.float64)
    gnss[:, :3, 3] += rng.normal(0.0, gn["noise_m"], (len(gnss), 3))
    return Drive(points=points, bboxes=bboxes, gnss=gnss, truth=poses, setup=setup, window=laps * path.steady,
                 laps=laps, period_s=period)
