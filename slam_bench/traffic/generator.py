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

Sweeps are made on the device in one pass a frame and held on the host as
the finite returns, the way a LiDAR's reader hands them over. The
configuration's `sweep` names the sensor:

- `"draw"` (the default, where `sensor` is absent): the world and the
  trucks' 200 samples transformed, the range gate, `rows` returns drawn
  without replacement, noise and dropout on each coordinate; no ring layout
  and no occlusion.
- `"spinning"`: a spinning multi-beam sensor, one return a beam direction.
  `elevations_deg` names the beams (ring r is the r-th angle), and
  `azimuth_bins` the directions a turn; `rows` is rings x bins. Every
  surface sample in range goes to its nearest beam by elevation, within a
  gate of max(half the smallest beam gap, 0.2 deg), and to its azimuth bin;
  a (ring, bin) cell keeps the least range (near surfaces occlude far ones)
  and reports it along the cell's centre direction, with range noise and
  dropout. The trucks' sides are sampled at the facades' areal density
  (the mix's `density` / 4 a square metre), so that they occlude the street
  behind them. The returns come ring by ring, azimuth ascending within a
  ring.
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
    sides (`truck_sides`)."""

    center: tuple
    heading: float
    velocity: tuple
    size: tuple = (4.0, 2.0, 2.0)

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


def truck_sides(trucks, t: float, seed: int, frame: int, counts, dev) -> torch.Tensor:
    """World samples [sum of 2 m_x + 2 m_y, 3] float64 of the trucks' four
    sides at time t, truck by truck: m_x on each of the faces at +-x, then
    m_y on each at +-y (`counts[k]` is truck k's (m_x, m_y)), drawn from
    the channels 10 + 2k and 11 + 2k of truck k, all in one hash."""
    sizes = [2 * m_x + 2 * m_y for m_x, m_y in counts]
    if not sizes:
        return torch.zeros((0, 3), dtype=torch.float64, device=dev)
    keys = [_stream(seed, frame, c + 2 * k) + torch.arange(n, dtype=torch.int64, device=dev)
            for c in (10, 11) for k, n in enumerate(sizes)]
    draws = uniform(torch.cat(keys))
    u_all, z_all = draws[:sum(sizes)] * 2.0 - 1.0, draws[sum(sizes):]
    parts, o = [], 0
    for tr, (m_x, m_y), n in zip(trucks, counts, sizes):
        hx, hy, hz = (s / 2 for s in tr.size)
        u, z = u_all[o:o + n], z_all[o:o + n] * (2 * hz) - hz
        o += n
        face_x = torch.tensor([hx, -hx], dtype=torch.float64, device=dev)[:, None].expand(2, m_x)
        face_y = torch.tensor([hy, -hy], dtype=torch.float64, device=dev)[:, None].expand(2, m_y)
        local = torch.cat([torch.stack([face_x, u[:2 * m_x].reshape(2, m_x) * hy, z[:2 * m_x].reshape(2, m_x)],
                                       -1).reshape(-1, 3),
                           torch.stack([u[2 * m_x:].reshape(2, m_y) * hx, face_y, z[2 * m_x:].reshape(2, m_y)],
                                       -1).reshape(-1, 3)])
        ch, sh = math.cos(tr.heading), math.sin(tr.heading)
        R = torch.tensor([[ch, -sh, 0.0], [sh, ch, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float64, device=dev)
        parts.append(local @ R.T + torch.as_tensor(tr.center_at(t), device=dev))
    return torch.cat(parts)


def _sweep(world, trucks, T, t, seed, frame, rows, max_range, min_range, noise, dropout, truck_points):
    """One sweep of the draw sensor on the world's device: (finite returns
    [n, 3] float32 on the host, boxes [B, 8]). Its random numbers are hashes
    of (seed, frame, channel, index), the same on every device."""
    dev = world.device
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)  # noqa: E731
    m = truck_points // 4
    pts = torch.cat([world, truck_sides(trucks, t, seed, frame, [(m, m)] * len(trucks), dev)])
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
    return out, _boxes(trucks, T, t)


def _boxes(trucks, T, t) -> np.ndarray:
    return np.stack([tr.bbox(T, t) for tr in trucks]) if trucks else np.zeros((0, 8), np.float32)


@dataclass(frozen=True)
class Spinning:
    """A spinning sensor's beams: `elevations` (deg) one angle a ring,
    `bins` azimuth directions a turn; `gate` (deg) is how far from its
    nearest beam a surface sample may lie and still be seen."""

    elevations: tuple
    bins: int

    @staticmethod
    def of(sweep: dict) -> "Spinning":
        s = Spinning(tuple(float(e) for e in sweep["elevations_deg"]), int(sweep["azimuth_bins"]))
        if len(s.elevations) < 2 or s.bins < 1 or sweep["rows"] != len(s.elevations) * s.bins:
            raise ValueError(f"a spinning sweep's rows ({sweep['rows']}) must be its rings "
                             f"({len(s.elevations)}, at least 2) x its azimuth bins ({s.bins})")
        return s

    @property
    def gate(self) -> float:
        e = np.sort(np.asarray(self.elevations))
        return max(float(np.min(np.diff(e))) / 2.0, 0.2)

    def cells(self, local: torch.Tensor, min_range: float, max_range: float):
        """The panorama of sensor-frame samples `local` [N, 3] float64:
        (cell [n] int64, the least range [n] float64) of every hit cell
        ring * bins + bin, ascending. A cell's least range is a
        scatter_reduce "amin", which no order of the samples changes; only
        the samples a beam sees take part, since every atomic update of one
        cell waits for the one before it."""
        dev = local.device
        elev = torch.tensor(self.elevations, dtype=torch.float64, device=dev)
        up, order = torch.sort(elev)
        r = torch.linalg.norm(local, dim=1)
        el = torch.rad2deg(torch.atan2(local[:, 2], torch.hypot(local[:, 0], local[:, 1])))
        ring = order[torch.bucketize(el, (up[:-1] + up[1:]) / 2.0)]
        seen = torch.nonzero((r >= min_range) & (r <= max_range) & (torch.abs(el - elev[ring]) <= self.gate))[:, 0]
        local, r, ring = local[seen], r[seen], ring[seen]
        az = torch.atan2(local[:, 1], local[:, 0])
        b = torch.clamp(((az + math.pi) / (2.0 * math.pi) * self.bins).to(torch.int64), 0, self.bins - 1)
        pan = torch.full((len(self.elevations) * self.bins,), math.inf, dtype=torch.float64, device=dev)
        pan.scatter_reduce_(0, ring * self.bins + b, r, "amin")
        hit = torch.nonzero(torch.isfinite(pan))[:, 0]
        return hit, pan[hit]

    def directions(self, cell: torch.Tensor) -> torch.Tensor:
        """Unit vectors [n, 3] float64 of the cells' centres: the ring's
        elevation, the bin's middle azimuth."""
        elev = torch.deg2rad(torch.tensor(self.elevations, dtype=torch.float64, device=cell.device))[cell // self.bins]
        az = ((cell % self.bins).to(torch.float64) + 0.5) / self.bins * (2.0 * math.pi) - math.pi
        return torch.stack([torch.cos(elev) * torch.cos(az), torch.cos(elev) * torch.sin(az), torch.sin(elev)], -1)


def truck_counts(tr: Truck, density: float) -> tuple:
    """A truck's samples (m_x, m_y) a face at the facades' areal density
    (`density` / 4 a square metre, as `corridor` samples its walls)."""
    dx, dy, dz = tr.size
    return round(dy * dz * density / 4), round(dx * dz * density / 4)


@dataclass
class Surfaces:
    """What a spinning sweep looks at: the world's samples `world` [M, 3]
    float64 on the device, in ascending x (`xs`, on the host), and the
    trucks, sampled at the facades' density each frame."""

    world: torch.Tensor
    xs: np.ndarray
    trucks: list
    density: float

    @staticmethod
    def of(world: np.ndarray, trucks: list, density: float, dev) -> "Surfaces":
        world = world[np.argsort(world[:, 0], kind="stable")]
        return Surfaces(torch.as_tensor(world, device=dev).to(torch.float64), world[:, 0].astype(np.float64),
                        trucks, density)

    def near(self, x: float, reach: float, t: float, seed: int, frame: int) -> torch.Tensor:
        """The world's samples within `reach` of x along x (a slice: what
        lies farther is out of range) and the trucks' sides at time t."""
        a, b = np.searchsorted(self.xs, (x - reach, x + reach))
        sides = truck_sides(self.trucks, t, seed, frame, [truck_counts(tr, self.density) for tr in self.trucks],
                            self.world.device)
        return torch.cat([self.world[a:b], sides])


def _spinning_sweep(surfaces: Surfaces, T, t, seed, frame, sensor: Spinning, max_range, min_range, noise, dropout):
    """One sweep of the spinning sensor on the surfaces' device: (finite
    returns [n, 3] float32 on the host, ring by ring and azimuth ascending
    within a ring; boxes [B, 8]; the returns' cells [n] int64 on the
    device). Range noise and dropout are hashes of (seed, frame, channel,
    cell) on channels 5-7."""
    Tinv = torch.as_tensor(np.linalg.inv(T.astype(np.float64)), device=surfaces.world.device)
    pts = surfaces.near(float(T[0, 3]), max_range, t, seed, frame)
    cell, r = sensor.cells(pts @ Tinv[:3, :3].T + Tinv[:3, 3], min_range, max_range)
    u = uniform(torch.cat([_stream(seed, frame, c) + cell for c in (5, 6, 7)])).reshape(3, -1)
    gauss = torch.sqrt(-2.0 * torch.log(u[0])) * torch.cos(2.0 * math.pi * u[1])
    keep = u[2] >= dropout
    cell = cell[keep]
    out = ((r + noise * gauss)[keep, None] * sensor.directions(cell)).to(torch.float32).cpu().numpy()
    return out, _boxes(surfaces.trucks, T, t), cell


def make_drive(mix: dict, sweep: dict, device, seconds: float, trace: bool = False) -> Drive:
    """The drive of `mix` (a traffic file's parameters: the world, the route,
    the GNSS and the recording's seed) under the sensor of `sweep` (the
    configuration's: `sensor` "draw", the default, or "spinning", with its
    range gate, noise, dropout and rate) for a run of `seconds`, with a
    traced run's tail when `trace`, its sweeps made on `device`: the same
    drive on every device and in every run."""
    w, rt, gn = mix["world"], mix["route"], mix["gnss"]
    seed = int(mix["recording_seed"])
    kind = sweep.get("sensor", "draw")
    if kind not in ("draw", "spinning"):
        raise ValueError(f"unknown sensor {kind!r}: draw or spinning")
    spinning = Spinning.of(sweep) if kind == "spinning" else None
    dev = torch.device(device)
    world = corridor(w["length_m"], w["width_m"], w["density"], w["world_seed"])
    trucks = [Truck(tuple(c), float(h), tuple(v)) for c, h, v in w["trucks"]]
    if spinning is None:
        world = torch.as_tensor(world, device=dev).to(torch.float64)
    else:
        surfaces = Surfaces.of(world, trucks, w["density"], dev)
    path = route(rt)
    setup = path.lap1 + (rt["setup_laps"] - 1) * path.steady
    laps = window_laps(rt, seconds, path.steady)
    n = setup + (laps + (rt["trace_laps"] if trace else 0)) * path.steady
    poses = np.stack([path.poses[k if k < path.lap1 else path.lap1 + (k - path.lap1) % path.steady]
                      for k in range(n)])
    period = 1.0 / sweep["rate_hz"]
    points, bboxes = [], []
    sensing = sweep["max_range_m"], sweep["min_range_m"], sweep["noise_m"], sweep["dropout"]
    for i, T in enumerate(poses):
        if spinning is None:
            pts, boxes = _sweep(world, trucks, T, i * period, seed, i, sweep["rows"], *sensing, truck_points=200)
        else:
            pts, boxes, _ = _spinning_sweep(surfaces, T, i * period, seed, i, spinning, *sensing)
        points.append(pts)
        bboxes.append(boxes)
    rng = np.random.default_rng(seed)
    gnss = poses.astype(np.float64)
    gnss[:, :3, 3] += rng.normal(0.0, gn["noise_m"], (len(gnss), 3))
    return Drive(points=points, bboxes=bboxes, gnss=gnss, truth=poses, setup=setup, window=laps * path.steady,
                 laps=laps, period_s=period)
