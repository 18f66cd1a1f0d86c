"""Synthetic LiDAR world + scan simulator.

The container has no KITTI data, so end-to-end odometry/SLAM tests and
benchmarks drive on simulated scans: a structured "street corridor" world
(ground + building walls + poles), smooth trajectories, range-limited noisy
scans, and optional moving box obstacles with per-frame bounding boxes (the
analog of the reference's 3D-detector bbox txt files, front_end.cpp:427-530,
for exercising static-point weighting).

Host-side numpy; device code receives padded PointClouds.

The port's own copy of lidar_slam_tpu/io/synthetic.py, with the same
functions and the same arithmetic, so that both packages drive on
identical data (tests/test_torch_ops.py holds the two copies equal). Keep
the two in step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class DynamicBox:
    """A moving rigid box obstacle. Pose is (x, y) + heading at t=0 with a
    constant planar velocity."""

    center0: np.ndarray  # [3]
    size: np.ndarray  # [3] dx, dy, dz
    heading: float
    velocity: np.ndarray  # [2] m/s in world x, y
    n_points: int = 150

    def center_at(self, t: float) -> np.ndarray:
        c = self.center0.copy()
        c[:2] = c[:2] + self.velocity * t
        return c

    def sample_surface(self, t: float, rng) -> np.ndarray:
        """Points on the box's four side faces (lidar sees sides, not top)."""
        c = self.center_at(t)
        hx, hy, hz = self.size / 2
        n = self.n_points
        pts = []
        for sx, sy, axis in [(1, 0, 0), (-1, 0, 0), (0, 1, 1), (0, -1, 1)]:
            m = n // 4
            u = rng.uniform(-1, 1, m)
            z = rng.uniform(0, 2 * hz, m)
            if axis == 0:
                local = np.stack([np.full(m, sx * hx), u * hy, z - hz], axis=-1)
            else:
                local = np.stack([u * hx, np.full(m, sy * hy), z - hz], axis=-1)
            pts.append(local)
        local = np.concatenate(pts)
        ch, sh = np.cos(self.heading), np.sin(self.heading)
        R = np.array([[ch, -sh, 0], [sh, ch, 0], [0, 0, 1]])
        return (local @ R.T + c).astype(np.float32)

    def bbox_at(self, t: float, score: float = 0.9) -> np.ndarray:
        """(cx, cy, cz, dx, dy, dz, heading, score) — CloudBbox layout
        (sensor_data/cloud_bbox.hpp:12-26) in WORLD frame."""
        c = self.center_at(t)
        return np.asarray([*c, *self.size, self.heading, score], np.float32)


@dataclass
class SyntheticWorld:
    """Static world surface samples + dynamic boxes."""

    points: np.ndarray  # [M, 3] float32 static world points
    boxes: List[DynamicBox] = field(default_factory=list)

    @staticmethod
    def corridor(
        length: float = 200.0,
        width: float = 16.0,
        wall_height: float = 6.0,
        density: float = 24.0,
        seed: int = 0,
        n_poles: int = 40,
        curve: float = 0.0,
    ) -> "SyntheticWorld":
        """A street corridor along +x: ground strip, two jittered building
        walls, poles. `density` = points per square metre-ish. `curve` bends
        the corridor (rad per metre) so trajectories exercise rotation."""
        rng = np.random.default_rng(seed)

        def bend(pts):
            if curve == 0.0:
                return pts
            x = pts[:, 0]
            theta = curve * x
            # rotate the cross-section by the local heading and lift y
            y_off = np.where(np.abs(curve) > 1e-9, (1 - np.cos(theta)) / curve, 0.0)
            out = pts.copy()
            out[:, 0] = np.where(np.abs(curve) > 1e-9, np.sin(theta) / curve, x)
            out[:, 1] = pts[:, 1] + y_off
            return out

        n_ground = int(length * width * density / 8)
        ground = np.stack(
            [
                rng.uniform(-10, length, n_ground),
                rng.uniform(-width / 2, width / 2, n_ground),
                rng.normal(0, 0.02, n_ground),
            ],
            axis=-1,
        )

        walls = []
        n_wall = int(length * wall_height * density / 4)
        for side in (-1, 1):
            jitter_x = rng.uniform(-10, length, n_wall)
            # piecewise facade depth so walls aren't a single featureless plane
            depth = 1.5 * np.sin(jitter_x * 0.11) + 0.8 * np.sign(np.sin(jitter_x * 0.37))
            z = rng.uniform(0, wall_height, n_wall)
            # floor slabs / ledges: a fraction of facade points snap to
            # horizontal bands, making z observable (a z-uniform wall is
            # degenerate — scan matching can slide vertically for free)
            band = rng.uniform(size=n_wall) < 0.35
            z = np.where(band, np.round(z / 1.5) * 1.5 + rng.normal(0, 0.02, n_wall), z)
            ledge_out = np.where(band, 0.25, 0.0)
            walls.append(
                np.stack(
                    [
                        jitter_x,
                        side * (width / 2) + side * (depth - ledge_out) + rng.normal(0, 0.02, n_wall),
                        z,
                    ],
                    axis=-1,
                )
            )

        # box structures (kiosks / parked trucks) along the corridor edges:
        # distinct 3-D landmarks that pin both yaw and z
        blocks = []
        for _ in range(max(4, int(length / 15))):
            bx = rng.uniform(0, length)
            by = rng.uniform(-width / 2 + 2.0, width / 2 - 2.0)
            sx, sy, sz = rng.uniform(1.0, 3.0, 3) * np.array([1.5, 1.0, 1.0])
            m = 240
            face = rng.integers(0, 4, m)
            u = rng.uniform(-0.5, 0.5, m)
            zz = rng.uniform(0, sz, m)
            px = np.where(face == 0, -sx / 2, np.where(face == 1, sx / 2, u * sx))
            py = np.where(face >= 2, np.where(face == 2, -sy / 2, sy / 2), u * sy)
            blocks.append(
                np.stack([bx + px + rng.normal(0, 0.02, m), by + py + rng.normal(0, 0.02, m), zz], axis=-1)
            )
        walls.extend(blocks)

        poles = []
        for _ in range(n_poles):
            px = rng.uniform(0, length)
            py = rng.uniform(-width / 2 + 1, width / 2 - 1)
            z = rng.uniform(0, 4.0, 60)
            poles.append(
                np.stack(
                    [
                        px + rng.normal(0, 0.02, 60),
                        py + rng.normal(0, 0.02, 60),
                        z,
                    ],
                    axis=-1,
                )
            )

        pts = np.concatenate([ground, *walls, *poles]).astype(np.float32)
        return SyntheticWorld(points=bend(pts).astype(np.float32))

    def add_moving_box(self, center0, size, heading, velocity, n_points=150):
        self.boxes.append(
            DynamicBox(
                center0=np.asarray(center0, np.float64),
                size=np.asarray(size, np.float64),
                heading=float(heading),
                velocity=np.asarray(velocity, np.float64),
                n_points=n_points,
            )
        )


def make_trajectory(n_frames: int, speed: float = 1.0, curve: float = 0.0, z: float = 1.8):
    """Poses [N, 4, 4] along the corridor: x advances by `speed` per frame,
    heading follows the corridor curve."""
    poses = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    for i in range(n_frames):
        s = i * speed
        if abs(curve) > 1e-9:
            theta = curve * s
            x = np.sin(theta) / curve
            y = (1 - np.cos(theta)) / curve
        else:
            theta = 0.0
            x, y = s, 0.0
        c, sn = np.cos(theta), np.sin(theta)
        poses[i, :3, :3] = np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1]], np.float32)
        poses[i, :3, 3] = [x, y, z]
    return poses


def hdl64_elevations() -> np.ndarray:
    """Beam elevation angles (deg) consistent with A-LOAM's 64-beam ring
    formula (scanRegistration.cpp:188-202): upper 32 beams at 2 - ring/3,
    lower 32 at -8.83 - (ring-32)/2."""
    upper = 2.0 - np.arange(32) / 3.0
    lower = -8.83 - np.arange(32) / 2.0
    return np.concatenate([upper, lower])


def make_hairpin_trajectory(
    n_out: int = 16,
    n_turn: int = 8,
    n_back: int = 12,
    speed: float = 1.5,
    turn_radius: float = 3.0,
    z: float = 1.8,
) -> np.ndarray:
    """Smooth out-and-back path: straight along +x, semicircular U-turn,
    straight back offset 2*turn_radius in y. Heading follows the tangent —
    the realistic revisit loop for loop-closure tests."""
    n = n_out + n_turn + n_back
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    L = n_out * speed
    for i in range(n):
        if i < n_out:
            x, y, th = i * speed, 0.0, 0.0
        elif i < n_out + n_turn:
            frac = (i - n_out + 1) / n_turn
            ang = -np.pi / 2 + np.pi * frac  # sweep the semicircle
            x = L + turn_radius * np.cos(ang)
            y = turn_radius + turn_radius * np.sin(ang)
            th = ang + np.pi / 2
        else:
            j = i - n_out - n_turn
            x, y, th = L - (j + 1) * speed, 2 * turn_radius, np.pi
        c, s = np.cos(th), np.sin(th)
        poses[i, :3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        poses[i, :3, 3] = [x, y, z]
    return poses


def simulate_spinning_scan(
    world: SyntheticWorld,
    pose: np.ndarray,
    t: float = 0.0,
    n_scans: int = 64,
    n_azimuth: int = 1024,
    max_range: float = 60.0,
    min_range: float = 2.0,
    noise: float = 0.02,
    seed: int = 0,
):
    """Simulate an organized spinning-lidar sweep with ring structure.

    World surface samples are binned into a (ring, azimuth) panorama taking
    the minimum range per cell (which also gives natural occlusion), then
    re-projected to xyz at the bin's spherical coordinates. Output is
    ring-major, azimuth-ordered — the layout A-LOAM's curvature window
    assumes. Returns (points [n_scans*n_azimuth, 3], mask).
    """
    rng = np.random.default_rng(seed)
    Tinv = np.linalg.inv(pose.astype(np.float64))

    pts_w = [world.points]
    for b in world.boxes:
        pts_w.append(b.sample_surface(t, rng))
    pts_w = np.concatenate(pts_w)
    local = pts_w @ Tinv[:3, :3].T + Tinv[:3, 3]

    r = np.linalg.norm(local, axis=1)
    ok = (r >= min_range) & (r <= max_range)
    local = local[ok]
    r = r[ok]
    elev = np.rad2deg(np.arctan2(local[:, 2], np.linalg.norm(local[:, :2], axis=1)))
    azim = np.arctan2(local[:, 1], local[:, 0])  # [-pi, pi)

    elevs = hdl64_elevations() if n_scans == 64 else np.linspace(2.0, -24.0, n_scans)
    order = np.argsort(-elevs)  # descending for binning
    sorted_elevs = -np.sort(-elevs)
    edges = (sorted_elevs[:-1] + sorted_elevs[1:]) / 2.0
    ring_sorted = np.digitize(-elev, -edges)  # index into sorted_elevs
    ring = order[np.clip(ring_sorted, 0, n_scans - 1)]
    half_gap = np.abs(np.diff(sorted_elevs)).min() / 2.0
    in_beam = np.abs(elev - elevs[ring]) <= max(half_gap, 0.2)

    az_bin = np.clip(((azim + np.pi) / (2 * np.pi) * n_azimuth).astype(int), 0, n_azimuth - 1)

    pan = np.full((n_scans, n_azimuth), np.inf, np.float32)
    sel = np.flatnonzero(in_beam)
    np.minimum.at(pan, (ring[sel], az_bin[sel]), r[sel].astype(np.float32))

    hit = np.isfinite(pan)
    rr = np.where(hit, pan, 0.0) + rng.normal(0, noise, pan.shape).astype(np.float32)
    az_centers = (np.arange(n_azimuth) + 0.5) / n_azimuth * 2 * np.pi - np.pi
    el_rad = np.deg2rad(elevs)
    ce = np.cos(el_rad)[:, None]
    se = np.sin(el_rad)[:, None]
    x = rr * ce * np.cos(az_centers)[None, :]
    y = rr * ce * np.sin(az_centers)[None, :]
    z = rr * se
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    mask = hit.reshape(-1)
    return pts, mask


def skew_scan(
    points: np.ndarray,
    mask: np.ndarray,
    angular_vel,
    linear_vel,
    scan_period: float = 0.1,
) -> np.ndarray:
    """Distort a start-of-sweep-referenced scan as a spinning sensor moving
    at (angular_vel, linear_vel) would record it — the exact forward model
    of models.scan_adjust.adjust_cloud (p_rec = exp(w t) @ (p0 + v t), per-
    point time from azimuth fraction). Lets e2e tests exercise the
    reference's wired-but-disabled de-skew path
    (data_pretreat_flow.cpp:268-270, distortion_adjust.cpp:10-69) with
    known ground truth."""
    pts = np.asarray(points, np.float64)
    w = np.asarray(angular_vel, np.float64)
    v = np.asarray(linear_vel, np.float64)
    start = np.arctan2(pts[0, 1], pts[0, 0])
    azim = np.arctan2(pts[:, 1], pts[:, 0]) - start
    azim = np.where(azim < 0, azim + 2 * np.pi, azim)
    t = np.clip(azim / (2 * np.pi), 0.0, 1.0) * scan_period  # [N]

    shifted = pts + v[None, :] * t[:, None]
    rot = w[None, :] * t[:, None]  # [N, 3] rotation vectors
    ang = np.linalg.norm(rot, axis=1)
    safe = np.maximum(ang, 1e-12)
    axis = rot / safe[:, None]
    c, s = np.cos(ang)[:, None], np.sin(ang)[:, None]
    # Rodrigues: R p = c p + s (axis x p) + (1-c)(axis.p) axis
    cross = np.cross(axis, shifted)
    dot = np.sum(axis * shifted, axis=1, keepdims=True)
    out = c * shifted + s * cross + (1.0 - c) * dot * axis
    out = np.where(ang[:, None] > 1e-12, out, shifted)
    return np.where(np.asarray(mask, bool)[:, None], out, pts).astype(np.float32)


def bboxes_for(world: SyntheticWorld, pose: np.ndarray, t: float = 0.0) -> np.ndarray:
    """Per-frame detector bboxes [B, 8] in the SENSOR frame for the world's
    dynamic boxes (the CloudBbox channel, sensor_data/cloud_bbox.hpp:12-26)."""
    Tinv = np.linalg.inv(pose.astype(np.float64))
    bboxes = []
    for b in world.boxes:
        bb = b.bbox_at(t)
        c_local = Tinv[:3, :3] @ bb[:3] + Tinv[:3, 3]
        yaw_sensor = bb[6] - np.arctan2(pose[1, 0], pose[0, 0])
        bboxes.append(np.asarray([*c_local, *bb[3:6], yaw_sensor, bb[7]], np.float32))
    return np.stack(bboxes) if bboxes else np.zeros((0, 8), np.float32)


def simulate_scan(
    world: SyntheticWorld,
    pose: np.ndarray,
    t: float = 0.0,
    max_range: float = 60.0,
    min_range: float = 2.0,
    n_points: int = 16384,
    noise: float = 0.02,
    dropout: float = 0.02,
    seed: int = 0,
):
    """Simulate one scan at world pose `pose` (sensor frame = pose frame).

    Returns (points [n_points, 3] float32 in SENSOR frame, mask [n_points]
    bool, bboxes [B, 8] in SENSOR frame). No occlusion model — the worlds are
    open corridors where it matters little for registration behavior.
    """
    rng = np.random.default_rng(seed)
    Tinv = np.linalg.inv(pose.astype(np.float64))

    pts_w = [world.points]
    for b in world.boxes:
        pts_w.append(b.sample_surface(t, rng))
    pts_w = np.concatenate(pts_w)

    local = pts_w @ Tinv[:3, :3].T + Tinv[:3, 3]
    r = np.linalg.norm(local, axis=1)
    sel = np.flatnonzero((r >= min_range) & (r <= max_range))
    if len(sel) > n_points:
        sel = rng.choice(sel, n_points, replace=False)
    local = local[sel] + rng.normal(0, noise, (len(sel), 3))
    keep = rng.uniform(size=len(local)) >= dropout
    local = local[keep].astype(np.float32)

    out = np.zeros((n_points, 3), np.float32)
    mask = np.zeros(n_points, bool)
    m = min(len(local), n_points)
    out[:m] = local[:m]
    mask[:m] = True

    return out, mask, bboxes_for(world, pose, t)
