"""The port's A-LOAM against the benchmark's plain reference
(slam_bench/reference/aloam_mapping.py: float64, written from the
published A-LOAM), on seeded 16-ring x 256-bin sweeps of the benchmark
generator's spinning sensor over a small corridor.

Each check holds the port to the reference on the same inputs, with a
tolerance and its reason; the features, the scan-to-map step and the fold
are each failed by the port run on the sweep or its clouds rounded to
bfloat16, one precision below the port's float32. The odometry's check is
wider than bfloat16's effect, since the port's search departs from
laserOdometry's by more (its reason names the checks a bfloat16 program
fails instead). Torch is pinned to one
CPU thread while the file runs.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from slam_bench.reference import aloam_mapping as ref
from slam_bench.tests import small
from slam_bench.traffic.generator import make_drive

from lidar_slam_tpu_torch.ops.pointcloud import PointCloud
from lidar_slam_tpu_torch.pipeline import aloam as ta
from lidar_slam_tpu_torch.pipeline.aloam import mapping as tmapping

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RINGS, BINS = 16, 256
ROWS = RINGS * BINS
# the port's features are A-LOAM's up to its sector bounds (a ring's rows split by rank, where A-LOAM's
# sp/ep leave out its first 5 and last 6), its candidate tables and its less-flat filter over the whole
# sweep (A-LOAM filters ring by ring): on these sweeps 88-96 % of either side's sharp and less-sharp points
# are the other's to 1e-4 m, 76-89 % of the flats, 83-95 % of the less-flat points within 5 cm
SHARE = {"sharp": 0.8, "less_sharp": 0.9, "flat": 0.65, "less_flat": 0.75}
SAME_M = {"sharp": 1e-4, "less_sharp": 1e-4, "flat": 1e-4, "less_flat": 0.05}
# the port's odometry matches each corner and flat among its 8 nearest previous points, where laserOdometry
# searches the whole of the adjacent rings: from the constant-velocity guess the two land 4-15 cm apart
# (pose gap: translation + 10 m x angle) on this drive; rounding the clouds to bfloat16 moves the port less,
# so no tolerance of this check separates the two: the program in bfloat16 passes it and fails
# test_features_are_scan_registrations (under half of its sharp points are the reference's) and
# test_mapping_step_is_laser_mappings (10.6-13.6 mm against MAPPING_TOL)
ODOMETRY_TOL = 0.25
# the port's scan-to-map step against the reference's on the same maps and stacks: float32 sums and the
# port's CPU neighbour search (its bucket_k cut) land 2-3.5 mm apart; bfloat16 clouds 10.6-13.6 mm
MAPPING_TOL = 6e-3
# the fold: the same voxels, centroids in float32 against float64
FOLD_TOL = 1e-4
FRAMES = (30, 39)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sweep_config() -> dict:
    """The A-LOAM configuration's sweep at 16 rings (VLP-16's beams, the
    16-ring formula's) x 256 bins, 40 m."""
    with open(os.path.join(ROOT, "slam_bench", "configs", "kitti_hdl64_aloam.json")) as f:
        c = json.load(f)
    return dict(c["sweep"], elevations_deg=[-15.0 + 2.0 * k for k in range(RINGS)], azimuth_bins=BINS, rows=ROWS,
                max_range_m=40.0)


def small_mix() -> dict:
    """The small shuttle (slam_bench/tests/small.py) at density 400, short
    legs and a quick start, so that a lap is ~60 sweeps."""
    m = copy.deepcopy(small.mix())
    m["world"]["density"] = 400.0
    m["route"].update(leg_m=8.0, cruise_m_per_frame=0.6, accel_m_per_frame2=0.1)
    return m


FE = ta.FeatureExtractionConfig(n_scans=RINGS, min_range=5.0, capacity=ROWS, max_sharp=256, max_less_sharp=2048,
                                max_flat=512, max_less_flat=ROWS)
ODO = ta.AloamOdometryConfig(outer_iters=2, gn_iters=4)
MAP = ta.AloamMappingConfig(stack_corner_capacity=2048, stack_surf_capacity=4096, corner_map_capacity=32768,
                            surf_map_capacity=32768)


@pytest.fixture(scope="module")
def drive():
    return make_drive(small_mix(), sweep_config(), "cpu", 16.0)


def bf16(cloud: PointCloud) -> PointCloud:
    return PointCloud(points=cloud.points.to(torch.bfloat16).to(torch.float32), mask=cloud.mask)


def port_features(drive, f, rounded=False):
    pts = torch.as_tensor(drive.frame(f)["points"])
    if rounded:
        pts = pts.to(torch.bfloat16).to(torch.float32)
    p, m = torch.zeros(ROWS, 3), torch.zeros(ROWS, dtype=torch.bool)
    p[:len(pts)], m[:len(pts)] = pts, True
    return ta.extract_features(p, m, FE)


def share_within(a: torch.Tensor, b: torch.Tensor, tol: float) -> float:
    """The share of a's points with one of b's within tol."""
    return float((torch.cdist(a.double(), b.double()).min(dim=1).values <= tol).double().mean())


def as_reference(f: ta.ScanFeatures) -> dict:
    out = {}
    for name in ("sharp", "less_sharp", "flat", "less_flat"):
        c = getattr(f, name)
        out[name], out[f"{name}_ring"] = c.points[c.mask].double(), getattr(f, f"{name}_ring")[c.mask].long()
    return out


@pytest.mark.parametrize("frame", FRAMES)
def test_features_are_scan_registrations(drive, frame):
    """The port's four clouds against the reference's, both ways; on the
    sweep rounded to bfloat16 the port's points are nobody's."""
    mine = ref.features(drive.frame(frame)["points"], RINGS, FE.min_range, "cpu")
    port, rounded = port_features(drive, frame), port_features(drive, frame, rounded=True)
    for name, share in SHARE.items():
        c = getattr(port, name)
        p = c.points[c.mask]
        assert len(p) and share_within(mine[name], p, SAME_M[name]) >= share, name
        assert share_within(p, mine[name], SAME_M[name]) >= share, name
    assert share_within(rounded.sharp.points[rounded.sharp.mask], mine["sharp"], SAME_M["sharp"]) < 0.5
    assert int(port.capped) == 0


@pytest.mark.parametrize("frame", FRAMES)
def test_odometry_step_is_laser_odometrys(drive, frame):
    """The port's frame-to-frame step and the reference's laserOdometry on
    the port's features, from the constant-velocity guess."""
    prev, cur = port_features(drive, frame - 1), port_features(drive, frame)
    truth = [np.asarray(drive.truth[k], np.float64) for k in (frame - 2, frame - 1)]
    guess = np.linalg.inv(truth[0]) @ truth[1]
    port = ta.odometry_step(prev.less_sharp, prev.less_sharp_ring, prev.less_flat, prev.less_flat_ring, cur.sharp,
                            cur.flat, torch.as_tensor(guess, dtype=torch.float32), ODO).numpy()
    mine = ref.odometry(as_reference(prev), as_reference(cur), guess, ODO.outer_iters, ODO.gn_iters)
    assert ref.pose_gap(port, mine) <= ODOMETRY_TOL


@pytest.fixture(scope="module")
def maps(drive):
    """The port's maps folded from its own stacks of sweeps 0 .. max(FRAMES)
    at the truth: ({frame: (maps and stacks) before it} for FRAMES, [every
    13th fold's inputs, outputs and evictions])."""
    cm = PointCloud(points=torch.zeros(MAP.corner_map_capacity, 3),
                    mask=torch.zeros(MAP.corner_map_capacity, dtype=torch.bool))
    sm = PointCloud(points=torch.zeros(MAP.surf_map_capacity, 3),
                    mask=torch.zeros(MAP.surf_map_capacity, dtype=torch.bool))
    kept, folds = {}, []
    for f in range(max(FRAMES) + 1):
        feats = port_features(drive, f)
        c, s, _ = tmapping.downsample_stacks(feats.less_sharp, feats.less_flat, MAP)
        if f in FRAMES:
            kept[f] = (cm, sm, c, s)
        T = torch.as_tensor(drive.truth[f], dtype=torch.float32)
        new_c, new_s, evicted, _ = tmapping.map_update(cm, sm, c, s, T, MAP)
        if f % 13 == 12:
            folds.append((cm, sm, c, s, T, new_c, new_s, evicted))
        cm, sm = new_c, new_s
    return kept, folds


def _f64(c: PointCloud) -> torch.Tensor:
    return c.points[c.mask].double()


@pytest.mark.parametrize("frame", FRAMES)
def test_mapping_step_is_laser_mappings(drive, maps, frame):
    """The port's scan-to-map step and the reference's on the same maps and
    stacks, from the truth 6 cm off; the port on the clouds rounded to
    bfloat16 lands outside the tolerance."""
    cm, sm, c, s = maps[0][frame]
    guess = np.asarray(drive.truth[frame], np.float64).copy()
    guess[:3, 3] += [0.05, -0.03, 0.02]
    mine = ref.scan_to_map(_f64(cm), _f64(sm), _f64(c), _f64(s), guess, MAP.outer_iters, MAP.gn_iters)
    T0 = torch.as_tensor(guess, dtype=torch.float32)
    port = tmapping.mapping_step(cm, sm, c, s, T0, MAP).numpy()
    rounded = tmapping.mapping_step(bf16(cm), bf16(sm), bf16(c), bf16(s), T0, MAP).numpy()
    assert ref.pose_gap(port, mine) <= MAPPING_TOL < ref.pose_gap(rounded, mine)


def test_fold_is_laser_mappings(maps):
    """The port's fold under capacity against the reference's on the same
    maps, stacks and poses: the same voxels, centroids within FOLD_TOL,
    nothing evicted; the bfloat16 stacks' fold is not."""
    for cm, sm, c, s, T, new_c, new_s, evicted in maps[1]:
        assert evicted.tolist() == [0, 0]
        for old, stack, new, leaf in ((cm, c, new_c, MAP.line_res), (sm, s, new_s, MAP.plane_res)):
            mine = ref.fold(_f64(old), _f64(stack), T.double().numpy(), leaf, MAP.crop_radius)
            got = _f64(new)
            assert len(got) == len(mine) and share_within(got, mine, FOLD_TOL) == 1.0
            assert share_within(mine, got, FOLD_TOL) == 1.0
        rounded = tmapping.map_update(cm, sm, bf16(c), bf16(s), T, MAP)[0]
        assert share_within(_f64(rounded), ref.fold(_f64(cm), _f64(c), T.double().numpy(), MAP.line_res,
                                                     MAP.crop_radius), FOLD_TOL) < 0.99


def test_knn_work_is_chip_smokes_count():
    """slam_bench/roofline_knn.py's count of a K2 launch, made on the device
    without a sync, is chip_smoke.py's `knn_work` (the program's own count,
    which it freezes) on the same search, with and without extras."""
    import sys

    from slam_bench import roofline_knn

    from lidar_slam_tpu_torch.ops.cuda.knn_fused import knn_exact_plain
    from lidar_slam_tpu_torch.ops.hashgrid import build_bucket_grid

    sys.path.insert(0, ROOT)
    import chip_smoke

    g = torch.Generator().manual_seed(4)
    pts = torch.rand(3000, 3, generator=g) * torch.tensor([30.0, 20.0, 6.0])
    cloud = PointCloud(points=pts, mask=torch.rand(3000, generator=g) < 0.9)
    grid = build_bucket_grid(cloud, 1.0, (64, 64, 16))
    q = torch.rand(500, 3, generator=g) * torch.tensor([30.0, 20.0, 6.0])
    qm = torch.rand(500, generator=g) < 0.8
    ring = torch.randint(0, 16, (3000,), generator=g, dtype=torch.int32)
    for k, extras in ((5, None), (8, ring)):
        res = knn_exact_plain(grid, q, qm, k, 1.0, extras)
        n_extra = 0 if extras is None else 1
        got = roofline_knn.work(grid, q, qm, k, n_extra, res["ok"]).tolist()
        assert got == list(chip_smoke.knn_work(grid, q, qm, k, n_extra, int(res["ok"].sum())))
