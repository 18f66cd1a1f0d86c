"""The endurance harness with the A-LOAM front end (endurance.py
--front-end aloam) and its witnesses (endurance_witness.py,
aloam_witness.py) on the CPU.

The spinning drive: repeatable from its seeds, n_scans x n_azimuth rows a
sweep, the visible world's sweep the whole world's to the bit (at the
endurance corridor's own geometry too), the same frames from the pool of
simulating processes as from this one. The harness: `mapping --front-end
aloam --device cpu` over the short out-and-back of
tests/test_torch_endurance.py, its A-LOAM front end at narrow widths
(feature caps and maps as tests/test_torch_aloam.py sizes them, 8 192-row
sweeps), the record well formed, no return cut, the maps' fill recorded,
K2 not launched on the CPU, the kept states (AloamPicks) round-tripping
through convert.aloam_state_from_numpy in the JAX field order. The
witnesses: the JAX back end over the record, the JAX `aloam_step` over the
kept states within POSE_TOL (5e-3 m / rad, tests/test_torch_aloam.py), the
features equal once the rows on the ring formula's edges are moved to the
port's side, the fold equal to MAP_TOL. Pinned reference behaviour: the
64-ring formula's edges (2, -8.83, -24.33 deg) are hdl64_elevations'
beams 0, 32 and 63, and whether a row on one is kept, or which ring it
gets, is the last bit of a float32 atan2: JAX's own jitted and eager
computations put one such row on opposite sides. Torch is pinned to one
CPU thread while the file runs.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # endurance.py and the witnesses

import aloam_witness  # noqa: E402
import endurance as E  # noqa: E402
from test_torch_endurance import SHORT, SMALL_CONFIG  # noqa: E402

from lidar_slam_tpu.pipeline.aloam import feature_extraction as jfeatures  # noqa: E402
from lidar_slam_tpu.pipeline.aloam.pipeline import AloamState as JaxAloamState  # noqa: E402

from lidar_slam_tpu_torch import convert  # noqa: E402
from lidar_slam_tpu_torch.pipeline import aloam as ta  # noqa: E402
from lidar_slam_tpu_torch.pipeline.aloam import feature_extraction as tfeatures  # noqa: E402

N_AZIMUTH = 128  # 64 x 128 = 8 192-row sweeps
ROWS = E.N_SCANS * N_AZIMUTH
DENSITY = 300.0
FE = ta.FeatureExtractionConfig(n_scans=64, min_range=2.5, capacity=ROWS, max_sharp=128, max_less_sharp=1024,
                                max_flat=256, max_less_flat=2048)
ODO = ta.AloamOdometryConfig(chunk=1024)
MAP = ta.AloamMappingConfig(corner_map_capacity=4096, surf_map_capacity=8192, grid_dims=(64, 64, 16), chunk=1024,
                            stack_corner_capacity=2048, stack_surf_capacity=4096)
SAMPLE_EVERY = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def short_drive(workers=0):
    s = E.shuttle_arclength(200, SHORT["shuttle"], turn=SHORT["turn"], accel=SHORT["accel"])
    n = int(np.searchsorted(s, 2 * SHORT["shuttle"].leg + SHORT["shuttle"].arc))
    return E.aloam_drive(workers=workers, n_frames=n, **{**SHORT, "density": DENSITY, "n_points": ROWS})


@pytest.fixture(scope="module")
def aloam_run(tmp_path_factory):
    """The short lap through `mapping --front-end aloam --device cpu`, with
    every AloamPicks state kept: (drive, run, report, record, states)."""
    root = tmp_path_factory.mktemp("aloam_endurance")
    config = root / "config.yaml"
    config.write_text(SMALL_CONFIG)
    d = short_drive()
    run = E.run_mapping(d, str(root / "map"), str(config), device="cpu", sample_every=SAMPLE_EVERY, front_end="aloam",
                        aloam_configs=(FE, ODO, MAP), aloam_states="auto")
    rep = E.report(run, d)
    record, states = root / "record.npz", root / "states.npz"
    E.save_record(str(record), run, d)
    E.save_aloam_states(str(states), run, d)
    return d, run, rep, record, states


def test_spinning_drive_repeats_and_fills_its_rows():
    """A spinning sweep has n_scans x n_azimuth rows, repeats to the bit
    from its seed, is the whole world's over visible_world, carries the
    trucks' boxes; the frame source gives its returns. At the endurance
    corridor's own geometry (density cut to 1000) the visible world's
    sweep is the whole world's too, at the legs and in a U-turn."""
    from lidar_slam_tpu_torch.io.synthetic import bboxes_for

    d = short_drive()
    for i in (0, len(d) // 2, len(d) - 1):
        pts, mask, boxes = d.scan(i)
        assert pts.shape == (ROWS, 3) and mask.shape == (ROWS,) and 2000 < mask.sum() < ROWS
        again = d.scan(i)
        whole = d.scan(i, whole_world=True)
        for other in (again, whole):
            np.testing.assert_array_equal(other[0], pts)
            np.testing.assert_array_equal(other[1], mask)
        np.testing.assert_array_equal(boxes, bboxes_for(d.world, d.gt[i], i * 0.1))
    frame = d.frame(0)
    pts, mask, _ = d.scan(0)
    np.testing.assert_array_equal(frame["points"], pts[mask])
    assert frame["sim_s"] > 0

    full = E.aloam_drive(workers=0, n_frames=E.first_lap_frames(E.endurance_drive()) + 1, density=1000.0)
    assert full.n_points == E.RAW_ROWS == E.N_SCANS * E.N_AZIMUTH
    turn = next(i for i in range(len(full)) if full.in_turn(i))
    for i in (0, turn, len(full) - 1):
        visible = full.visible_world(i)
        assert len(visible.points) < 0.8 * len(full.world.points)
        a, b = full.scan(i), full.scan(i, whole_world=True)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_pooled_frames_are_the_same_frames():
    """Frames simulated by two spawned processes are this process's, in
    order, whether the pool starts when the frames are asked for or earlier
    (Drive.start, three frames queued); stop() ends a started pool."""
    here = short_drive()
    expected = list(here.frames(5))
    lazy, early = short_drive(workers=2), short_drive(workers=2)
    early.start(3)
    for pooled in (lazy, early):
        for a, b in zip(expected, pooled.frames(5), strict=True):
            for key in ("points", "bboxes", "gnss_pose", "gnss_position", "time"):
                np.testing.assert_array_equal(a[key], b[key])
        assert pooled.returns == here.returns and len(pooled.source_s) == 5
    unused = short_drive(workers=1)
    unused.start(2)
    unused.stop()
    assert unused._started is None


def test_aloam_harness_through_the_cli_on_the_cpu(aloam_run, capsys):
    """`mapping --front-end aloam` on the CPU: exit 0, loops within
    LOOP_TOL, every sweep within the front end's rows (the CLI's own rule
    asks the configuration's aloam.features.capacity, 131 072 without a
    section, never fewer under --synthetic), the maps' fill every frame within their
    capacities and in the memory samples, no kernel launched on the CPU,
    and the record's A-LOAM arrays."""
    d, run, rep, record, _ = aloam_run
    assert rep["rc"] == 0 and rep["front_end"] == "aloam" and rep["frames"] == len(d)
    assert rep["loops"] and all(lp["error"] <= E.LOOP_TOL for lp in rep["loops"])
    assert rep["capacity"] == ROWS and rep["cli_capacity"] == 131072 and rep["cut_frames"] == []
    assert E.check(rep, min_keyframes=10, min_loops=1, min_returns=2000) == []
    assert rep["launches"] == {"ndt_newton": 0, "ndt_reduce_fused": 0, "window_knn": 0, "gather_stats_onehot": 0}
    assert run.fill.shape == (len(d), 2) and (run.fill > 0).all() and rep["at_capacity"] == []
    assert (run.fill < np.asarray(run.fill_capacity)).all() and run.fill_capacity == (4096, 8192)
    assert rep["aloam_mean_error"] < E.ALOAM_GUARD
    for m in rep["memory"]:
        assert 0 < m["corner_map"] < m["corner_capacity"] == 4096 and 0 < m["surf_map"] < m["surf_capacity"] == 8192
    assert rep["memory"][-1]["corner_map"] == run.fill[-1, 0]
    rec = np.load(record)
    assert str(rec["front_end"]) == "aloam" and json.loads(str(rec["drive"]))["spinning"]
    np.testing.assert_array_equal(rec["fill"], run.fill)
    assert rec["returns"].tolist() == d.returns and len(rec["odom"]) == len(d)
    E.print_report(rep, " cpu")
    out = capsys.readouterr().out.splitlines()
    assert sum("A-LOAM" in ln for ln in out) == 4 and all(ln.startswith("[endurance cpu] ") for ln in out)
    assert sum("its fold dropped nothing" in ln for ln in out) == 2


def test_check_fails_a_cut_sweep_or_a_full_map(aloam_run):
    """check() fails a sweep with more returns than the front end's rows,
    and an A-LOAM map at its capacity whose fold's dropped voxels are not
    recorded (fold_drops records them); on the card, any launch count but
    window_knn's 10 a sweep and ndt_newton's one an attempt."""
    _, run, rep, _, _ = aloam_run
    assert rep["drops_recorded"] and run.drops.shape == (len(run.fill), 2, 4)
    assert rep["dropped"] == {"corner": None, "surf": None}
    limits = dict(min_keyframes=10, min_loops=1, min_returns=2000)
    assert E.check(dict(rep, cut_frames=[3]), **limits)[0].startswith("1 sweeps")
    assert E.check(dict(rep, at_capacity=[7]), **limits) == []
    assert "capacity" in E.check(dict(rep, at_capacity=[7], drops_recorded=False), **limits)[0]
    # on the card the memory samples carry device bytes: flat here, and counted from keyframe SAMPLE_EVERY
    card = dict(rep, device="cuda", memory=[dict(m, allocated=0, keyframes=E.SAMPLE_EVERY) for m in rep["memory"]])
    good = dict(card["launches"], window_knn=E.K2_PER_SWEEP * rep["frames"], ndt_newton=rep["attempts"])
    assert E.check(dict(card, launches=good), **limits) == []
    bad = dict(good, window_knn=good["window_knn"] - E.K2_PER_SWEEP)
    assert E.check(dict(card, launches=bad), **limits)[0].startswith("launches")


def test_fold_drops_names_the_voxels_a_full_map_dropped(aloam_run):
    """fold_drops on a kept frame folded into a corner map of a third of its
    voxels: the voxels offered are the uncapped fold's, the capped fold
    keeps the `capacity` of them nearest the sensor (keep_near, every one
    in laserMapping's window here) and drops the rest, none of them nearer
    the sensor than a kept one, and names the dropped voxels' x range; a
    map under its capacity dropped nothing."""
    from lidar_slam_tpu_torch.pipeline.aloam.mapping import downsample_stacks, keep_near, map_update

    _, run, _, _, _ = aloam_run
    e = run.picks["last frame"]
    before, after, pose = e["before"], e["after"], e["pose"]
    stacks = downsample_stacks(after.prev_less_sharp, after.prev_less_flat, MAP)[:2]
    T = torch.as_tensor(pose)
    whole = map_update(before.corner_map, before.surf_map, *stacks, T, MAP)
    offered = int(whole[0].mask.sum())
    cap = offered // 3
    small = dataclasses.replace(MAP, corner_map_capacity=cap)
    corner, surf, _, _ = map_update(before.corner_map, before.surf_map, *stacks, T, small)
    kept, keep, inside = keep_near(whole[0], T[:3, 3], cap)
    assert int(corner.mask.sum()) == cap and torch.equal(corner.points, kept.points)
    assert bool(inside[whole[0].mask].all())
    fill = [cap, int(surf.mask.sum())]
    (c_off, c_drop, x_lo, x_hi), (s_off, s_drop, _, _) = E.fold_drops(
        before, dataclasses.replace(after, corner_map=corner, surf_map=surf), pose, small, fill)
    assert (c_off, c_drop) == (offered, offered - cap) and (s_off, s_drop) == (fill[1], 0)
    dropped = whole[0].points[whole[0].mask & ~keep]
    assert x_lo == pytest.approx(float(dropped[:, 0].min())) and x_hi == pytest.approx(float(dropped[:, 0].max()))
    near = lambda p: torch.linalg.norm(p - T[:3, 3], dim=-1)  # noqa: E731
    assert float(near(corner.points[corner.mask]).max()) <= float(near(dropped).min())


def test_endurance_witness_replays_the_aloam_record(aloam_run, capsys):
    """The JAX back end over the A-LOAM run's record: the same keyframes,
    solves at the same frames, optimized keyframes within GAP_TOL."""
    import endurance_witness

    assert endurance_witness.main([str(aloam_run[3])]) == 0
    out = capsys.readouterr().out
    assert "(the same frames)" in out and "(at the same frames)" in out


def test_aloam_witness_holds_the_kept_states(aloam_run, tmp_path, capsys):
    """AloamPicks keeps frame 2, the fullest leg frame, the worst U-turn
    frame, the worst frame and the last frame; aloam_witness.py finds the
    JAX step on each within POSE_TOL of the port's, on the sweep as it is
    or with its rows on the ring formula's edges moved to the port's side
    (the reference behaviour pinned below), the features equal once those
    rows are moved, the fold equal (exit 0)."""
    d, run, _, _, states = aloam_run
    assert set(run.picks) == {"first warm-started odometry", "fullest maps on a leg", "worst U-turn frame",
                              "worst frame", "last frame"}
    assert run.picks["first warm-started odometry"]["frame"] == 2 and run.picks["last frame"]["frame"] == len(d) - 1
    assert d.in_turn(run.picks["worst U-turn frame"]["frame"])
    assert not d.in_turn(run.picks["fullest maps on a leg"]["frame"])
    out_json = tmp_path / "w.json"
    assert aloam_witness.main([str(states), "--json", str(out_json)]) == 0
    w = json.loads(out_json.read_text())
    assert not w["cli_configs"] and len(w["frames"]) == len(np.load(states)["frames"])
    for f in w["frames"]:
        assert f["verdict"] in ("within", "ring edges") and f["checks_ok"] and f["edge_rows"] > 0, f
        held = f["raw"] if f["verdict"] == "within" else f["nudged"]
        assert max(held["pose_gap"]) <= aloam_witness.POSE_TOL and held["motion_error"] < E.LOST_STEP
    assert "every frame within POSE_TOL or split" in capsys.readouterr().out


def test_kept_states_round_trip_in_the_jax_field_order(aloam_run):
    """The saved leaves, in the JAX AloamState's field order, give back the
    port's kept state through convert.aloam_state_from_numpy, leaf for
    leaf to the bit; the sweep and the port's ring verdicts are the kept
    ones."""
    _, run, _, _, states = aloam_run
    z = np.load(states)
    assert tuple(z["fields"]) == E.ALOAM_FIELDS == tuple(f.name for f in dataclasses.fields(JaxAloamState))
    for j, frame in enumerate(z["frames"]):
        entry = next(e for e in run.picks.values() if e["frame"] == frame)
        for prefix, state in (("before_", entry["before"]), ("after_", entry["after"])):
            args = [(z[f"{prefix}{k}_points"][j], z[f"{prefix}{k}_mask"][j]) if f"{prefix}{k}_points" in z.files
                    else z[f"{prefix}{k}"][j] for k in E.ALOAM_FIELDS]
            back = convert.aloam_state_from_numpy(*args, device="cpu")
            for k in E.ALOAM_FIELDS:
                a, b = getattr(back, k), getattr(state, k)
                pairs = [(a.points, b.points), (a.mask, b.mask)] if hasattr(a, "points") else [(a, b)]
                for x, y in pairs:
                    assert x.dtype == y.dtype and torch.equal(x, y), (frame, prefix, k)
        np.testing.assert_array_equal(z["points"][j], entry["sweep"][0].numpy())
        ring, ok = tfeatures._ring_id(entry["sweep"][0], 64)
        np.testing.assert_array_equal(z["port_ring"][j], ring.numpy())
        np.testing.assert_array_equal(z["port_ring_ok"][j], ok.numpy())


def test_ring_formula_edges_are_a_reference_behaviour():
    """hdl64_elevations' beams 0, 32 and 63 sit on the 64-ring formula's
    edges (aloam_witness.RING_EDGES), so a row on one is kept or dropped,
    or given ring 32 or 33, by the last bit of a float32 elevation: the
    JAX package's jitted extract_features keeps this top-beam return
    (2.0000000865 deg in float64), its eager ring formula drops it, and so
    does the port's. edge_nudge moves such a row to a given side, after
    which every computation agrees."""
    from lidar_slam_tpu_torch.io.synthetic import hdl64_elevations

    el = hdl64_elevations()
    assert (el[0], el[32], el[63]) == aloam_witness.RING_EDGES
    p = np.array([[-9.872839, 8.307262, 0.4505775]], np.float32)
    assert abs(np.degrees(np.arctan2(p[0, 2], np.hypot(p[0, 0], p[0, 1]))) - 2.0) < aloam_witness.EDGE_DEG
    jitted = np.asarray(jax.jit(lambda q: jfeatures._ring_id(q, 64))(jnp.asarray(p))[1])
    eager = np.asarray(jfeatures._ring_id(jnp.asarray(p), 64)[1])
    port = tfeatures._ring_id(torch.as_tensor(p), 64)[1].numpy()
    assert jitted.tolist() == [True] and eager.tolist() == [False] and port.tolist() == [False]
    for keep in (True, False):
        moved, n, gap = aloam_witness.edge_nudge(p, np.array([True]), np.array([0]), np.array([keep]), 64)
        assert n == 1 and 0 < gap < 1e-4
        for ok in (np.asarray(jax.jit(lambda q: jfeatures._ring_id(q, 64))(jnp.asarray(moved))[1]),
                   np.asarray(jfeatures._ring_id(jnp.asarray(moved), 64)[1]),
                   tfeatures._ring_id(torch.as_tensor(moved), 64)[1].numpy()):
            assert ok.tolist() == [keep]


def test_harness_scripts_leave_jax_out():
    """endurance.py and chip_smoke.py, imported with the drive's A-LOAM
    pieces they call, import no jax and nothing of the JAX package."""
    import subprocess

    code = ("import sys, endurance, chip_smoke\n"
            "from lidar_slam_tpu_torch.pipeline.aloam import mapping, pipeline\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'lidar_slam_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, check=True,
                         cwd=ROOT)
    assert out.stdout.splitlines()[-1] == "[]", out.stdout


def _corridor_fold(cap, pose_x, far=0):
    """The port's and the JAX package's map_update of a corridor's
    corner map (edge points along 60 m of x, and `far` more 150-170 m on,
    outside laserMapping's window of a sensor at x = `pose_x` but inside
    the +-150 m box) with a stack seen there, at corner capacity `cap`."""
    from lidar_slam_tpu.ops.pointcloud import PointCloud as JCloud
    from lidar_slam_tpu.pipeline.aloam import mapping as jmapping

    from lidar_slam_tpu_torch.ops.pointcloud import PointCloud as TCloud
    from lidar_slam_tpu_torch.pipeline.aloam import mapping as tmapping

    rng = np.random.default_rng(5)
    old = rng.uniform([-5, -8, 0], [55, 8, 6], (6000, 3))
    if far:
        old = np.concatenate([old, rng.uniform([pose_x + 130, -8, 0], [pose_x + 145, 8, 6], (far, 3))])
    old = old.astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (pose_x, 0.0, 1.8)
    new = rng.uniform([pose_x - 10, -8, 0], [pose_x + 5, 8, 6], (1500, 3)).astype(np.float32)
    local = (new - pose[:3, 3]).astype(np.float32)
    cfg_j = jmapping.AloamMappingConfig(corner_map_capacity=cap, surf_map_capacity=cap)
    cfg_t = convert.config_from_fields(tmapping.AloamMappingConfig, dataclasses.asdict(cfg_j))
    surf = np.zeros((4, 3), np.float32)
    jm = jmapping.map_update(JCloud(points=jnp.asarray(old), mask=jnp.ones(len(old), bool)),
                             JCloud(points=jnp.asarray(surf), mask=jnp.zeros(4, bool)),
                             JCloud(points=jnp.asarray(local), mask=jnp.ones(len(local), bool)),
                             JCloud(points=jnp.asarray(surf), mask=jnp.zeros(4, bool)), jnp.asarray(pose), cfg_j)
    args = (TCloud(points=torch.as_tensor(old), mask=torch.ones(len(old), dtype=torch.bool)),
            TCloud(points=torch.as_tensor(surf), mask=torch.zeros(4, dtype=torch.bool)),
            TCloud(points=torch.as_tensor(local), mask=torch.ones(len(local), dtype=torch.bool)),
            TCloud(points=torch.as_tensor(surf), mask=torch.zeros(4, dtype=torch.bool)), torch.as_tensor(pose))
    return jm, tmapping.map_update(*args, cfg_t), args, cfg_t, pose


def test_full_map_fold_keeps_the_window_around_the_sensor():
    """Under capacity the port's fold is the JAX package's (the same masks,
    points within MAP_TOL) and its own earlier fold's, voxel_downsample's
    first `capacity` voxels, to the bit, and evicts nothing. Past capacity
    it keeps the map around the sensor (ROADMAP section C): with the sensor
    at the corridor's +x end the voxels farthest from it go, where the JAX
    fold drops the largest x and so every voxel near the sensor; voxels
    outside laserMapping's 5 x 5 x 3 window of 50 m cubes go before any
    inside it, however near; the counters are the masks' sums."""
    from lidar_slam_tpu_torch.geom.se3 import transform_points
    from lidar_slam_tpu_torch.ops.pointcloud import PointCloud as TCloud, voxel_downsample
    from lidar_slam_tpu_torch.pipeline.aloam import mapping as tmapping

    jm, (corner, _, evicted, in_window), args, cfg, pose = _corridor_fold(16384, 55.0)
    a, b = np.asarray(jm[0].mask), corner.mask.numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(np.asarray(jm[0].points)[a], corner.points.numpy()[b], rtol=0,
                               atol=aloam_witness.MAP_TOL)
    old, _, stack, _, T = args
    pts = torch.cat([old.points, transform_points(T, stack.points)])
    earlier = voxel_downsample(TCloud(points=pts, mask=torch.ones(len(pts), dtype=torch.bool)), cfg.line_res,
                               out_capacity=16384)
    assert torch.equal(earlier.points, corner.points) and torch.equal(earlier.mask, corner.mask)
    assert evicted.tolist() == [0, 0] and in_window.tolist() == [0, 0]

    cap = 2048
    jm, (corner, _, evicted, in_window), args, cfg, pose = _corridor_fold(cap, 55.0)
    kept = corner.points.numpy()[corner.mask.numpy()]
    jkept = np.asarray(jm[0].points)[np.asarray(jm[0].mask)]
    assert len(kept) == len(jkept) == cap
    near = np.linalg.norm(kept[:, :2] - pose[:2, 3], axis=1)
    assert jkept[:, 0].max() < 35.0 and near.max() < 20.0  # JAX keeps nothing within 20 m, the port nothing beyond
    offered = int(tmapping.map_update(*args[:4], args[4], dataclasses.replace(cfg, corner_map_capacity=65536))[0]
                  .mask.sum())
    assert evicted.tolist() == [offered - cap, 0] and in_window.tolist() == [offered - cap, 0]

    jm, (corner, _, evicted, in_window), args, cfg, pose = _corridor_fold(cap, 55.0, far=1000)
    whole = tmapping.map_update(*args[:4], args[4], dataclasses.replace(cfg, corner_map_capacity=65536))[0]
    inside = tmapping.in_window(whole.points, args[4][:3, 3]) & whole.mask
    outside = whole.mask & ~inside
    assert int(outside.sum()) > 0 and int(inside.sum()) > cap  # the far voxels go first, then the farthest inside
    kept = corner.points[corner.mask]
    assert not bool(tmapping.in_window(kept, args[4][:3, 3]).logical_not().any())
    assert evicted.tolist() == [int(whole.mask.sum()) - cap, 0]
    assert in_window.tolist() == [int(inside.sum()) - cap, 0]


@pytest.mark.parametrize("offered", [4096, 4097])
def test_fold_keeps_a_near_window_voxel_over_a_far_outer_one(offered):
    """keep_near on a full map: the voxel just inside the window is kept
    over one just outside it that lies nearer the sensor (the window's
    cubes, not the distance, come first); the counts kept are the masks'."""
    from lidar_slam_tpu_torch.ops.pointcloud import PointCloud as TCloud
    from lidar_slam_tpu_torch.pipeline.aloam.mapping import CUBE_M, keep_near

    pos = torch.tensor([10.0, 0.0, 1.8])
    rng = np.random.default_rng(3)
    pts = torch.as_tensor(rng.uniform([-20, -8, 0], [40, 8, 6], (offered, 3)).astype(np.float32))
    # the sensor's cube spans x in [-25, 25); the window reaches x < 125 and z < 75 (one cube up)
    pts[0] = torch.tensor([124.0, 0.0, 1.0])  # inside, 114 m away
    pts[1] = torch.tensor([10.0, 0.0, 80.0])  # outside (two cubes up), 78 m away
    cloud = TCloud(points=pts, mask=torch.ones(offered, dtype=torch.bool))
    out, keep, inside = keep_near(cloud, pos, 4096)
    assert CUBE_M == 50.0 and bool(inside[0]) and not bool(inside[1])
    assert bool(keep[0]) and bool(keep[1]) == (offered == 4096)
    assert int(keep.sum()) == int(out.mask.sum()) == 4096
    assert torch.equal(out.points[out.mask], pts[keep])


def test_aloam_witness_names_a_full_fold_its_rule():
    """aloam_witness.map_verdict: a map that differs where JAX's fold
    filled the capacity departs by the fold's rule, no failure; under
    capacity a difference fails."""
    tol = aloam_witness.MAP_TOL
    assert aloam_witness.map_verdict(True, 0.0, 100, 4096) == "equal"
    assert aloam_witness.map_verdict(False, 0.0, 4096, 4096) == "the fold's rule"
    assert aloam_witness.map_verdict(True, 10 * tol, 4096, 4096) == "the fold's rule"
    assert aloam_witness.map_verdict(False, 0.0, 4000, 4096) == "differs"


def test_aloam_witness_splits_down_to_the_knife_edge(aloam_run, monkeypatch):
    """With POSE_TOL at 0 every split of aloam_witness runs on a kept frame:
    the moved sweep, the exact neighbour sets, and the knife-edge probe
    (the exact step from PROBES' eight guesses 1 mm or 1 mrad off), whose
    spread is finite."""
    _, _, _, _, states = aloam_run
    z = np.load(states)
    monkeypatch.setattr(aloam_witness, "POSE_TOL", 0.0)
    fe, odo, mp, _ = aloam_witness.configs(str(z["configs"]))
    w = aloam_witness.witness_frame(z, 0, fe, odo, mp)
    assert w["verdict"] in ("knife edge", "port") and {"nudged", "exact", "knife_edge"} <= set(w)
    assert len(aloam_witness.PROBES) == 8 and all(np.isfinite(w["knife_edge"]))
    assert w["exact"]["bucket_k_odometry"] >= odo.bucket_k and w["exact"]["bucket_k_mapping"] >= mp.bucket_k
