"""The endurance harness (endurance.py) and its JAX witness
(endurance_witness.py) on the CPU.

The drive: repeatable from its seeds, within its speed, acceleration and
yaw limits, the keyframe count its 2 m gate predicts, a real HDL-64 sweep's
returns, the trucks' boxes in the detector channel. The harness: the port's
`mapping` CLI with `--device cpu` over a short out-and-back of the same
generator at narrow widths (16 384-row scans, 10 m legs, a 1.5 m U-turn,
GNSS loop detection with a small diff_num, in-loop solves), every report
field present, the memory samples' host fields finite, the solve log
against the graph's own count of solves. The witness: the JAX back end over
that run's record gives the same keyframes, solve frames and optimized
keyframes, and refuses a record with one loop edge moved. Torch is pinned
to one CPU thread while the file runs.
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # endurance.py and endurance_witness.py

import endurance as E  # noqa: E402

# The short lap's narrow widths: configs/synthetic_small.yaml's front end with a 1 m frame leaf, back-end
# solves every 6 keyframes and every loop on a 64-node graph, GNSS loop detection 4 keyframes apart.
SMALL_CONFIG = """front_end:
  ndt:
    resolution: 1.0
    grid_dims: [96, 96, 24]
    point_chunk: 2048
    max_iter: 25
    gather: auto
  frame_leaf: 1.0
  frame_capacity: 4096
  keyframe_capacity: 8192
  raw_capacity: 16384
  local_frame_num: 10
back_end:
  optimize_step_with_key_frame: 6
  optimize_step_with_loop: 1
  max_nodes: 64
  max_edges: 128
  max_priors: 64
  store_capacity: 8192
loop_closing:
  loop_method: gps
  loop_step: 1
  diff_num: 4
  detect_area: 6.0
  extend_frame_num: 1
  map_filter_leaf: 0.5
  scan_filter_leaf: 0.6
  ndt:
    resolution: 1.0
    grid_dims: [96, 96, 24]
    point_chunk: 2048
    max_iter: 25
  submap_capacity: 8192
  scan_capacity: 4096
viewer:
  map_capacity: 20000
"""
SHORT = dict(shuttle=E.Shuttle(x0=6.0, leg=10.0, radius=1.5), length=26.0, density=30.0, n_points=16384,
             max_range=40.0, turn=0.3, accel=0.3)
SAMPLE_EVERY = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def drive():
    return E.endurance_drive()


@pytest.fixture(scope="module")
def short_run(tmp_path_factory):
    """The short lap through the CLI on the CPU: (drive, run, report, the
    pose-graph solves the graph itself ran)."""
    from lidar_slam_tpu_torch.models import graph_optimizer

    root = tmp_path_factory.mktemp("endurance")
    config = root / "config.yaml"
    config.write_text(SMALL_CONFIG)
    s = E.shuttle_arclength(200, SHORT["shuttle"], turn=SHORT["turn"], accel=SHORT["accel"])
    n = int(np.searchsorted(s, 2 * SHORT["shuttle"].leg + SHORT["shuttle"].arc))
    d = E.endurance_drive(n_frames=n, **SHORT)
    solved = []
    base = graph_optimizer.PoseGraphBuilder.optimize

    def counting(self, *a, **k):
        solved.append(self.n_nodes)
        return base(self, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graph_optimizer.PoseGraphBuilder, "optimize", counting)
        run = E.run_mapping(d, str(root / "map"), str(config), device="cpu", sample_every=SAMPLE_EVERY)
    return d, run, E.report(run, d), solved


def test_drive_repeats_and_keeps_its_limits(drive):
    """The same drive from the same seeds; the speed at most CRUISE and
    changing by at most ACCEL a frame, at most TURN_SPEED and 6 degrees of
    yaw a frame in the U-turns; the 2 m gate on the truth leaves
    MIN_KEYFRAMES + KEYFRAME_MARGIN keyframes, about 4 laps; the first
    out-and-back ~130 of them."""
    again = E.endurance_drive()
    np.testing.assert_array_equal(again.gt, drive.gt)
    np.testing.assert_array_equal(again.gnss, drive.gnss)
    v = np.diff(drive.arclength)
    assert v.max() <= E.CRUISE + 1e-9 and np.abs(np.diff(v)).max() <= E.ACCEL + 1e-9
    turning = np.asarray([drive.shuttle.segment(s)[0].startswith("U-turn") for s in drive.arclength[:-1]])
    assert turning.any() and v[turning].max() <= E.TURN_SPEED + 1e-9
    yaw = np.arctan2(drive.gt[:, 1, 0], drive.gt[:, 0, 0])
    dyaw = np.abs((np.diff(yaw) + np.pi) % (2 * np.pi) - np.pi)
    assert dyaw.max() <= math.radians(6.0)
    steps = np.linalg.norm(np.diff(drive.gt[:, :3, 3], axis=0), axis=1)
    np.testing.assert_allclose(steps[~turning], v[~turning], atol=1e-3)  # the poses follow the arc length
    kfs = E.gate_keyframes(drive.gt)
    assert len(kfs) == E.MIN_KEYFRAMES + E.KEYFRAME_MARGIN and kfs[-1] == len(drive) - 1
    assert 3.5 <= drive.arclength[-1] / drive.shuttle.lap <= 4.5 and drive.arclength[-1] > 1000.0
    n = E.first_lap_frames(drive)
    assert drive.shuttle.segment(drive.arclength[n])[0] == "U-turn B"
    assert 110 <= len(E.gate_keyframes(drive.gt[:n])) <= 140
    err = np.linalg.norm(drive.gnss[:, :3, 3] - drive.gt[:, :3, 3], axis=1)
    assert 0.5 * E.GNSS_NOISE < np.sqrt(np.mean(err**2) / 3) < 1.5 * E.GNSS_NOISE
    np.testing.assert_allclose(drive.gnss[:, :3, :3], drive.gt[:, :3, :3])


def test_drive_scans_are_hdl64_sweeps_with_boxes(drive):
    """Sweeps at the legs' ends and in a U-turn hold at least MIN_RETURNS
    finite returns of RAW_ROWS, repeat to the bit, and carry the three
    trucks' detector boxes (bboxes_for: the sensor frame); the frame source
    gives each sweep's returns, its boxes and its GNSS fix."""
    from lidar_slam_tpu_torch.io.synthetic import bboxes_for

    x = drive.gt[:, 0, 3]
    ends = [0, int(np.argmax(x)), int(np.argmin(np.where(drive.gt[:, 1, 3] > 0, x, np.inf)))]
    for i in ends:
        pts, mask, boxes = drive.scan(i)
        assert pts.shape == (E.RAW_ROWS, 3) and mask.sum() >= E.MIN_RETURNS, (i, int(mask.sum()))
        np.testing.assert_array_equal(drive.scan(i)[0], pts)
        assert boxes.shape == (len(E.TRUCKS), 8)
        np.testing.assert_array_equal(boxes, bboxes_for(drive.world, drive.gt[i], i * 0.1))
    frame = next(drive.frames(1))
    pts, mask, boxes = drive.scan(0)
    np.testing.assert_array_equal(frame["points"], pts[mask])
    np.testing.assert_array_equal(frame["bboxes"], boxes)
    np.testing.assert_array_equal(frame["gnss_pose"], drive.gnss[0])
    np.testing.assert_array_equal(frame["gnss_position"], drive.gnss[0, :3, 3])


def test_config_names_gather_auto(tmp_path):
    """config_text is configs/kitti_hdl64.yaml with `gather: auto` named in
    the front end's ndt section, and nothing else changed."""
    from lidar_slam_tpu_torch.config import load_config

    text = E.config_text()
    base = (ROOT / "configs" / "kitti_hdl64.yaml").read_text()
    assert [ln for ln in text.splitlines() if ln not in base.splitlines()] == [
        "    gather: auto   # the FrontEndConfig default"]
    path = tmp_path / "config.yaml"
    path.write_text(text)
    cfg, plain = load_config(str(path)), load_config(str(ROOT / "configs" / "kitti_hdl64.yaml"))
    assert cfg.front_end.ndt.gather == "auto" and plain.front_end.ndt.gather == "two_level"
    assert cfg.back_end == plain.back_end and cfg.loop_closing == plain.loop_closing


def test_harness_through_the_cli_on_the_cpu(short_run, capsys):
    """The short lap through `mapping --device cpu`: exit 0, loops closed
    within LOOP_TOL of the truth, every report field present, the memory
    samples after the first frame, every SAMPLE_EVERY keyframes and before
    the map save with their host fields finite (the device's are None off the card), one solve
    logged for each solve the graph ran, with its frame and starter, and
    the saved map's cut."""
    d, run, rep, solved = short_run
    assert rep["rc"] == 0 and rep["frames"] == len(d)
    assert rep["keyframes"] == len(run.kf_frames) == len(run.optimized) >= 10
    assert rep["loops"] and all(lp["error"] <= E.LOOP_TOL for lp in rep["loops"])
    assert E.check(rep, min_keyframes=10, min_loops=1, min_returns=5000) == []
    for key in ("odometry_ate", "odometry_ate_by_lap", "worst_frame", "lost_frames", "keyframe_ate_odometry",
                "keyframe_ate_optimized", "stages", "divergences", "solves", "memory", "saved_map", "launches",
                "ms_per_frame", "source_ms_per_frame", "final_s", "returns_min", "attempts"):
        assert key in rep, key
    assert set(rep["stages"]) == {"front_end", "back_end", "loop_closing"}
    for st in rep["stages"].values():
        assert {"calls", "mean_ms", "worst_ms", "misses"} <= set(st)
    assert rep["stages"]["front_end"]["calls"] == len(d)
    labels = [m["label"] for m in rep["memory"]]
    n_kf = rep["keyframes"]
    assert labels == ["frame 0"] + [f"keyframe {k}" for k in range(SAMPLE_EVERY, n_kf + 1, SAMPLE_EVERY)] + [
        "end, before save_map"]
    for m in rep["memory"]:
        for key in ("vm_rss", "store_bytes", "sc_count", "sc_capacity", "nodes", "max_nodes", "edges", "max_edges",
                    "priors", "max_priors", "keyframes", "frame"):
            assert np.isfinite(m[key]) and m[key] >= 0, (key, m)
        assert m["allocated"] is None and m["max_allocated"] is None and m["reserved"] is None
        assert m["nodes"] == m["keyframes"] and m["max_nodes"] == 64
    assert rep["memory"][-1]["store_bytes"] > rep["memory"][1]["store_bytes"] > rep["memory"][0]["store_bytes"] > 0
    assert len(rep["solves"]) == len(solved) >= 3
    assert [s["nodes"] for s in rep["solves"]] == solved
    assert {s["by"] for s in rep["solves"]} == {"back_end", "insert_loop_pose", "final"}
    assert rep["solves"][-1]["by"] == "final" and rep["solves"][-1]["frame"] == len(d) - 1
    for s in rep["solves"]:
        assert s["iterations"] >= 1 and s["seconds"] > 0 and s["chi2_after"] <= s["chi2_before"] + 1e-6
    mp = rep["saved_map"]
    assert mp["map_points"] == 20000 and mp["map_capacity_dropped"] > 0
    assert rep["launches"] == {"ndt_newton": 0, "ndt_reduce_fused": 0, "window_knn": 0, "gather_stats_onehot": 0}
    E.print_report(rep, " cpu")
    out = capsys.readouterr().out.splitlines()
    assert out and all(ln.startswith("[endurance cpu] ") for ln in out)
    assert sum(ln.startswith("[endurance cpu] solve at frame") for ln in out) == len(solved)
    assert sum(ln.startswith("[endurance cpu] memory at") for ln in out) == len(labels)


def test_witness_replays_the_record(short_run, tmp_path, capsys):
    """endurance_witness.py over the short run's record: the JAX back end
    makes the same keyframes and solves at the same frames, its optimized
    keyframes within GAP_TOL of the port's (exit 0); a record with one loop
    edge moved to the last frame is refused (exit 1)."""
    import endurance_witness

    d, run, rep, _ = short_run
    path = tmp_path / "record.npz"
    E.save_record(str(path), run, d)
    assert endurance_witness.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "(the same frames)" in out and "(at the same frames)" in out
    assert "keyframe ATE, the port's optimized" in out and "keyframe ATE, JAX's optimized" in out
    gap = float(out.split("largest gap ")[1].split()[0])
    assert gap <= endurance_witness.GAP_TOL

    rec = dict(np.load(path))
    assert rec["loop_frames"][0] < len(d) - 1
    rec["loop_frames"] = rec["loop_frames"].copy()
    rec["loop_frames"][0] = len(d) - 1
    moved = tmp_path / "moved.npz"
    np.savez(moved, **rec)
    assert endurance_witness.main([str(moved)]) == 1
    assert "NOT at the same frames" in capsys.readouterr().out


def test_record_diff_names_what_moved(short_run, tmp_path):
    """record_diff (endurance.py --same-as): a record against itself saved
    twice differs nowhere; one odometry pose moved by one float32 ulp, or an
    array missing, is named."""
    d, run, _, _ = short_run
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    E.save_record(str(a), run, d)
    E.save_record(str(b), run, d)
    assert E.record_diff(str(a), str(b)) == []
    rec = dict(np.load(b))
    rec["odom"] = rec["odom"].copy()
    rec["odom"][3, 0, 3] = np.nextafter(rec["odom"][3, 0, 3], np.float32(np.inf))
    np.savez(b, **rec)
    assert E.record_diff(str(a), str(b)) == ["odom"]
    del rec["solve_by"]
    np.savez(b, **rec)
    assert E.record_diff(str(a), str(b)) == ["odom", "solve_by"]


def test_front_end_witness_splits_a_saved_state(short_run, tmp_path, capsys):
    """endurance.py --replay-front-end --state-out and front_end_witness.py
    over the short lap, its keyframe window cut to 4 so that the map evicts:
    the state holds every keyframe update before the frame (the fifth on
    evicting), and the JAX replay of those updates gives the same counts,
    the same grid corner and sums within float32 rounding of the port's;
    the JAX alignments land where the port's does. The port holds this
    frame on the CPU, so the witness prints every number and exits 1
    (nothing to split)."""
    import front_end_witness

    d, run, rep, _ = short_run
    record = tmp_path / "record.npz"
    E.save_record(str(record), run, d)
    rec = dict(np.load(record))
    assert SMALL_CONFIG.count("local_frame_num: 10") == 1
    rec["config"] = np.asarray(SMALL_CONFIG.replace("local_frame_num: 10", "local_frame_num: 4"))
    frame = len(d) - 2
    state = tmp_path / "state.npz"
    rows = E.replay_front_end(d, rec, frame, "cpu", frame, str(state))
    assert max(mine for _, mine, _ in rows) < E.LOST_STEP
    s = np.load(state)
    assert int(s["frame"]) == frame and len(s["kf_pose"]) >= 8
    assert s["kf_evicts"].tolist() == [j >= 4 for j in range(len(s["kf_pose"]))]
    out_json = tmp_path / "witness.json"
    assert front_end_witness.main([str(state), "--json", str(out_json)]) == 1
    out = capsys.readouterr().out
    assert "the port holds this frame" in out and "verdict: no loss" in out
    w = json.loads(out_json.read_text())
    assert w["count_diff"] == 0 and w["preprocess_same_mask"] and w["preprocess_gap"] == 0.0
    assert w["psum_gap"] <= 1e-4 and w["ppsum_gap"] <= 1e-4
    for name in ("jax_on_port", "jax_on_jax"):
        assert abs(w[name] - w["port"]) <= 5e-3, (name, w)
