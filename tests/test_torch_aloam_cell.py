"""`correct` on a small A-LOAM cell on the CPU: the benchmark's cell
`aloam_mapping.short_shuttle` (configuration kitti_hdl64_aloam, the entry
mapping_cli_aloam, the judge reference/aloam_mapping.py) at 16 rings x
256 bins over a short shuttle of the small corridor. A sound run is
correct; the reference's stand-ins put in the program's place over the
same frames are not: the control (its scan-to-map solve in bfloat16),
every pose left at the constant-velocity guess, every 11th pose 5 cm off.
The small cell's limits are its own, set from its own readings on the CPU
(one recording; PERF.md section 2), as slam_bench/tests/small.py's are.
"""

import copy
import json
import os

import pytest
import torch

from slam_bench import harness
from slam_bench.tests import small

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**32 + 7
RINGS, BINS = 16, 256


def config() -> dict:
    with open(os.path.join(ROOT, "slam_bench", "configs", "kitti_hdl64_aloam.json")) as f:
        c = json.load(f)
    c["sweep"].update(elevations_deg=[-15.0 + 2.0 * k for k in range(RINGS)], azimuth_bins=BINS, rows=RINGS * BINS,
                      max_range_m=40.0)
    c["cli_config"]["aloam"]["features"].update(n_scans=RINGS, capacity=RINGS * BINS, max_sharp=256,
                                                max_less_sharp=2048, max_flat=512, max_less_flat=RINGS * BINS)
    c["cli_config"]["aloam"]["mapping"].update(stack_corner_capacity=2048, stack_surf_capacity=4096,
                                               corner_map_capacity=32768, surf_map_capacity=32768)
    n = small.config()
    c["cli_config"]["back_end"] = dict(n["cli_config"]["back_end"], optimize_step_with_loop=4)
    c["cli_config"]["loop_closing"] = dict(n["cli_config"]["loop_closing"], diff_num=6)
    c["judge"].update(loop_submap_capacity=16384, loop_scan_capacity=8192, loop_grid=[96, 96, 24])
    c["limits"].update(LIMITS)
    c["floors"] = {"loops_per_lap": 1, "solves_judged": 1}
    return c


def mix() -> dict:
    """The small shuttle (slam_bench/tests/small.py) on the first 30 m of
    its corridor, with its first truck, at density 400, with 3 m legs and a
    quick start: lap 1 is 46 sweeps, the window's lap 44."""
    m = copy.deepcopy(small.mix())
    m["world"].update(length_m=30.0, density=400.0, trucks=m["world"]["trucks"][:1])
    m["route"].update(leg_m=3.0, cruise_m_per_frame=0.6, accel_m_per_frame2=0.1)
    return m


# the small cell's own limits, between its own readings on the CPU (one recording; PERF.md section 2):
# aloam_gap_p90 0.0092 sound, 0.0209 with every 11th pose 5 cm off, 0.0405 with the control in the program's
# place; aloam_over_share 0.068 sound, 0.159 with every 11th pose off; loop_gap_p90 0.0016 sound, 0.0314 control
LIMITS = {"aloam_gap_p90": 0.015, "aloam_over_share": 0.11, "loop_gap_p90": 0.015}


def test_sound_run_is_correct_and_each_stand_in_is_not():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        res = harness.run_cell("aloam_mapping.short_shuttle", SEED, 16.0, False, "cpu", config=config(), mix=mix(),
                               variants=("control", "unchanged", "sparse"))[0]
    finally:
        torch.set_num_threads(n)
    assert res["correct"], res["checks"]
    assert res["variants"]["program"]["correct"]
    for v in ("control", "unchanged", "sparse"):
        assert not res["variants"][v]["correct"], (v, res["variants"][v])


def test_a_program_without_the_section_stops_at_once(monkeypatch):
    """The cell's entry on a program whose configuration has no `aloam`
    section (the commit before it) stops before any frame, with a message,
    and never falls back to the NDT front end."""
    import dataclasses

    from slam_bench.entries import mapping_cli_aloam

    from lidar_slam_tpu_torch import config as program_config

    monkeypatch.setattr(program_config, "SlamConfig", dataclasses.make_dataclass("SlamConfig", [("data_dir", str)]))
    with pytest.raises(SystemExit, match="no `aloam` section"):
        mapping_cli_aloam.run(config(), None, False, "cpu", "unused")


def test_part_card_time_is_the_device_busy_while_each_part_ran(monkeypatch):
    """aloam_features_ms, aloam_odometry_ms and aloam_mapping_ms read the
    trace's device operations from a part's start to the next part's (the
    fold's to its step's end), over the traced tail's steps: an operation
    queued by one part and run while the host issues the next counts for
    the next, one after the fold but before the pose's copy for the
    mapping, none outside the steps or in the window's frames; the three
    add up to the device's busy time over the steps."""
    from types import SimpleNamespace as NS

    from slam_bench.metrics import aloam_features_ms, aloam_mapping_ms, aloam_odometry_ms

    offset = 1000

    def step(frame, t0):
        # features [t0, t0+10), odometry [t0+12, t0+20), mapping [t0+21, t0+30), fold [t0+31, t0+35), step to t0+50
        parts = zip(("aloam.features", "aloam.odometry", "aloam.mapping", "aloam.fold"),
                    ((0, 10), (12, 20), (21, 30), (31, 35)))
        return [NS(name="aloam.step", frame=frame, start=t0 - 2, end=t0 + 50)] + [
            NS(name=n, frame=frame, start=t0 + a, end=t0 + b) for n, (a, b) in parts]

    spans = step(9, 0) + step(10, 100) + step(11, 200)
    run = NS(spans=lambda: spans, epoch_ns=lambda t: t + offset)
    monkeypatch.setattr(aloam_features_ms, "program_run", lambda: run)
    ev = lambda a, b: ("k", offset + a, offset + b)  # noqa: E731
    events = [ev(2, 8),  # frame 9: the window, not read
              ev(102, 106), ev(108, 115),  # frame 10: features 4 + 4, odometry 3 (queued by features)
              ev(125, 128), ev(140, 145),  # frame 10: mapping 3, the fold 5 (run before the pose's copy)
              ev(170, 180),  # between the steps: not read
              ev(201, 203), ev(212, 222), ev(221, 224)]  # frame 11: features 2, odometry 9, mapping 3 (overlapping)
    view = NS(events=events, rec=NS(end_window_frame=10))
    got = [m.read(view) for m in (aloam_features_ms, aloam_odometry_ms, aloam_mapping_ms)]
    assert got == [pytest.approx(v * 1e-6 / 2) for v in (4 + 4 + 2, 3 + 9, 3 + 5 + 3)]
    assert sum(got) == pytest.approx((4 + 7 + 3 + 5 + 2 + 12) * 1e-6 / 2)  # the union over the two steps
    assert aloam_features_ms.read(NS(events=[], rec=NS(end_window_frame=10))) is None
    monkeypatch.setattr(aloam_features_ms, "program_run", lambda: None)
    assert aloam_mapping_ms.read(view) is None
