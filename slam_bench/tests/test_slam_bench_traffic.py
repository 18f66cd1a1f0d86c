"""The traffic: one mix gives one drive, every time; the steady laps join
as the drive itself would go on; and the window's laps follow from the
run's length alone."""

import numpy as np
import torch

from slam_bench.tests import small
from slam_bench.traffic.generator import hashed, make_drive, route, uniform, window_laps


def sweep():
    return {**small.config()["sweep"], "rows": 2048}


def test_one_mix_one_drive():
    a = make_drive(small.mix(), sweep(), "cpu", 10.0)
    b = make_drive(small.mix(), sweep(), "cpu", 10.0)
    other = small.mix()
    other["recording_seed"] += 1
    c = make_drive(other, sweep(), "cpu", 10.0)
    assert len(a.points) == len(b.points) == len(c.points)
    assert all(np.array_equal(x, y) for x, y in zip(a.points, b.points))
    assert np.array_equal(a.gnss, b.gnss) and np.array_equal(a.truth, c.truth)
    assert not np.array_equal(a.points[5], c.points[5]) and not np.array_equal(a.gnss, c.gnss)
    assert all(0 < len(p) <= 2048 for p in a.points)


def test_hashed_numbers():
    """splitmix64's published first outputs from seed 0, and uniforms that
    look uniform and Gaussians of unit spread from them."""
    got = hashed(torch.tensor([0, -7046029254386353131], dtype=torch.int64))
    assert got.tolist()[0] == 0xE220A8397B1DCDAF - 2**64
    u = uniform(torch.arange(200000, dtype=torch.int64))
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0 and abs(float(u.mean()) - 0.5) < 0.003


def test_the_laps_join():
    mix = small.mix()
    r = route(mix["route"])
    assert r.join_m < 1e-6
    P = r.poses
    steps = np.linalg.norm(np.diff(P[:, :3, 3], axis=0), axis=1)
    join = np.linalg.norm(P[r.lap1, :3, 3] - P[-1, :3, 3])
    # the step from a steady lap's last frame to the next lap's first is the drive's own step there
    assert abs(join - steps[r.lap1 - 1]) < 0.04
    mix["route"]["nominal_frames_per_s"] = 2 * r.steady / 10.0
    d = make_drive(mix, sweep(), "cpu", 10.0, trace=True)
    assert d.setup == r.lap1 + (mix["route"]["setup_laps"] - 1) * r.steady
    assert d.laps == 2 and d.window == 2 * r.steady
    assert d.n == d.setup + (2 + mix["route"]["trace_laps"]) * r.steady
    a, b = d.frame(d.setup + 3), d.frame(d.setup + r.steady + 3)
    # each steady lap has sweeps of its own, on the same route
    assert not np.array_equal(a["points"], b["points"]) and b["time"] > a["time"]
    assert np.allclose(d.truth[d.setup + 3], d.truth[d.setup + r.steady + 3])
    assert make_drive(mix, sweep(), "cpu", 10.0).n == d.setup + d.window


def test_window_laps_follow_the_length_alone():
    rt = {"nominal_frames_per_s": 13.5}
    assert [window_laps(rt, s, 346) for s in (1, 10, 30, 51)] == [1, 1, 1, 2]
    assert window_laps({"nominal_frames_per_s": 40.0}, 51, 346) == 6


def test_the_full_route():
    """The cell's own mix: lap 1 is 355 frames from rest, the steady lap 346."""
    import json
    import os

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "traffic", "shuttle.json")) as f:
        r = route(json.load(f)["route"])
    assert (r.lap1, r.steady) == (355, 346) and r.join_m < 1e-6
