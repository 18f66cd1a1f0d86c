"""The end-to-end arithmetic: a rate over all of the window's frames and
their wall, and a tail over all of them, both moved by a stall; and the
host spans of the per-layer readers summed over the window's frames."""

import numpy as np

from slam_bench import harness
from slam_bench.entries.mapping_cli import Record, window_frames
from slam_bench.metrics import back_end_ms, front_end_ms, loop_other_ms, pose_graph_ms, pose_ms_p95


def record(stall_at=None, stall_s=2.0, n=400, setup=50, window=300, period=0.1, busy=0.02):
    """Frames every `period` s whose front end takes `busy` s; frame
    `stall_at` takes `stall_s` more."""
    rec = Record(first_window_frame=setup, end_window_frame=setup + window)
    t = 0.0
    for i in range(n):
        if i == setup:
            rec.window0 = t
        if i == setup + window:
            rec.window1 = t
        dur = busy + (stall_s if i == stall_at else 0.0)
        rec.spans.append(("front_end", t, t + dur, i))
        rec.spans.append(("back_end", t + dur, t + dur + 0.01, i))
        t += period + (stall_s if i == stall_at else 0.0)
    return rec


def metrics(rec):
    frames = window_frames(rec)
    view = harness.View(rec=rec, frames=frames, ids={f for f, _, _ in frames}, w0=rec.window0, w1=rec.window1)
    return {**harness.end_to_end(frames, rec.window1 - rec.window0, 12.5), "pose_ms_p95": pose_ms_p95.read(view)}, frames


def test_rate_and_tail_over_the_whole_window():
    m, frames = metrics(record())
    assert [f for f, _, _ in frames] == list(range(50, 350))
    assert abs(m["frames_per_s"] - 10.0) < 1e-9 and m["setup_s"] == 12.5 and len(m) == 3
    assert abs(m["pose_ms_p95"] - 20.0) < 1e-9


def test_a_stall_moves_both():
    base, _ = metrics(record())
    stalled, _ = metrics(record(stall_at=100, stall_s=2.0))
    # the window's 300 frames now take 32 s
    assert abs(stalled["frames_per_s"] - 300 / 32.0) < 1e-9
    # outside the window a stall moves neither
    outside = metrics(record(stall_at=10, stall_s=2.0))[0]
    assert all(abs(outside[k] - base[k]) < 1e-9 for k in base)
    # one slow frame in 300 does not reach the 95th percentile; twenty do
    many = record()
    for k in range(0, 600, 30):
        name, a, b, i = many.spans[k + 100]
        many.spans[k + 100] = (name, a, b + 0.05, i)
    assert metrics(many)[0]["pose_ms_p95"] > base["pose_ms_p95"] + 20.0
    assert np.isfinite(stalled["pose_ms_p95"])


def test_layer_spans_over_the_window_frames():
    rec = record()
    rec.solves = [{"start": 20.0, "end": 21.0, "frame": 150, "by": "back_end"},
                  {"start": 22.0, "end": 22.5, "frame": 160, "by": "loop"},
                  {"start": 1.0, "end": 4.0, "frame": 10, "by": "loop"}]
    frames = window_frames(rec)
    view = harness.View(rec=rec, frames=frames, ids={f for f, _, _ in frames}, w0=rec.window0, w1=rec.window1)
    assert abs(front_end_ms.read(view) - 20.0) < 1e-9
    assert abs(pose_graph_ms.read(view) - 1500.0 / 300) < 1e-9
    assert abs(back_end_ms.read(view) - (10.0 - 1000.0 / 300)) < 1e-9
    assert abs(loop_other_ms.read(view) - (100.0 - 20.0 - 10.0 - 500.0 / 300)) < 1e-9


def test_decide_needs_every_number():
    config = {"limits": {"gap": 0.1}, "floors": {"loops": 5}}
    assert harness.decide({"gap": 0.05, "loops": 5}, config)[0]
    assert not harness.decide({"gap": 0.05}, config)[0]
    assert not harness.decide({"gap": 0.2, "loops": 9}, config)[0]
    assert not harness.decide({"gap": float("nan"), "loops": 9}, config)[0]
    ok, checks = harness.decide({"gap": 0.05, "loops": 4}, config)
    assert not ok and checks["loops"] == {"value": 4.0, "limit": 5, "must_be": "at_least"}
