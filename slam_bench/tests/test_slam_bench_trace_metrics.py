"""The readers of the program's own spans and counters (map_update_ms,
store_io_ms, loop_verify_ms, lm_iteration_ms, pcg_active_share,
pose_graph_idle_share): their arithmetic on views with known spans,
counters and device operations, including where they have nothing to read;
then, on the small CPU cell, that the program's `front_end` spans are the
harness's frame for frame and its `pose_graph` spans the harness's solve
spans to within 1 ms each."""

import contextlib
import importlib
from types import SimpleNamespace

import pytest
import torch

from slam_bench import harness
from slam_bench.tests import small

MS = 1_000_000
SEED = 2**32 + 7
SECONDS = 16.0
NAMES = ("map_update_ms", "store_io_ms", "loop_verify_ms", "lm_iteration_ms", "pcg_active_share",
         "pose_graph_idle_share")


def reader(name):
    return importlib.import_module(f"slam_bench.metrics.{name}").read


class FakeRun:
    """What the readers use of a program's run: its spans and its anchor
    (perf_counter ns 0 is epoch ns `offset`)."""

    def __init__(self, spans, offset=0):
        self._spans, self.offset = spans, offset

    def spans(self):
        return list(self._spans)

    def epoch_ns(self, t):
        return t + self.offset


def span(name, frame, start_ms, end_ms, counts=None, device_ms=None):
    return SimpleNamespace(name=name, frame=frame, start=int(start_ms * MS), end=int(end_ms * MS), counts=counts,
                           device_ns=None if device_ms is None else int(device_ms * MS))


def view(frames, events=None, end_window_frame=None):
    """A view whose window frames are `frames` [(frame, start ms, end ms)]
    of the harness's `front_end` spans."""
    fr = [(f, a * 1e-3, b * 1e-3) for f, a, b in frames]
    rec = SimpleNamespace(end_window_frame=end_window_frame if end_window_frame is not None else frames[-1][0] + 1)
    return harness.View(rec=rec, frames=fr, ids={f for f, _, _ in fr}, w0=fr[0][1], w1=fr[-1][2], events=events)


def front_ends(frames):
    """The program's `front_end` spans, each 0.1 ms inside the harness's."""
    return [span("front_end", f, a + 0.1, b - 0.1) for f, a, b in frames]


@contextlib.contextmanager
def program(run):
    mods = [importlib.import_module(f"slam_bench.metrics.{m}") for m in ("map_update_ms", "pose_graph_idle_share")]
    base = [m.program_run for m in mods]
    for m in mods:
        m.program_run = lambda: run
    try:
        yield
    finally:
        for m, b in zip(mods, base):
            m.program_run = b


FRAMES = [(10, 0.0, 40.0), (11, 100.0, 130.0)]


def test_span_readers_arithmetic():
    spans = front_ends(FRAMES) + [
        span("front_end.map_update", 10, 20.0, 25.0, device_ms=2.0),  # the card's 2 ms, not the host's 5
        span("front_end.map_update", 11, 110.0, 113.0),  # no device time: the host's 3 ms
        span("front_end.map_update", 12, 210.0, 290.0),  # outside the window
        span("store.save", 10, 30.0, 34.0), span("store.load", 10, 35.0, 36.5), span("store.load", 11, 140.0, 141.5),
        span("loop_closing.verify", 10, 50.0, 70.0), span("loop_closing.verify", 11, 150.0, 160.0),
        span("loop_closing.verify", 9, 0.0, 500.0),
        span("pose_graph", 10, 60.0, 160.0, {"lm_iterations": 4, "pcg_steps": 400, "pcg_active_steps": 100}),
        span("pose_graph", 11, 200.0, 500.0, {"lm_iterations": 6, "pcg_steps": 600, "pcg_active_steps": 50}),
        span("pose_graph", None, 900.0, 5000.0, {"lm_iterations": 100, "pcg_steps": 10000}),  # after the loop
    ]
    v = view(FRAMES)
    with program(FakeRun(spans)):
        assert reader("map_update_ms")(v) == pytest.approx((2.0 + 3.0) / 2)
        assert reader("store_io_ms")(v) == pytest.approx((4.0 + 1.5 + 1.5) / 2)
        assert reader("loop_verify_ms")(v) == pytest.approx((20.0 + 10.0) / 2)
        assert reader("lm_iteration_ms")(v) == pytest.approx((100.0 + 300.0) / 10)
        assert reader("pcg_active_share")(v) == pytest.approx(100.0 * 150 / 1000)


def test_span_readers_read_nothing_where_there_is_nothing():
    v = view(FRAMES)
    with program(None):  # a program that keeps no spans
        assert all(reader(n)(v) is None for n in NAMES)
    dense = front_ends(FRAMES) + [span("pose_graph", 10, 60.0, 70.0, {"lm_iterations": 3})]
    with program(FakeRun(dense)):
        assert reader("lm_iteration_ms")(v) == pytest.approx(10.0 / 3)
        for n in ("map_update_ms", "store_io_ms", "loop_verify_ms", "pcg_active_share"):
            assert reader(n)(v) is None, n
        assert reader("pose_graph_idle_share")(view(FRAMES, events=[("k", 0, 1)])) is None  # no solve in the tail
    # the program's frame 11 is not the harness's frame 11: nothing is read
    shifted = front_ends(FRAMES[:1]) + [span("front_end", 11, 300.0, 310.0),
                                        span("loop_closing.verify", 11, 150.0, 160.0)]
    with program(FakeRun(shifted)):
        assert reader("loop_verify_ms")(v) is None


def test_pose_graph_idle_share_arithmetic():
    offset = 10_000 * MS
    on_trace = lambda ms: offset + int(ms * MS)  # noqa: E731
    tail = [span("pose_graph", 12, 1000.0, 1100.0), span("pose_graph", 13, 2000.0, 2100.0),
            span("pose_graph", 11, 0.0, 100.0)]  # frame 11 is in the window, not the traced tail
    events = sorted([("a", on_trace(990.0), on_trace(1010.0)), ("b", on_trace(1005.0), on_trace(1030.0)),
                     ("c", on_trace(1090.0), on_trace(1200.0)), ("d", on_trace(2040.0), on_trace(2050.0)),
                     ("e", on_trace(50.0), on_trace(60.0))], key=lambda e: e[1])
    v = view(FRAMES, events=events, end_window_frame=12)
    with program(FakeRun(tail, offset)):
        # busy inside the solves: 1000-1030 and 1090-1100 (40 ms), 2040-2050 (10 ms) of 200 ms
        assert reader("pose_graph_idle_share")(v) == pytest.approx(100.0 * (1 - 50.0 / 200.0))
        assert reader("pose_graph_idle_share")(view(FRAMES, events=None, end_window_frame=12)) is None


def test_program_spans_are_the_harness_spans_on_the_small_cell():
    from slam_bench.entries import mapping_cli

    from lidar_slam_tpu_torch.utils import watchdog

    n = torch.get_num_threads()
    torch.set_num_threads(4)
    rec = {}
    base = mapping_cli.run

    def keep(*a, **k):
        rec["rec"] = base(*a, **k)
        return rec["rec"]

    mapping_cli.run = keep
    try:
        res = harness.run_cell("ndt_mapping.shuttle", SEED, SECONDS, False, "cpu", config=small.config(),
                               mix=small.mix())[0]
    finally:
        mapping_cli.run = base
        torch.set_num_threads(n)
    assert res["correct"], res["checks"]
    r, run = rec["rec"], watchdog.last_run()
    spans = run.spans()

    ours = {s.frame: s for s in spans if s.name == "front_end"}
    theirs = {f: (a, b) for name, a, b, f in r.spans if name == "front_end"}
    assert set(ours) == set(theirs) and len(ours) == len(r.poses)
    for f, (a, b) in theirs.items():  # one stage: the program's span lies inside the harness's
        s = ours[f]
        assert a * 1e9 - 1e3 <= s.start and s.end <= b * 1e9 + 1e3, f

    solves = [s for s in spans if s.name == "pose_graph"]
    assert len(solves) == len(r.solves) >= 4
    for s, h in zip(solves, r.solves):
        assert s.frame == h["frame"]
        assert abs(h["start"] * 1e9 - s.start) < MS and abs(h["end"] * 1e9 - s.end) < MS
        assert s.counts["lm_iterations"] == h["iterations"]

    frames = mapping_cli.window_frames(r)
    v = harness.View(rec=r, frames=frames, ids={f for f, _, _ in frames}, w0=r.window0, w1=r.window1)
    values = {n: reader(n)(v) for n in NAMES}
    for n in ("map_update_ms", "store_io_ms", "loop_verify_ms", "lm_iteration_ms"):
        assert values[n] is not None and values[n] > 0, (n, values)
    # the small cell's graph (256 nodes) is solved dense, and an untraced run has no device operations
    assert values["pcg_active_share"] is None and values["pose_graph_idle_share"] is None, values
