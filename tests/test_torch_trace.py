"""The port's tracer (utils/watchdog.py): RunHealth's spans and counters,
on the CPU.

A `mapping --synthetic` run over a small config that solves a PCG pose
graph inside the frame loop and verifies a loop candidate: every span of
the frame loop nests under its `frame` span and carries the CLI's frame
index, but the hand-over, which carries the index of the frame it hands
over and closes before that frame's span opens; a solve's counters agree
with its stats. Then the tracer alone: a
stage whose body raises is recorded, `span` and `count` without a run do
nothing, a solve gives the same bits with and without a run, the ring stays
bounded, device-timed spans resolve from their events' `query()`, and
under torch.profiler a `pose_graph` span, put on the trace's clock by the
run's anchor, holds the solve's profiled ops. Torch is pinned to one CPU
thread while the file runs. On the card (`python -m pytest --noconftest -m
cuda tests/test_torch_trace.py`): a device-timed span resolves with no
host synchronisation, and a solve keeps its bits under a run.
"""

import threading

import numpy as np
import pytest
import torch

import lidar_slam_tpu_torch.cli as tcli
import lidar_slam_tpu_torch.models.graph_optimizer as go
from lidar_slam_tpu_torch.utils import watchdog

N_FRAMES = 7
# gates at 2.5 m (the synthetic drive's 1 m a frame leaves the 2.0 m gates on
# a knife edge, test_torch_cli.py); a PCG solve every second keyframe; a GNSS
# candidate two keyframes back, inside detect_area, verified at once
CONFIG = """\
front_end:
  ndt:
    resolution: 1.0
    grid_dims: [96, 96, 24]
    point_chunk: 2048
    max_iter: 25
  frame_capacity: 8192
  keyframe_capacity: 8192
  raw_capacity: 16384
  local_frame_num: 10
  key_frame_distance: 2.5
back_end:
  key_frame_distance: 2.5
  optimize_step_with_key_frame: 2
  optimize_step_with_loop: 1
  gnss_noise: [1.0, 1.0, 1.0]
  max_nodes: 64
  max_edges: 128
  max_priors: 64
  optimizer:
    solver: pcg
    max_iterations: 20
    pcg_iters: 30
loop_closing:
  loop_method: gps
  loop_step: 1
  diff_num: 2
  detect_area: 10.0
  extend_frame_num: 1
  fitness_score_limit: 0.35
  ndt:
    resolution: 1.0
    grid_dims: [96, 96, 24]
    point_chunk: 2048
    max_iter: 25
  submap_capacity: 16384
  scan_capacity: 8192
"""
PCG_ITERS = 30


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """One `mapping` run; (its RunHealth, the stats of each solve in order)."""
    root = tmp_path_factory.mktemp("trace")
    (root / "cfg.yaml").write_text(CONFIG)
    base, stats = go.optimize_pose_graph, []

    def solve(graph, cfg=go.GraphOptimizerConfig()):
        out = base(graph, cfg)
        stats.append(out[1])
        return out

    go.optimize_pose_graph = solve
    try:
        rc = tcli.main(["mapping", "--synthetic", str(N_FRAMES), "--config", str(root / "cfg.yaml"),
                        "--out", str(root / "out"), "--device", "cpu"])
    finally:
        go.optimize_pose_graph = base
    assert rc == 0
    run = watchdog.last_run()
    assert run is not None and watchdog.active_run() is None
    return run, stats


def _graph(n=12, device="cpu"):
    """A small PCG pose graph: a noisy chain with a loop edge and priors."""
    rng = np.random.default_rng(3)
    b = go.PoseGraphBuilder(max_nodes=n, max_edges=2 * n, max_priors=n, device=device)
    for i in range(n):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [i + rng.normal(0, 0.1), rng.normal(0, 0.1), 0.0]
        b.add_se3_node(pose, fixed=i == 0)
        if i:
            rel = np.eye(4, dtype=np.float32)
            rel[0, 3] = 1.0
            b.add_se3_edge(i - 1, i, rel, noise=[0.1] * 6)
        b.add_se3_prior_xyz_edge(i, [float(i), 0.0, 0.0], noise=[1.0] * 3)
    rel = np.eye(4, dtype=np.float32)
    rel[0, 3] = n - 1.0
    b.add_se3_edge(0, n - 1, rel, noise=[0.1] * 6)
    return b.to_graph(), go.GraphOptimizerConfig(solver="pcg", max_iterations=8, pcg_iters=PCG_ITERS)


def test_frame_loop_spans_nest_under_their_frame(mapped):
    run, _ = mapped
    spans = run.spans()
    frames = [s for s in spans if s.name == "frame"]
    assert [s.frame for s in frames] == list(range(N_FRAMES))
    names = {s.name for s in spans}
    for name in ("handover", "front_end", "front_end.track", "front_end.map_update", "front_end.keyframe",
                 "back_end", "store.save", "store.load", "loop_closing", "loop_closing.detect",
                 "loop_closing.verify", "pose_graph", "progress", "viewer"):
        assert name in names, name
    handovers = [s for s in spans if s.name == "handover"]
    # one hand-over a frame, and the last one that finds the source empty
    assert [s.frame for s in handovers] == list(range(N_FRAMES + 1))
    for h, f in zip(handovers, frames):
        assert h.parent is None and h.end <= f.start
    inside = [s for s in spans if s.frame is not None and s.name not in ("frame", "handover")]
    assert inside
    for s in inside:
        top = s
        while top.parent is not None:
            assert top.parent.start <= top.start and top.end <= top.parent.end, (s.name, top.name)
            top = top.parent
        assert top.name == "frame" and top.frame == s.frame, (s.name, s.frame, top.name, top.frame)
    assert all(s.thread == threading.get_ident() for s in inside)
    summary = run.summary()
    assert summary["spans"]["frame"]["calls"] == N_FRAMES == summary["frames"]
    assert summary["stages"]["front_end"]["calls"] == N_FRAMES


def test_solve_counters_match_its_stats(mapped):
    run, stats = mapped
    solves = [s for s in run.spans() if s.name == "pose_graph"]
    assert len(solves) == len(stats) >= 2
    assert any(s.frame is not None for s in solves)
    for sp, st in zip(solves, stats):
        c = sp.counts
        assert c["lm_iterations"] == st["iterations"] > 0
        assert c["pcg_steps"] == st["iterations"] * PCG_ITERS
        assert 0 < c["pcg_active_steps"] <= c["pcg_steps"]
        assert "pcg_active_steps" not in st
    totals = run.counters
    assert totals["lm_iterations"] == sum(st["iterations"] for st in stats)
    assert totals["pcg_active_steps"] == sum(s.counts["pcg_active_steps"] for s in solves)


def test_raising_stage_is_recorded():
    warns = []
    rh = watchdog.RunHealth(stage_budget_ms=0.0, log=warns.append)
    with pytest.raises(ValueError):
        with rh.stage("track"):
            raise ValueError("lost")
    assert rh.stages["track"].calls == 1 and rh.stages["track"].misses == 1 and len(warns) == 1
    (sp,) = rh.spans()
    assert sp.name == "track" and sp.end >= sp.start
    assert rh.summary()["spans"]["track"]["calls"] == 1


def test_span_and_count_without_a_run_do_nothing():
    assert watchdog.active_run() is None
    last = watchdog.last_run()
    with watchdog.span("nothing") as sp:
        watchdog.count("nothing", 3)
    assert sp is None and watchdog.last_run() is last
    if last is not None:
        assert "nothing" not in last.counters and "nothing" not in last.span_totals
    rh = watchdog.RunHealth()
    with rh.active():
        with watchdog.span("outer"):
            watchdog.count("things", 2)
            with watchdog.span("inner", frame=4):
                watchdog.count("things")
    watchdog.count("things", 5)  # the run has ended
    outer, inner = sorted(rh.spans(), key=lambda s: s.start)
    assert outer.counts == {"things": 2} and inner.counts == {"things": 1} and inner.parent is outer
    assert inner.frame == 4 and outer.frame is None
    assert rh.counters == {"things": 3} and watchdog.last_run() is rh and watchdog.active_run() is None


def test_solve_bits_with_and_without_a_run():
    graph, cfg = _graph()
    plain, st0 = go.optimize_pose_graph(graph, cfg)
    rh = watchdog.RunHealth()
    with rh.active():
        traced, st1 = go.optimize_pose_graph(graph, cfg)
    assert torch.equal(plain.poses, traced.poses)
    assert st0 == st1
    (sp,) = rh.spans()
    assert sp.counts["lm_iterations"] == st0["iterations"]
    assert 0 < sp.counts["pcg_active_steps"] <= sp.counts["pcg_steps"] == st0["iterations"] * PCG_ITERS


def test_ring_stays_bounded(monkeypatch):
    monkeypatch.setattr(watchdog, "RING_SPANS", 8)
    rh = watchdog.RunHealth()
    with rh.active():
        for i in range(50):
            with watchdog.span("frame", frame=i):
                with watchdog.span("work"):
                    pass
    spans = rh.spans()
    assert len(spans) == 8 and spans[-1].name == "frame" and spans[-1].frame == 49
    assert rh.span_totals["frame"].calls == rh.span_totals["work"].calls == 50


class _Event:
    """A stand-in for a CUDA event: it has run once `done` is set."""

    def __init__(self, t_ms):
        self.t_ms, self.done, self.waited = t_ms, False, False

    def record(self, stream=None):
        pass

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True

    def elapsed_time(self, end):
        assert self.done or end.done
        return end.t_ms - self.t_ms


def test_device_timed_spans_resolve_from_their_events():
    rh = watchdog.RunHealth()
    rh.begin()
    ev = [(_Event(0.0), _Event(2.5)), (_Event(10.0), _Event(11.0))]
    for i, (a, b) in enumerate(ev):
        with rh.span("frame", frame=i):
            with watchdog.Span(rh, "map_update", None, (a, b, None)):
                pass
    spans = [s for s in rh.spans() if s.name == "map_update"]
    assert [s.device_ns for s in spans] == [None, None]  # nothing has run: no wait
    ev[0][0].done = ev[0][1].done = True
    with rh.span("frame", frame=2):  # a top-level span closes: the pairs that ran resolve
        pass
    assert [s.device_ns for s in spans] == [2500000, None] and not ev[0][1].waited
    rh.end()  # the run's end waits for the rest
    assert spans[1].device_ns == 1000000 and ev[1][1].waited
    assert rh.summary()["spans"]["map_update"]["device_mean_ms"] == 1.75


def test_pose_graph_span_holds_its_profiled_ops():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    graph, cfg = _graph()
    go.optimize_pose_graph(graph, cfg)  # warm-up
    rh = watchdog.RunHealth()
    with rh.active(), profile(activities=[ProfilerActivity.CPU]) as prof:
        go.optimize_pose_graph(graph, cfg)
    (sp,) = rh.spans()
    a, b = rh.epoch_ns(sp.start), rh.epoch_ns(sp.end)
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU and e.name().startswith("aten::")]
    assert len(ops) > 100
    slack = 1_000_000  # 1 ms
    first = min(e.start_ns() for e in ops)
    last = max(e.start_ns() + e.duration_ns() for e in ops)
    assert a - slack <= first and last <= b + slack, (first - a, b - last)
    assert first - a < 0.5 * (b - a) and b - last < 0.5 * (b - a)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA events and the PCG's count on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_timed_span_and_solve_on_the_card(card):
    x = torch.randn(1024, 1024, device=card)
    rh = watchdog.RunHealth()
    with rh.active():
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(3):
                with rh.span("frame", frame=i):
                    with watchdog.span("work", device=card):
                        for _ in range(20):
                            x = torch.tanh(x @ x)
                        watchdog.count("matmuls", 20)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    work = [s for s in rh.spans() if s.name == "work"]
    assert len(work) == 3 and all(s.device_ns > 0 and s.counts == {"matmuls": 20} for s in work)
    graph, cfg = _graph(device=card)
    plain, st0 = go.optimize_pose_graph(graph, cfg)
    rh = watchdog.RunHealth()
    with rh.active():
        traced, st1 = go.optimize_pose_graph(graph, cfg)
    assert torch.equal(plain.poses, traced.poses) and st0 == st1
    (sp,) = rh.spans()
    assert 0 < sp.counts["pcg_active_steps"] <= sp.counts["pcg_steps"] == st0["iterations"] * PCG_ITERS
