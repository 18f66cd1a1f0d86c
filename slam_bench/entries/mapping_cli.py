"""The `mapping` command, as a user runs it over a logged drive.

`lidar_slam_tpu_torch.cli.main(["mapping", ...])` runs in this process with
its frame source (`cli._frame_source`, the sensor reader) replaced by the
drive, and its run health (`utils.watchdog.RunHealth`) by a subclass that
records each stage's span. The back end (`pipeline.BackEnd`) is a subclass
that records each keyframe, loop edge and solve as the program gives them
out, and every pose-graph solve (`graph_optimizer.optimize_pose_graph`,
looked up at call time) is wrapped in a span of its own. Everything else is
the program's: the prefetch thread and its upload, the keyframe store, the
viewer, the live trajectory.

Set-up is the drive's set-up laps (the loop detector needs history). The
window is the drive's window frames, the same in every run: it opens when
the first of them enters its `front_end` stage and closes when the frame
after the last enters its own, or the frame loop ends. A traced run drives
the drive's tail after the window under the profiler, so that the window's
host spans are the untraced program's. The drive then ends; the final
pose-graph solve and the map save that follow a user's run serve nothing
that is measured or judged, and are skipped.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Record:
    """What a run of the mapping CLI gave out, on the harness's clock
    (time.perf_counter seconds)."""

    first_window_frame: int = 0
    end_window_frame: int = 0  # the first frame after the window
    window0: float = None  # the window's first frame enters front_end
    window1: float = None  # the frame after the window enters front_end, or the frame loop ends
    spans: list = field(default_factory=list)  # (stage, start, end, frame)
    solves: list = field(default_factory=list)  # dict a solve: start, end, frame, by, nodes, loops, poses
    poses: list = field(default_factory=list)  # the front end's pose of each frame, [4, 4] float32
    keyframes: list = field(default_factory=list)  # (frame, the back end's keyframe pose [4, 4])
    loops: list = field(default_factory=list)  # dict a loop edge: frame, index0, index1, relative, fitness
    odom_to_map: np.ndarray = None
    rc: int = None
    end_s: float = None  # from the frame loop's end to the CLI's return
    store_bytes: int = 0
    launches: dict = field(default_factory=dict)  # kernel launches in the window, by kernel
    newton_calls: list = field(default_factory=list)  # ndt_newton's inputs and result, traced tail
    trace: object = None  # the profiler's result over the traced tail
    trace_window: tuple = None  # (host start, host end) of the traced tail, perf_counter s
    clock_offset_ns: int = 0  # time.time_ns() - perf_counter_ns() when the trace opened
    memory_peak_bytes: int = 0  # at the window's close


def _tree_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(root) for f in files)


def _yaml(section: dict, indent: int = 0) -> str:
    """A nested dict of scalars and lists as the program's config YAML."""
    out = []
    for k, v in section.items():
        pad = " " * indent
        if isinstance(v, dict):
            out.append(f"{pad}{k}:\n{_yaml(v, indent + 2)}")
        elif isinstance(v, list):
            out.append(f"{pad}{k}: [{', '.join(str(x) for x in v)}]\n")
        elif isinstance(v, bool):
            out.append(f"{pad}{k}: {'true' if v else 'false'}\n")
        else:
            out.append(f"{pad}{k}: {v}\n")
    return "".join(out)


def run(config: dict, drive, trace: bool, device: str, out_dir: str) -> Record:
    """One run of the mapping CLI over `drive` on `device`: the set-up laps,
    the window's laps and, when `trace`, the traced tail."""
    import torch

    import lidar_slam_tpu_torch.models.graph_optimizer as graph_optimizer
    import lidar_slam_tpu_torch.ops.cuda.ndt_newton as ndt_newton
    import lidar_slam_tpu_torch.pipeline as pipeline
    import lidar_slam_tpu_torch.utils.watchdog as watchdog
    from lidar_slam_tpu_torch import cli
    from lidar_slam_tpu_torch.ops.cuda import knn_fused, ndt_fused, ndt_gather

    rec = Record(first_window_frame=drive.setup, end_window_frame=drive.setup + drive.window)
    on_card = torch.device(device).type == "cuda"
    kernels = {"ndt_newton": ndt_newton, "ndt_reduce_fused": ndt_fused, "window_knn": knn_fused,
               "gather_stats_onehot": ndt_gather}
    st = {"frame": -1, "by": "back_end", "prof": None, "launch0": None, "t_end": None}

    def open_window(now):
        rec.window0 = now
        st["launch0"] = {k: m.launches for k, m in kernels.items()}

    def close_window(now):
        if rec.window0 is None or rec.window1 is not None:
            return
        rec.window1 = now
        rec.launches = {k: m.launches - st["launch0"][k] for k, m in kernels.items()}
        if on_card:
            rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    def open_trace():
        from torch.profiler import ProfilerActivity, profile

        st["prof"] = profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU])
        st["prof"].__enter__()
        rec.clock_offset_ns = time.time_ns() - time.perf_counter_ns()
        rec.trace_window = (time.perf_counter(), None)
        ndt_newton.ndt_newton = traced_newton

    def close_trace():
        if st["prof"] is None:
            return
        if on_card:
            torch.cuda.synchronize()
        # the traced window ends before the profiler stops: its teardown runs no device work
        rec.trace_window = (rec.trace_window[0], time.perf_counter())
        st["prof"].__exit__(None, None, None)
        rec.trace = st["prof"].profiler.kineto_results
        st["prof"] = None
        ndt_newton.ndt_newton = base_newton

    base_newton = ndt_newton.ndt_newton

    def traced_newton(points, mask, weights, index, packed, origin, pose0, **kw):
        out = base_newton(points, mask, weights, index, packed, origin, pose0, **kw)
        rec.newton_calls.append(dict(points=points, mask=mask, weights=weights, index=index, packed=packed,
                                     origin=origin, out=out, **kw))
        return out

    base_health, base_source, base_be, base_lc, base_viewer = (watchdog.RunHealth, cli._frame_source,
                                                               pipeline.BackEnd, pipeline.LoopClosing,
                                                               pipeline.Viewer)
    base_solve = graph_optimizer.optimize_pose_graph

    class Health(base_health):
        @contextlib.contextmanager
        def stage(self, name, budget_ms=None):
            now = time.perf_counter()
            if name == "front_end":
                st["frame"] += 1
                if st["frame"] == rec.first_window_frame:
                    open_window(now)
                elif st["frame"] == rec.end_window_frame:
                    close_window(now)
                    if trace:
                        open_trace()
                        now = time.perf_counter()
            with super().stage(name, budget_ms):
                yield
            rec.spans.append((name, now, time.perf_counter(), st["frame"]))

        def frame(self, pose):
            rec.poses.append(np.asarray(pose, np.float32).copy())
            return super().frame(pose)

    class BackEnd(base_be):
        def update(self, *a, **k):
            new = super().update(*a, **k)
            if new:
                rec.keyframes.append((st["frame"], self.key_frames[-1].pose.copy()))
            if rec.odom_to_map is None and self._odom_to_map is not None:
                rec.odom_to_map = self._odom_to_map.copy()
            return new

        def insert_loop_pose(self, index0, index1, relative_pose):
            rec.loops.append({"frame": st["frame"], "index0": int(index0), "index1": int(index1),
                              "relative": np.asarray(relative_pose, np.float32).copy(), "fitness": st["fitness"]})
            st["by"] = "loop"
            try:
                super().insert_loop_pose(index0, index1, relative_pose)
            finally:
                st["by"] = "back_end"

        def force_optimize(self):
            # the frame loop has ended: the window and the trace close here, and the final solve is skipped
            now = time.perf_counter()
            close_window(now)
            close_trace()
            st["t_end"] = now
            return {}

        def _optimize(self):
            out = super()._optimize()
            rec.solves[-1].update(by=st["by"], nodes=self.graph.n_nodes, loops=len(rec.loops),
                                  poses=np.asarray(self.optimized_poses, np.float32).copy(),
                                  iterations=int(out.get("iterations", -1)))
            return out

    class LoopClosing(base_lc):
        def update(self, *a, **k):
            loop = super().update(*a, **k)
            st["fitness"] = None if loop is None else float(loop.fitness)
            return loop

    class Viewer(base_viewer):
        def save_map(self):
            return {"map_save": "skipped"}

    def solve(graph, cfg=graph_optimizer.GraphOptimizerConfig()):
        t0 = time.perf_counter()
        out = base_solve(graph, cfg)
        rec.solves.append({"start": t0, "end": time.perf_counter(), "frame": st["frame"]})
        return out

    def source(args):
        for i in range(drive.n):
            yield drive.frame(i)

    cfg_path = os.path.join(out_dir, "config.yaml")
    with open(cfg_path, "w") as f:
        f.write(_yaml(config["cli_config"]))
    store = os.path.join(out_dir, "store")
    argv = ["mapping", "--synthetic", "1", "--config", cfg_path, "--out", store, "--device", str(device)]
    watchdog.RunHealth, cli._frame_source = Health, source
    pipeline.BackEnd, pipeline.LoopClosing, pipeline.Viewer = BackEnd, LoopClosing, Viewer
    graph_optimizer.optimize_pose_graph = solve
    try:
        with contextlib.redirect_stdout(sys.stderr):
            rec.rc = cli.main(argv)
    finally:
        close_trace()
        watchdog.RunHealth, cli._frame_source = base_health, base_source
        pipeline.BackEnd, pipeline.LoopClosing, pipeline.Viewer = base_be, base_lc, base_viewer
        graph_optimizer.optimize_pose_graph = base_solve
        ndt_newton.ndt_newton = base_newton
    rec.end_s = None if st["t_end"] is None else time.perf_counter() - st["t_end"]
    rec.store_bytes = _tree_bytes(store)
    return rec


def window_frames(rec: Record) -> list:
    """The window's frames, each (frame, hand-over time, pose time): every
    frame from the first of the window to the last, whose `front_end`
    stage gave its pose."""
    return [(frame, t0, t1) for name, t0, t1, frame in rec.spans
            if name == "front_end" and rec.first_window_frame <= frame < rec.end_window_frame]
