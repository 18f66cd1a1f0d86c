"""pose_graph_idle_share: within the traced tail's pose-graph solves (the
program's `pose_graph` spans started in the tail's frames, put on the
trace's clock by the run's anchor), the share of time in which no
operation ran on the device, %. Like device_idle_share it comes from the
profiler-slowed tail."""

import bisect

from slam_bench import trace
from slam_bench.metrics.map_update_ms import program_run


def idle_share(busy: list, spans: list) -> float:
    """The share of the intervals `spans` [(start, end)] that the sorted,
    disjoint intervals `busy` [[start, end]] leave uncovered, %."""
    ends = [y for _, y in busy]
    total = covered = 0
    for a, b in spans:
        total += b - a
        i = bisect.bisect_right(ends, a)
        while i < len(busy) and busy[i][0] < b:
            covered += min(b, busy[i][1]) - max(a, busy[i][0])
            i += 1
    return 100.0 * (1.0 - covered / total)


def read(view):
    run = program_run()
    if run is None or not view.events:
        return None
    first = view.rec.end_window_frame
    spans = [(run.epoch_ns(s.start), run.epoch_ns(s.end)) for s in run.spans()
             if s.name == "pose_graph" and s.frame is not None and s.frame >= first and s.end > s.start]
    if not spans:
        return None
    return idle_share(trace.union(view.events), spans)
