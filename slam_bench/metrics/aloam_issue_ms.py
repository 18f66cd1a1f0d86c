"""aloam_issue_ms: host ms a window frame spent issuing the A-LOAM step's
four parts (the program's `aloam.features`, `aloam.odometry`,
`aloam.mapping` and `aloam.fold` spans, host time; none of them waits on
the card)."""

from slam_bench.metrics.map_update_ms import window_spans

PARTS = ("aloam.features", "aloam.odometry", "aloam.mapping", "aloam.fold")


def read(view):
    parts = [window_spans(view, name) for name in PARTS]
    if any(not spans for spans in parts):
        return None
    return sum(s.end - s.start for spans in parts for s in spans) * 1e-6 / len(view.frames)
