"""aloam_features_ms: A-LOAM's feature extraction, the device's busy ms a
traced-tail sweep while it ran, from the profiler's trace.

The A-LOAM step issues its four parts (the program's `aloam.features`,
`aloam.odometry`, `aloam.mapping`, `aloam.fold` spans) without waiting on
the card, and ends with the pose's copy, which does (`aloam.step`). A
part's share of the card is the union of the device's operations from
the part's start to the next part's start, the fold's to its step's end,
on the trace's clock: what the card ran while the host issued that part,
work it had queued before included. The parts' windows tile each step, so
the three readers (features, odometry, mapping with the fold) add up to
the card's busy time over the steps. The CUDA events the spans also hold
time a part's stream from its first operation to its last, gaps
included, so on this host-bound step they read the issue time instead."""

from slam_bench import trace
from slam_bench.metrics.map_update_ms import program_run
from slam_bench.metrics.pose_graph_idle_share import idle_share

PARTS = ("aloam.features", "aloam.odometry", "aloam.mapping", "aloam.fold")


def part_windows(run, first_frame: int) -> tuple:
    """({part: [(start, end) ns on the trace's clock]}, the number of
    steps) over the steps of frames from `first_frame` on that hold all
    four parts."""
    by_frame = {}
    for s in run.spans():
        if s.frame is not None and s.frame >= first_frame and s.end > s.start and s.name in PARTS + ("aloam.step",):
            by_frame.setdefault(s.frame, {})[s.name] = s
    windows, steps = {p: [] for p in PARTS}, 0
    for f, spans in by_frame.items():
        if len(spans) < len(PARTS) + 1:
            continue
        steps += 1
        ends = [spans[p].start for p in PARTS[1:]] + [spans["aloam.step"].end]
        for p, end in zip(PARTS, ends):
            windows[p].append((run.epoch_ns(spans[p].start), run.epoch_ns(end)))
    return windows, steps


def card_ms(view, names):
    """The device's busy ms a traced-tail step while the parts `names` ran,
    or None without a trace or without the program's A-LOAM spans."""
    run = program_run()
    if run is None or not view.events:
        return None
    windows, steps = part_windows(run, view.rec.end_window_frame)
    if not steps:
        return None
    busy = trace.union(view.events)
    ns = 0.0
    for name in names:
        spans = windows[name]
        total = sum(b - a for a, b in spans)
        ns += total * (1.0 - idle_share(busy, spans) / 100.0)
    return ns * 1e-6 / steps


def read(view):
    return card_ms(view, ("aloam.features",))
