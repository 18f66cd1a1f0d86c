"""map_update_ms: the front end's deferred map maintenance (the program's
`front_end.map_update` span around `_incremental_map_update`), ms a window
frame: each call's time on the card's timeline (its CUDA events), or its
host time where the span has none (the CPU).

Also the program's own spans for the readers that read them: the run the
program's tracer (`lidar_slam_tpu_torch.utils.watchdog`) kept last, and its
spans in the window's frames, selected by the CLI's frame index once that
index is checked against the harness's."""

import sys

SLACK_NS = 1000  # the harness's perf_counter seconds against the program's ns


def program_run():
    """The program's last traced run, or None where the program keeps none."""
    try:
        from lidar_slam_tpu_torch.utils import watchdog
    except ImportError:
        return None
    last = getattr(watchdog, "last_run", None)
    return last() if callable(last) else None


def window_spans(view, name: str):
    """The program's spans `name` in the window's frames, or None where the
    program keeps no spans or its frame index disagrees with the harness's:
    each window frame's `front_end` span of the program lies inside the
    harness's `front_end` span of the same index."""
    run = program_run()
    if run is None or not view.frames:
        return None
    spans = run.spans()
    inner = {s.frame: s for s in spans if s.name == "front_end" and s.frame in view.ids}
    for frame, t0, t1 in view.frames:
        s = inner.get(frame)
        if s is None or s.start < int(t0 * 1e9) - SLACK_NS or s.end > int(t1 * 1e9) + SLACK_NS:
            print(f"[slam_bench] the program's frame {frame} is not the harness's: its spans are not read",
                  file=sys.stderr, flush=True)
            return None
    return [s for s in spans if s.name == name and s.frame in view.ids]


def read(view):
    spans = window_spans(view, "front_end.map_update")
    if not spans:
        return None
    ns = sum(s.device_ns if s.device_ns is not None else s.end - s.start for s in spans)
    return ns * 1e-6 / len(view.frames)
