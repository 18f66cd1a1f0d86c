"""aloam_step_ms: the A-LOAM front end's step (the program's `aloam.step`
span, from the sweep's hand-over to its pose's copy), host ms a window
frame."""

from slam_bench.metrics.map_update_ms import window_spans


def read(view):
    spans = window_spans(view, "aloam.step")
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) * 1e-6 / len(view.frames)
