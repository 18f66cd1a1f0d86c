"""loop_verify_ms: one loop verification attempt (the program's
`loop_closing.verify` span around `_verify_step`: the submap's downsample
and NDT map, the scan's downsample, the alignment, the fitness and their
one host read), ms an attempt in the window."""

from slam_bench.metrics.map_update_ms import window_spans


def read(view):
    spans = window_spans(view, "loop_closing.verify")
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) * 1e-6 / len(spans)
