"""lm_iteration_ms: one Levenberg-Marquardt iteration of the pose-graph
solves started in the window (the program's `pose_graph` spans over their
`lm_iterations` counts), ms an iteration."""

from slam_bench.metrics.map_update_ms import window_spans


def read(view):
    spans = window_spans(view, "pose_graph")
    if not spans:
        return None
    iterations = sum((s.counts or {}).get("lm_iterations", 0) for s in spans)
    if not iterations:
        return None
    return sum(s.end - s.start for s in spans) * 1e-6 / iterations
