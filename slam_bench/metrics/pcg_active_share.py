"""pcg_active_share: the share of the PCG steps run in the window's solves
that did work (the program's `pcg_active_steps` over `pcg_steps` on its
`pose_graph` spans; a step after the residual fell under `pcg_tol` still
issues its matvec, its state frozen), %. Dense solves count no steps."""

from slam_bench.metrics.map_update_ms import window_spans


def read(view):
    spans = window_spans(view, "pose_graph")
    if not spans:
        return None
    steps = sum((s.counts or {}).get("pcg_steps", 0) for s in spans)
    if not steps:
        return None
    return 100.0 * sum((s.counts or {}).get("pcg_active_steps", 0) for s in spans) / steps
