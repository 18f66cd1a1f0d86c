"""pcg_kernel_share: the share of the window's LM iterations whose linear
solve ran as the hand-written PCG kernel (the program's `pcg_launches` over
`lm_iterations` on its `pose_graph` spans), %. None where no span carries
the counter: a program without the kernel."""

from slam_bench.metrics.map_update_ms import window_spans


def read(view):
    spans = window_spans(view, "pose_graph")
    if not spans or not any("pcg_launches" in (s.counts or {}) for s in spans):
        return None
    iterations = sum((s.counts or {}).get("lm_iterations", 0) for s in spans)
    if not iterations:
        return None
    return 100.0 * sum((s.counts or {}).get("pcg_launches", 0) for s in spans) / iterations
