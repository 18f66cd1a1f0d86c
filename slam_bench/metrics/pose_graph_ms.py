"""pose_graph_ms: every pose-graph solve started in the window
(graph_optimizer.optimize_pose_graph, the harness's span around it), ms a
window frame."""

from slam_bench.window import solve_seconds


def read(view):
    if not view.frames:
        return None
    return solve_seconds(view.rec.solves, view.ids) * 1e3 / len(view.frames)
