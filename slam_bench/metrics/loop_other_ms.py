"""loop_other_ms: the CLI frame loop's time outside every stage and solve
(the live trajectory, save_progress, the viewer, the prefetch hand-over),
ms a window frame."""

from slam_bench.window import solve_seconds, stage_seconds


def read(view):
    if not view.frames:
        return None
    stages = sum(stage_seconds(view.rec.spans, s, view.ids) for s in ("front_end", "back_end", "loop_closing"))
    outside = solve_seconds(view.rec.solves, view.ids, by="loop")
    return (view.w1 - view.w0 - stages - outside) * 1e3 / len(view.frames)
