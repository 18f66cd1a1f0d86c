"""back_end_ms: the `back_end` stage's self time (BackEnd.update, the
pose-graph solves it starts taken out), ms a window frame."""

from slam_bench.window import solve_seconds, stage_seconds


def read(view):
    if not view.frames:
        return None
    inside = solve_seconds(view.rec.solves, view.ids, by="back_end")
    return (stage_seconds(view.rec.spans, "back_end", view.ids) - inside) * 1e3 / len(view.frames)
