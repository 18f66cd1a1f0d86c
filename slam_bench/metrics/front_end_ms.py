"""front_end_ms: the `front_end` stage (RunHealth; FrontEnd.update up to the
pose's host read), ms a window frame."""

from slam_bench.window import stage_seconds


def read(view):
    if not view.frames:
        return None
    return stage_seconds(view.rec.spans, "front_end", view.ids) * 1e3 / len(view.frames)
