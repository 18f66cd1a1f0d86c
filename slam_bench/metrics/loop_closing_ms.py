"""loop_closing_ms: the `loop_closing` stage (LoopClosing.update: Scan
Context retrieval and NDT verification), ms a keyframe of the window."""

from slam_bench.window import stage_seconds


def read(view):
    calls = sum(1 for s in view.rec.spans if s[0] == "loop_closing" and s[3] in view.ids)
    if not calls:
        return None
    return stage_seconds(view.rec.spans, "loop_closing", view.ids) * 1e3 / calls
