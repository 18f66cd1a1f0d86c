"""pose_ms_p95: the 95th percentile, over every frame of the window, of the
time from the frame's hand-over (its `front_end` stage starts) to its pose
(the stage ends): what a consumer of the odometry waits, ms."""

from slam_bench.window import percentile


def read(view):
    if not view.frames:
        return None
    return percentile([(t1 - t0) * 1e3 for _, t0, t1 in view.frames], 95)
