"""store_io_ms: the keyframe store's file writes and reads (the program's
`store.save` and `store.load` spans: compressed npz records, written by the
back end, read back by loop closing), ms a window frame."""

from slam_bench.metrics.map_update_ms import window_spans


def read(view):
    saves, loads = window_spans(view, "store.save"), window_spans(view, "store.load")
    if not saves and not loads:
        return None
    return sum(s.end - s.start for s in saves + loads) * 1e-6 / len(view.frames)
