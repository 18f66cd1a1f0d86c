"""window_knn_roofline: kernel K2's share of its roofline over the traced
tail, %: the sum of each launch's least time (roofline.bound of
roofline_knn.work, counted by the entry on each launch's own inputs and
result) over the sum of the kernel's device times in the trace."""

from slam_bench import roofline

KERNEL = "knn_kernel"


def read(view):
    work = getattr(view.rec, "knn_work", None)
    if view.events is None or not work:
        return None
    device_ns = sum(b - a for name, a, b in view.events if KERNEL in name)
    if device_ns <= 0:
        return None
    least = sum(roofline.bound(n_bytes, flops)[0] for n_bytes, flops in work)
    return 100.0 * least / (device_ns * 1e-9)
