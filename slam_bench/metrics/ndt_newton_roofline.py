"""ndt_newton_roofline: the ndt_newton kernel's share of its roofline over
the traced tail (whole steady laps after the window), %: the sum of each
launch's least time (roofline.bound of roofline.ndt_work on the launch's
own inputs and reported iterations) over the sum of the kernel's device
times in the trace."""

from slam_bench import roofline

KERNEL = "ndt_newton_kernel"


def read(view):
    if view.events is None or not view.rec.newton_calls:
        return None
    device_ns = sum(b - a for name, a, b in view.events if KERNEL in name)
    if device_ns <= 0:
        return None
    least = sum(roofline.bound(*roofline.ndt_work(c))[0] for c in view.rec.newton_calls)
    return 100.0 * least / (device_ns * 1e-9)
