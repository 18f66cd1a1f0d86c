"""device_idle_share: the share of the traced tail (whole steady laps after
the window) in which no operation ran on the device (1 - the union of
kernel, copy and fill intervals over it), %."""


def read(view):
    if not view.events:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
