"""aloam_odometry_ms: A-LOAM's frame-to-frame odometry (the program's
`aloam.odometry` span), the device's busy ms a traced-tail sweep while it
ran, from the profiler's trace (aloam_features_ms.card_ms)."""

from slam_bench.metrics.aloam_features_ms import card_ms


def read(view):
    return card_ms(view, ("aloam.odometry",))
