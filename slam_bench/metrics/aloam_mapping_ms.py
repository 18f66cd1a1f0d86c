"""aloam_mapping_ms: A-LOAM's scan-to-map refinement and map fold (the
program's `aloam.mapping` and `aloam.fold` spans), the device's busy ms a
traced-tail sweep while they ran, from the profiler's trace
(aloam_features_ms.card_ms)."""

from slam_bench.metrics.aloam_features_ms import card_ms


def read(view):
    return card_ms(view, ("aloam.mapping", "aloam.fold"))
