from .ndt import (
    NDTConfig,
    NDTMap,
    NDTMapSums,
    NDTResult,
    build_ndt_map,
    empty_ndt_sums,
    scatter_to_sums,
    recenter_ndt_sums,
    coarsen_ndt_sums,
    finalize_ndt_sums,
    ndt_derivatives,
    ndt_align,
)

__all__ = [
    "NDTConfig",
    "NDTMap",
    "NDTMapSums",
    "NDTResult",
    "build_ndt_map",
    "empty_ndt_sums",
    "scatter_to_sums",
    "recenter_ndt_sums",
    "coarsen_ndt_sums",
    "finalize_ndt_sums",
    "ndt_derivatives",
    "ndt_align",
]
