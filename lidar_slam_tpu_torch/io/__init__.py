from .synthetic import (
    SyntheticWorld,
    simulate_scan,
    simulate_spinning_scan,
    make_trajectory,
    make_hairpin_trajectory,
    hdl64_elevations,
)
from .keyframe_store import KeyframeStore
from .trajectory import (
    write_kitti_trajectory,
    read_kitti_trajectory,
    ate_rmse,
    rpe,
    umeyama_alignment,
)

__all__ = [
    "SyntheticWorld",
    "simulate_scan",
    "simulate_spinning_scan",
    "make_trajectory",
    "make_hairpin_trajectory",
    "hdl64_elevations",
    "KeyframeStore",
    "write_kitti_trajectory",
    "read_kitti_trajectory",
    "ate_rmse",
    "rpe",
    "umeyama_alignment",
]
