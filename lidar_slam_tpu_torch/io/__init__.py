from .synthetic import (
    SyntheticWorld,
    simulate_scan,
    simulate_spinning_scan,
    make_trajectory,
    make_hairpin_trajectory,
    hdl64_elevations,
)
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
    "write_kitti_trajectory",
    "read_kitti_trajectory",
    "ate_rmse",
    "rpe",
    "umeyama_alignment",
]
