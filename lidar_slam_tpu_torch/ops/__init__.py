from .eigh3 import sym_eigh3
from .pointcloud import PointCloud, finite_mask, rotated_box_mask, scatter_sum, voxel_downsample

__all__ = [
    "sym_eigh3",
    "PointCloud",
    "finite_mask",
    "rotated_box_mask",
    "scatter_sum",
    "voxel_downsample",
]
