from .eigh3 import sym_eigh3
from .hashgrid import BucketGrid, build_bucket_grid, knn_query
from .linalg3 import solve3
from .pointcloud import (
    PointCloud,
    box_crop_mask,
    finite_mask,
    range_mask,
    rotated_box_mask,
    scatter_sum,
    voxel_downsample,
    voxel_downsample_dense,
)

__all__ = [
    "sym_eigh3",
    "BucketGrid",
    "build_bucket_grid",
    "knn_query",
    "solve3",
    "PointCloud",
    "box_crop_mask",
    "finite_mask",
    "range_mask",
    "rotated_box_mask",
    "scatter_sum",
    "voxel_downsample",
    "voxel_downsample_dense",
]
