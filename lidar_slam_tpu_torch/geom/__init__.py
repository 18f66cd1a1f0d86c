from .se3 import (
    se3_exp,
    se3_log,
    so3_hat,
    euler_xyz_to_matrix,
    matrix_to_euler_xyz,
    make_pose,
    pose_inverse,
    transform_points,
)

__all__ = [
    "se3_exp",
    "se3_log",
    "so3_hat",
    "euler_xyz_to_matrix",
    "matrix_to_euler_xyz",
    "make_pose",
    "pose_inverse",
    "transform_points",
]
