"""Trajectory files and metrics: the JAX package's numpy-only module
(lidar_slam_tpu/io/trajectory.py), loaded by path and re-exported."""

from ._reference import load_reference_module

_m = load_reference_module("trajectory")

write_kitti_trajectory = _m.write_kitti_trajectory
read_kitti_trajectory = _m.read_kitti_trajectory
umeyama_alignment = _m.umeyama_alignment
ate_rmse = _m.ate_rmse
rpe = _m.rpe
