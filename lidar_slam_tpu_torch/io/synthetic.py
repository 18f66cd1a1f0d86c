"""Synthetic LiDAR world + scan simulator: the JAX package's numpy-only
generator (lidar_slam_tpu/io/synthetic.py), loaded by path and re-exported
so both packages drive on identical data."""

from ._reference import load_reference_module

_m = load_reference_module("synthetic")

DynamicBox = _m.DynamicBox
SyntheticWorld = _m.SyntheticWorld
make_trajectory = _m.make_trajectory
make_hairpin_trajectory = _m.make_hairpin_trajectory
hdl64_elevations = _m.hdl64_elevations
simulate_scan = _m.simulate_scan
simulate_spinning_scan = _m.simulate_spinning_scan
skew_scan = _m.skew_scan
bboxes_for = _m.bboxes_for
