"""Ground Plane Fitting (GPF) segmentation, in PyTorch (port of
lidar_slam_tpu/models/ground_seg.py; GroundPlaneFit_node.cpp:92-361, after
"Fast Segmentation of 3D Point Clouds: A Paradigm on LiDAR Data").

Seeds the ground with the lowest-point representative (LPR), then refits a
plane to the current ground set and re-thresholds every point by its plane
distance, a fixed number of times. Every step is a device op on the cloud's
device; nothing is read back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.eigh3 import sym_eigh3
from ..ops.pointcloud import PointCloud


@dataclasses.dataclass(frozen=True)
class GroundSegConfig:
    """Parameters as in the node (GroundPlaneFit_node.cpp:100-120)."""

    sensor_height: float = 1.8
    num_lpr: int = 20
    th_seeds: float = 1.2
    th_dist: float = 0.3
    num_iter: int = 3


def segment_ground(cloud: PointCloud, cfg: GroundSegConfig = GroundSegConfig()):
    """Returns (ground_mask, nonground_mask) over the cloud's points.

    Points below -1.5 * sensor_height are treated as spurious reflections
    and excluded from both sets (the node's error-point removal, :205-214).
    The LPR is the mean z of the num_lpr lowest usable points (a top-k of
    -z: only the values' mean is used, so ties do not matter); the plane
    normal is the smallest-eigenvalue eigenvector of the ground set's
    covariance (its sign does not matter: the test is |distance|).
    """
    pts = cloud.points
    z = pts[:, 2]
    usable = cloud.mask & (z > -1.5 * cfg.sensor_height)

    neg_z = torch.where(usable, -z, -torch.inf)
    lowest = torch.topk(neg_z, cfg.num_lpr).values
    ok = torch.isfinite(lowest)
    lpr = torch.sum(torch.where(ok, -lowest, 0.0)) / torch.clamp(torch.sum(ok), min=1)

    ground = usable & (z < lpr + cfg.th_seeds)
    for _ in range(cfg.num_iter):
        w = ground.to(torch.float32)
        n = torch.clamp(torch.sum(w), min=3.0)
        mu = torch.sum(pts * w[:, None], dim=0) / n
        d = (pts - mu) * w[:, None]
        cov = d.T @ d / n
        _, evecs = sym_eigh3(cov[None])
        dist = (pts - mu) @ evecs[0, :, 0]
        ground = usable & (torch.abs(dist) < cfg.th_dist)
    return ground, usable & ~ground
