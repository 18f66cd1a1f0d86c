"""Trajectory files and metrics.

The KITTI 3x4 row-major format is exactly what the reference's back end
writes for ground_truth / laser_odom / optimized trajectories
(src/mapping/back_end/back_end.cpp:149-169, 272-288); evaluation there is
external (evo). Here ATE/RPE are built in so CI can gate on them
(SURVEY.md §4 implication).

The port's own copy of lidar_slam_tpu/io/trajectory.py, with the same
functions and the same arithmetic.
"""

from __future__ import annotations

import numpy as np


def write_kitti_trajectory(path: str, poses) -> None:
    """Write [N, 4, 4] poses as KITTI 12-number rows."""
    poses = np.asarray(poses)
    with open(path, "w") as f:
        for T in poses:
            row = T[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9g}" for v in row) + "\n")


def read_kitti_trajectory(path: str) -> np.ndarray:
    raw = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (len(raw), 1, 1))
    out[:, :3, :] = raw
    return out


def umeyama_alignment(est_xyz: np.ndarray, gt_xyz: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid alignment est -> gt (Umeyama 1991).
    Returns (R, t, s)."""
    mu_e = est_xyz.mean(axis=0)
    mu_g = gt_xyz.mean(axis=0)
    de = est_xyz - mu_e
    dg = gt_xyz - mu_g
    cov = dg.T @ de / len(est_xyz)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (de**2).sum() / len(est_xyz)
        s = np.trace(np.diag(D) @ S) / var_e
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est_poses, gt_poses, align: bool = True) -> float:
    """Absolute trajectory error RMSE over translations (evo convention)."""
    est = np.asarray(est_poses)[:, :3, 3]
    gt = np.asarray(gt_poses)[:, :3, 3]
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    if align:
        R, t, s = umeyama_alignment(est, gt)
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def rpe(est_poses, gt_poses, delta: int = 1):
    """Relative pose error over a fixed frame delta.
    Returns (trans_rmse [m], rot_rmse [rad])."""
    est = np.asarray(est_poses)
    gt = np.asarray(gt_poses)
    n = min(len(est), len(gt))
    terrs, rerrs = [], []
    for i in range(n - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        terrs.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerrs.append(np.arccos(c))
    return float(np.sqrt(np.mean(np.square(terrs)))), float(np.sqrt(np.mean(np.square(rerrs))))
