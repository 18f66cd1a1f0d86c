"""The multi-rank dry run (port of __graft_entry__.py::dryrun_multichip):
every sharded path of the port, once, at KITTI-scale shapes, on a mesh of
N ranks:

  - the map build sharded over points and voxel slabs (a 524 288-voxel
    grid, a 32 768-point map cloud);
  - the local map sharded over keyframes (16 keyframes x 2 048 points);
  - the NDT alignment sharded over points (an 8 192-point scan);
  - the pose graph sharded over edges (PCG) and over node blocks (Schur),
    a 128-node chain with GNSS priors;
  - one pipelined step: track, fold the frame into the keyframe window at
    the aligned pose and rebuild the sharded local map, optimize with the
    tracked pose as the newest node;
  - the production drive, front_end_drive(mesh=), over 3 frames.

    python3 -m lidar_slam_tpu_torch.parallel.dryrun N [--device cpu]

runs it on N ranks (NCCL on N cards, or gloo on the named device).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..models.graph_optimizer import GraphOptimizerConfig, PoseGraphBuilder
from ..models.registration import NDTConfig
from ..ops.pointcloud import PointCloud
from ..pipeline.front_end import FrontEndConfig, front_end_drive, init_front_end_drive
from .launch import launch
from .mesh import Mesh
from .sharded_graph import optimize_pose_graph_sharded
from .sharded_ndt import sharded_build_local_map, sharded_build_ndt_map, sharded_ndt_align
from .sharded_schur import optimize_pose_graph_schur, schur_prepare

MAP_CAP = 32768
N_KEYFRAMES, KF_POINTS = 16, 2048
SCAN_CAP = 8192
N_NODES = 128


def tiny_scene(n_blobs=24, pts_per_blob=40, seed=0):
    """Anisotropic Gaussian blobs (__graft_entry__.py's scene)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, size=(n_blobs, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(-2, 4, size=n_blobs)
    pts = []
    for c in centers:
        A = rng.normal(size=(3, 3)).astype(np.float32) * np.asarray([0.3, 0.3, 0.05], np.float32)
        pts.append(c + rng.normal(size=(pts_per_blob, 3)).astype(np.float32) @ A)
    return np.concatenate(pts)


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"dry run: {msg}")


def _chain_graph(n_devices: int, dev) -> PoseGraphBuilder:
    """A chain of N_NODES poses 1 m apart, noisy odometry edges and an XYZ
    prior on every node but the first (fixed)."""
    builder = PoseGraphBuilder(max_nodes=N_NODES, max_edges=8 * n_devices, max_priors=8 * n_devices, device=dev)
    rng = np.random.default_rng(0)
    T = np.eye(4, dtype=np.float32)
    poses = []
    for i in range(N_NODES):
        poses.append(T.copy())
        builder.add_se3_node(T, fixed=(i == 0))
        step = np.eye(4, dtype=np.float32)
        step[0, 3] = 1.0
        T = T @ step
    for i in range(1, N_NODES):
        Z = np.linalg.inv(poses[i - 1]) @ poses[i]
        Z[:3, 3] += rng.normal(0, 0.05, 3)
        builder.add_se3_edge(i - 1, i, Z, noise=[0.5, 0.5, 0.5, 0.01, 0.01, 0.01])
        builder.add_se3_prior_xyz_edge(i, poses[i][:3, 3], noise=[1.0, 1.0, 1.0])
    return builder


def dryrun_rank(mesh: Mesh) -> dict:
    """One rank of the dry run; raises RuntimeError on a failed check.
    Returns a summary (the same on every rank)."""
    dev = mesh.device
    n = mesh.size
    rng = np.random.default_rng(1)
    cfg = NDTConfig(grid_dims=(128, 128, 32), point_chunk=2048, max_iter=10)
    origin = np.asarray([-64.0, -64.0, -8.0], np.float32)
    pts = tiny_scene(n_blobs=512, pts_per_blob=64, seed=1)
    out = {}

    target = PointCloud.from_points(pts[:MAP_CAP], capacity=MAP_CAP, device=dev)
    ndt_map = sharded_build_ndt_map(target, origin, cfg, mesh)
    out["map_voxels"] = int(ndt_map.valid.sum())
    _check(out["map_voxels"] > 0, "the sharded map build produced no voxels")

    kf_pts = torch.as_tensor(pts[: N_KEYFRAMES * KF_POINTS].reshape(N_KEYFRAMES, KF_POINTS, 3), device=dev)
    kf_poses = np.tile(np.eye(4, dtype=np.float32), (N_KEYFRAMES, 1, 1))
    kf_poses[:, :3, 3] = rng.normal(0, 0.5, (N_KEYFRAMES, 3))
    ones_m = torch.ones((N_KEYFRAMES, KF_POINTS), dtype=torch.bool, device=dev)
    ones_w = torch.ones((N_KEYFRAMES, KF_POINTS), device=dev)
    valid = np.ones(N_KEYFRAMES, bool)
    local_map = sharded_build_local_map(kf_pts, ones_m, ones_w, kf_poses, valid, origin, cfg, mesh)
    out["local_map_voxels"] = int(local_map.valid.sum())
    _check(out["local_map_voxels"] > 0, "the sharded local map has no voxels")

    source = PointCloud.from_points(pts[:SCAN_CAP] + np.float32([0.1, 0.05, 0.0]), capacity=SCAN_CAP, device=dev)
    result = sharded_ndt_align(ndt_map, source, np.eye(4, dtype=np.float32), cfg, mesh)
    out["pose"] = result.pose.numpy()
    _check(np.isfinite(out["pose"]).all(), "the sharded alignment gave a non-finite pose")

    builder = _chain_graph(n, dev)
    graph, stats = optimize_pose_graph_sharded(builder.to_graph(), GraphOptimizerConfig(max_iterations=10, solver="pcg"),
                                               mesh)
    _check(torch.isfinite(graph.poses).all().item(), "the edge-sharded solve gave non-finite poses")
    _check(stats["chi2_after"] <= stats["chi2_before"] + 1e-6, "the edge-sharded solve raised chi2")
    out["pcg_chi2"] = (stats["chi2_before"], stats["chi2_after"])

    sg = schur_prepare(builder.to_graph(), n_devices=n, sep_cap=16)
    graph_s, stats_s = optimize_pose_graph_schur(sg, GraphOptimizerConfig(max_iterations=10), mesh)
    _check(torch.isfinite(graph_s.poses).all().item(), "the Schur solve gave non-finite poses")
    _check(stats_s["chi2_after"] <= stats_s["chi2_before"] + 1e-6, "the Schur solve raised chi2")
    out["schur_chi2"] = (stats_s["chi2_before"], stats_s["chi2_after"])

    # one pipelined step: track -> keyframe update -> optimize
    r = sharded_ndt_align(ndt_map, source, np.eye(4, dtype=np.float32), cfg, mesh)
    new_pts = torch.cat([kf_pts[1:], source.points[None, :KF_POINTS]])
    new_msk = torch.cat([ones_m[1:], source.mask[None, :KF_POINTS]])
    new_poses = np.concatenate([kf_poses[1:], r.pose.numpy()[None]])
    new_map = sharded_build_local_map(new_pts, new_msk, ones_w, new_poses, valid, origin, cfg, mesh)
    g = builder.to_graph()
    g.poses[-1] = r.pose.to(dev)
    g2, st2 = optimize_pose_graph_sharded(g, GraphOptimizerConfig(max_iterations=5, solver="pcg"), mesh)
    _check(np.isfinite(r.pose.numpy()).all() and int(new_map.valid.sum()) > 0, "the pipelined step failed")
    _check(torch.isfinite(g2.poses).all().item() and np.isfinite(st2["chi2_after"]), "the pipelined solve failed")

    # the production drive: front_end_drive with every alignment sharded
    fe_cfg = FrontEndConfig(
        ndt=NDTConfig(resolution=1.0, grid_dims=(64, 64, 16), point_chunk=1024, max_iter=8),
        raw_capacity=8192, frame_capacity=4096, keyframe_capacity=2048, local_frame_num=4,
    )
    n_frames = 3
    drv_pts = np.zeros((n_frames, fe_cfg.raw_capacity, 3), np.float32)
    drv_msk = np.zeros((n_frames, fe_cfg.raw_capacity), bool)
    for i in range(n_frames):
        sc = tiny_scene(n_blobs=128, pts_per_blob=32, seed=20 + i) + np.float32([0.4 * i, 0, 0])
        m = min(len(sc), fe_cfg.raw_capacity)
        drv_pts[i, :m] = sc[:m]
        drv_msk[i, :m] = True
    st = init_front_end_drive(fe_cfg, device=dev)
    _, drv_poses, drv_kfs, _ = front_end_drive(st, torch.as_tensor(drv_pts, device=dev),
                                               torch.as_tensor(drv_msk, device=dev), fe_cfg, mesh=mesh)
    _check(torch.isfinite(drv_poses).all().item() and bool(drv_kfs[0]), "the sharded drive failed")
    out["drive_poses"] = drv_poses.numpy()
    return out


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the dry run on `n_devices` ranks (NCCL on that many cards, or
    gloo on `device`); rank 0's summary."""
    return launch(dryrun_rank, n_devices, device=device, timeout=900.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The multi-rank dry run of every sharded path.")
    ap.add_argument("n", type=int, nargs="?", default=None, help="ranks (default: the CUDA cards here)")
    ap.add_argument("--device", default=None, help="run every rank on this device under gloo (e.g. cpu)")
    args = ap.parse_args(argv)
    n = args.n or torch.cuda.device_count()
    if n < 1:
        ap.error("no CUDA card: pass N and --device cpu")
    out = dryrun_multichip(n, device=args.device)
    print(f"dryrun_multichip ok on {n} ranks: map {out['map_voxels']} voxels, local map "
          f"{out['local_map_voxels']}, PCG chi2 {out['pcg_chi2'][0]:.2f} -> {out['pcg_chi2'][1]:.4f}, "
          f"Schur chi2 {out['schur_chi2'][0]:.2f} -> {out['schur_chi2'][1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
