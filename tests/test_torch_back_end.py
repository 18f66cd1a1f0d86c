"""Parity of the port's back end and keyframe store with the JAX package.

One synthetic drive (a drifting odometry of a circle, GNSS positions with
noise, a keyframe cloud per frame, one loop edge) goes through both
packages' BackEnd, each with its own keyframe store, at small capacities so
that the graph grows by doubling and the thresholds trigger several
optimizations. Tolerances: keyframes and graph arrays equal (they are host
numpy on both sides), optimized poses within 1e-4 (float32 LM, see
test_torch_graph.py), stored clouds within the voxel-downsample parity of
test_torch_ops.py (2e-5).
"""

import os

import numpy as np
import pytest
import torch

from lidar_slam_tpu.io import SyntheticWorld, simulate_scan
from lidar_slam_tpu.io.keyframe_store import KeyframeStore as JStore
from lidar_slam_tpu.models.graph_optimizer import GraphOptimizerConfig as JOptCfg
from lidar_slam_tpu.pipeline import back_end as jbe

from lidar_slam_tpu_torch.io import KeyframeStore as TStore
from lidar_slam_tpu_torch.io import read_kitti_trajectory
from lidar_slam_tpu_torch.models.graph_optimizer import GraphOptimizerConfig as TOptCfg
from lidar_slam_tpu_torch.pipeline import back_end as tbe

POSE_ATOL = 1e-4
CLOUD_ATOL = 2e-5
N_FRAMES = 40
GRAPH_ARRAYS = ("_poses", "_node_valid", "_node_fixed", "_edge_ij", "_edge_meas", "_edge_info", "_edge_valid",
                "_prior_node", "_prior_xyz", "_prior_info", "_prior_valid", "_prior_quat", "_prior_type")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch's small CPU ops run faster on one thread than on a pool that
    parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs():
    kw = dict(max_nodes=8, max_edges=8, max_priors=8, optimize_step_with_key_frame=6, optimize_step_with_gnss=100,
              optimize_step_with_loop=1, key_frame_distance=1.5)
    return (jbe.BackEndConfig(optimizer=JOptCfg(max_iterations=30), **kw),
            tbe.BackEndConfig(optimizer=TOptCfg(max_iterations=30), **kw))


def _drive():
    """Ground truth on a 15 m circle at 1 m a frame, the odometry drifting
    in yaw and translation, GNSS 0.3 m noisy, one 2048-point scan a frame."""
    rng = np.random.default_rng(0)
    world = SyntheticWorld.corridor(length=60.0, width=40.0, density=8.0, seed=1)
    gt, odom = [], []
    T = np.eye(4, dtype=np.float32)
    for i in range(N_FRAMES):
        th = i / 15.0
        g = np.eye(4, dtype=np.float32)
        g[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
        g[:3, 3] = [15.0 * np.sin(th) + 20.0, 15.0 * (1 - np.cos(th)), 1.8]
        if i:
            step = np.linalg.inv(gt[-1]) @ g
            c, s = np.cos(0.004), np.sin(0.004)
            drift = np.float32([[c, -s, 0, 0.01], [s, c, 0, 0.0], [0, 0, 1, 0], [0, 0, 0, 1]])
            T = (T @ step @ drift).astype(np.float32)
        gt.append(g)
        odom.append(T.copy())
    gnss = [g[:3, 3] + rng.normal(0, 0.3, 3).astype(np.float32) for g in gt]
    clouds = [simulate_scan(world, gt[i], n_points=2048, max_range=30.0, seed=i)[:2] for i in range(N_FRAMES)]
    return np.stack(gt), np.stack(odom), gnss, clouds


def _run(be, odom, gnss, clouds):
    flags = []
    for i in range(N_FRAMES):
        pts, mask = clouds[i]
        flags.append(be.update(odom[i], time=0.1 * i, gnss_position=gnss[i], cloud_points=pts, cloud_mask=mask))
        if i == 30:
            be.insert_loop_pose(0, len(be.key_frames) - 1, np.linalg.inv(be.key_frames[0].pose) @ be.key_frames[-1].pose)
    stats = be.force_optimize()
    return flags, stats


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    gt, odom, gnss, clouds = _drive()
    cfg_j, cfg_t = _configs()
    roots = [str(tmp_path_factory.mktemp(n)) for n in ("jax", "port")]
    bj = jbe.BackEnd(cfg_j, store=JStore(roots[0]))
    bt = tbe.BackEnd(cfg_t, store=TStore(roots[1]), device="cpu")
    out_j = _run(bj, odom, gnss, clouds)
    out_t = _run(bt, odom, gnss, clouds)
    return bj, bt, out_j, out_t, roots


def test_back_end_matches_reference(runs):
    bj, bt, (flags_j, stats_j), (flags_t, stats_t), _ = runs
    assert flags_t == flags_j and sum(flags_t) > 10
    assert [(k.index, k.time) for k in bt.key_frames] == [(k.index, k.time) for k in bj.key_frames]
    for a, b in zip(bt.key_frames, bj.key_frames):
        np.testing.assert_array_equal(a.pose, b.pose)
    np.testing.assert_array_equal(bt._odom_to_map, bj._odom_to_map)
    assert bt.graph.max_nodes == bj.graph.max_nodes > 8  # grown by doubling
    for name in GRAPH_ARRAYS[1:]:
        np.testing.assert_array_equal(getattr(bt.graph, name), getattr(bj.graph, name), err_msg=name)
    n = bj.graph.n_nodes
    np.testing.assert_allclose(bt.graph._poses[:n], bj.graph._poses[:n], atol=POSE_ATOL)
    np.testing.assert_allclose(bt.optimized_poses, bj.optimized_poses, atol=POSE_ATOL)
    assert stats_t["chi2_after"] < stats_t["chi2_before"]
    assert stats_t["chi2_after"] == pytest.approx(stats_j["chi2_after"], rel=1e-3, abs=1e-4)
    assert bt.has_new_optimized() and bt.get_optimized_poses() is bt.optimized_poses and not bt.has_new_optimized()


def test_store_and_trajectory_files(runs):
    """Both stores hold the same keyframes (clouds downsampled at 0.5 m on
    each side), each readable by the other package's store, and both wrote
    optimized.txt."""
    bj, bt, _, _, roots = runs
    stores = {"jax": (JStore(roots[0], resume=True), TStore(roots[0], resume=True)),
              "port": (JStore(roots[1], resume=True), TStore(roots[1], resume=True))}
    assert {len(s) for pair in stores.values() for s in pair} == {len(bj.key_frames)}
    for i in range(len(bj.key_frames)):
        recs = {side: [s.load(i) for s in pair] for side, pair in stores.items()}
        for side, (by_jax, by_port) in recs.items():  # one package's files, read by both
            for key in ("points", "mask", "weights", "pose", "gnss"):
                np.testing.assert_array_equal(by_jax[key], by_port[key])
            assert by_jax["time"] == by_port["time"]
        j, t = recs["jax"][0], recs["port"][0]
        np.testing.assert_array_equal(t["mask"], j["mask"])
        np.testing.assert_allclose(t["points"], j["points"], atol=CLOUD_ATOL)
        np.testing.assert_allclose(t["weights"], j["weights"], atol=CLOUD_ATOL)
        np.testing.assert_array_equal(t["pose"], j["pose"])
        assert t["points"].shape == (32768, 3) and 0 < t["mask"].sum() < 2048
    for root in roots:
        traj = read_kitti_trajectory(os.path.join(root, "trajectory", "optimized.txt"))
        np.testing.assert_allclose(traj, bt.optimized_poses, atol=1e-3)


def test_restore_from_store(runs):
    """A back end rebuilt from the JAX package's store by both packages:
    the same keyframes and graph arrays, the anchor kept, and the next
    update takes the same path."""
    bj, _, _, _, roots = runs
    cfg_j, cfg_t = _configs()
    anchor = bj._odom_to_map
    rj = jbe.BackEnd(cfg_j)
    rt = tbe.BackEnd(cfg_t, device="cpu")
    assert rt.restore_from_store(TStore(roots[0], resume=True), odom_to_map=anchor) == \
        rj.restore_from_store(JStore(roots[0], resume=True), odom_to_map=anchor) == len(bj.key_frames)
    for name in GRAPH_ARRAYS:
        np.testing.assert_array_equal(getattr(rt.graph, name), getattr(rj.graph, name), err_msg=name)
    np.testing.assert_array_equal(rt._odom_to_map, anchor)
    assert (rt._new_kf_cnt, rt._new_gnss_cnt) == (rj._new_kf_cnt, rj._new_gnss_cnt)
    nxt = np.linalg.inv(anchor) @ bj.key_frames[-1].pose
    nxt[0, 3] += 3.0
    assert rt.update(nxt, time=9.0) == rj.update(nxt, time=9.0) is True
    np.testing.assert_array_equal(rt.key_frames[-1].pose, rj.key_frames[-1].pose)
