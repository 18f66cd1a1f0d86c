"""Parity of the port's launch-layer components with the JAX package: ENU,
the KITTI readers and writer, the de-skew, data pretreatment, ICP and the
registration factory, the cloud filters, the watchdog and the streaming
median, the config loader and its YAML reader, and the viewer.

The same seeded numpy inputs go through the JAX function (on the CPU) and
the port's (`device="cpu"`). Tolerances, stated at each test: equal where
both sides are the same numpy code; 1e-6 on float32 trigonometry of the two
libraries; 1e-5 for the de-skew (float32 rotations of 10 m points);
registration poses (ICP, the factory) within REG_TOL (float32 solves whose sums
are taken in different orders, over the same correspondences). Torch is
pinned to one CPU thread while the file runs.
"""

import dataclasses
import filecmp
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lidar_slam_tpu import config as jconfig
from lidar_slam_tpu.geom import enu as jenu
from lidar_slam_tpu.geom import se3 as jse3
from lidar_slam_tpu.io import keyframe_store as jks
from lidar_slam_tpu.io import kitti as jkitti
from lidar_slam_tpu.io import kitti_writer as jkw
from lidar_slam_tpu.io.synthetic import SyntheticWorld, bboxes_for, make_hairpin_trajectory, simulate_scan
from lidar_slam_tpu.models import cloud_filter as jcf
from lidar_slam_tpu.models import scan_adjust as jsa
from lidar_slam_tpu.models.registration import NDTConfig as JNDTConfig
from lidar_slam_tpu.models.registration import factory as jfac
from lidar_slam_tpu.models.registration import icp as jicp
from lidar_slam_tpu.ops import PointCloud as JCloud
from lidar_slam_tpu.ops import build_bucket_grid as j_build_bucket_grid
from lidar_slam_tpu.pipeline import data_pretreat as jdp
from lidar_slam_tpu.pipeline import viewer as jviewer
from lidar_slam_tpu.utils import StreamingMedian as JMedian
from lidar_slam_tpu.utils import watchdog as jwd

from lidar_slam_tpu_torch import config as tconfig
from lidar_slam_tpu_torch.geom import enu as tenu
from lidar_slam_tpu_torch.io import keyframe_store as tks
from lidar_slam_tpu_torch.io import kitti as tkitti
from lidar_slam_tpu_torch.io import kitti_writer as tkw
from lidar_slam_tpu_torch.models import cloud_filter as tcf
from lidar_slam_tpu_torch.models import scan_adjust as tsa
from lidar_slam_tpu_torch.models.registration import NDTConfig as TNDTConfig
from lidar_slam_tpu_torch.models.registration import factory as tfac
from lidar_slam_tpu_torch.models.registration import icp as ticp
from lidar_slam_tpu_torch.ops import PointCloud as TCloud
from lidar_slam_tpu_torch.ops import build_bucket_grid as t_build_bucket_grid
from lidar_slam_tpu_torch.pipeline import data_pretreat as tdp
from lidar_slam_tpu_torch.pipeline import viewer as tviewer
from lidar_slam_tpu_torch.utils import StreamingMedian as TMedian
from lidar_slam_tpu_torch.utils import watchdog as twd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [os.path.join(REPO, "configs", f) for f in ("kitti_hdl64.yaml", "synthetic_small.yaml")]
# Registration poses, port against JAX: ICP as the largest entry of se3_log of
# the relative pose (m and rad), the factory as the largest pose-matrix entry.
# The largest gap seen was 7.2e-7 (CPU, one torch thread)
REG_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch's small CPU ops run faster on one thread than on a pool that
    parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- ENU -------------------------------------------------------------------
def test_enu_equal():
    rng = np.random.default_rng(0)
    lat0, lon0, alt0 = 48.98254523586602, 8.39036610004, 116.43
    lat = lat0 + rng.uniform(-1e-3, 1e-3, 50)
    lon = lon0 + rng.uniform(-1e-3, 1e-3, 50)
    alt = alt0 + rng.uniform(-5, 5, 50)
    e_j = jenu.geodetic_to_enu(lat, lon, alt, lat0, lon0, alt0)
    e_t = tenu.geodetic_to_enu(lat, lon, alt, lat0, lon0, alt0)
    np.testing.assert_array_equal(e_t, e_j)
    for a, b in zip(tenu.enu_to_geodetic(e_t, lat0, lon0, alt0), jenu.enu_to_geodetic(e_j, lat0, lon0, alt0)):
        np.testing.assert_array_equal(a, b)
    lc_j, lc_t = jenu.LocalCartesian(), tenu.LocalCartesian()
    with pytest.raises(RuntimeError):
        lc_t.forward(lat0, lon0, alt0)
    lc_j.reset(lat0, lon0, alt0)
    lc_t.reset(lat0, lon0, alt0)
    np.testing.assert_array_equal(lc_t.forward(lat[3], lon[3], alt[3]), lc_j.forward(lat[3], lon[3], alt[3]))


# -- KITTI readers and writer --------------------------------------------------
def _drive_frames(n=24):
    """A hairpin with a moving truck: scans, noisy GNSS poses and the truck's
    detector boxes (some frames see none: the truck is out of range)."""
    world = SyntheticWorld.corridor(length=40, seed=7)
    world.add_moving_box(center0=(12.0, 2.0, 1.0), size=(4.0, 2.0, 2.0), heading=0.0,
                         velocity=(0.8, 0.0), n_points=200)
    gt = make_hairpin_trajectory(n_out=8, n_turn=10, n_back=6, speed=1.0, turn_radius=1.0)
    rng = np.random.default_rng(11)
    frames = []
    for i in range(n):
        pts, mask, _ = simulate_scan(world, gt[i], t=i * 0.1, n_points=2048, max_range=10.0 + i, seed=500 + i)
        pose = gt[i].astype(np.float64).copy()
        pose[:3, 3] += rng.normal(0, 0.1, 3)
        frames.append({"points": pts[mask], "pose": pose, "time": i * 0.1,
                       "bboxes": bboxes_for(world, gt[i], t=i * 0.1)})
    return frames


def test_writer_byte_identical(tmp_path):
    frames = _drive_frames()
    dj = jkw.write_kitti_raw_drive(str(tmp_path / "jax"), frames)
    dt = tkw.write_kitti_raw_drive(str(tmp_path / "port"), frames)
    cmp = filecmp.dircmp(str(tmp_path / "jax"), str(tmp_path / "port"))

    def same(c):
        assert not c.left_only and not c.right_only and not c.funny_files, c.report()
        _, mismatch, errors = filecmp.cmpfiles(c.left, c.right, c.common_files, shallow=False)
        assert not mismatch and not errors, (c.left, mismatch, errors)
        for sub in c.subdirs.values():
            same(sub)

    same(cmp)
    bbox_j = os.path.join(os.path.dirname(dj), "bbox", "0001")
    bbox_t = os.path.join(os.path.dirname(dt), "bbox", "0001")
    for i in range(len(frames)):
        a, b = tkw.read_bbox_dir(bbox_t, i), jkw.read_bbox_dir(bbox_j, i)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert tkw.read_bbox_dir(bbox_t, 999) is None


def test_raw_reader_matches(tmp_path):
    frames = _drive_frames(12)
    drive = jkw.write_kitti_raw_drive(str(tmp_path / "k"), frames)
    rj, rt = jkitti.KittiRawReader(drive), tkitti.KittiRawReader(drive)
    assert len(rt) == len(rj) == 12
    np.testing.assert_array_equal(rt.T_imu_to_velo, rj.T_imu_to_velo)
    for fj, ft in zip(rj, rt):
        assert ft["index"] == fj["index"] and ft["time"] == fj["time"]
        np.testing.assert_array_equal(ft["points"], fj["points"])
        np.testing.assert_array_equal(ft["reflectance"], fj["reflectance"])
        assert dataclasses.astuple(ft["oxts"]) == dataclasses.astuple(fj["oxts"])
        assert ft["gnss_pose"].dtype == fj["gnss_pose"].dtype == np.float32
        np.testing.assert_allclose(ft["gnss_pose"], fj["gnss_pose"], atol=1e-6)
    assert rt.gnss_origin() == rj.gnss_origin()
    rt.set_gnss_origin(48.9, 8.4, 100.0)
    assert rt.gnss_origin() == (48.9, 8.4, 100.0)


def test_odometry_reader_matches(tmp_path):
    root = str(tmp_path)
    seq = os.path.join(root, "sequences", "00")
    os.makedirs(os.path.join(seq, "velodyne"))
    os.makedirs(os.path.join(root, "poses"))
    rng = np.random.default_rng(1)
    for i in range(3):
        rng.normal(size=(50, 4)).astype(np.float32).tofile(os.path.join(seq, "velodyne", f"{i:06d}.bin"))
    np.savetxt(os.path.join(seq, "times.txt"), np.arange(3) * 0.1)
    np.savetxt(os.path.join(root, "poses", "00.txt"), rng.normal(size=(3, 12)))
    for fj, ft in zip(jkitti.KittiOdometryReader(root, "00"), tkitti.KittiOdometryReader(root, "00")):
        assert ft["index"] == fj["index"] and ft["time"] == fj["time"]
        np.testing.assert_array_equal(ft["points"], fj["points"])
        np.testing.assert_array_equal(ft["gt_pose"], fj["gt_pose"])
    np.testing.assert_array_equal(tkitti.read_velodyne_bin(os.path.join(seq, "velodyne", "000001.bin")),
                                  jkitti.read_velodyne_bin(os.path.join(seq, "velodyne", "000001.bin")))


# -- de-skew and data pretreatment -------------------------------------------
def test_adjust_cloud_matches():
    rng = np.random.default_rng(2)
    n = 4096
    az = np.sort(rng.uniform(0, 2 * np.pi, n))
    pts = np.stack([10 * np.cos(az), 10 * np.sin(az), rng.uniform(-2, 2, n)], -1).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    w = np.float32([0.05, -0.02, 0.4])
    v = np.float32([8.0, 0.3, -0.1])
    cfg_j, cfg_t = jsa.DistortionConfig(0.1), tsa.DistortionConfig(0.1)
    out_j = np.asarray(jsa.adjust_cloud(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(w), jnp.asarray(v), cfg_j))
    out_t = _np(tsa.adjust_cloud(torch.from_numpy(pts), torch.from_numpy(mask), torch.from_numpy(w),
                                 torch.from_numpy(v), cfg_t))
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    np.testing.assert_array_equal(out_t[~mask], pts[~mask])


def _pretreat_pair(cfg_kw=None, T=None):
    cfg_kw = cfg_kw or {}
    return (jdp.DataPretreat(jdp.DataPretreatConfig(**cfg_kw), T_lidar_imu=T),
            tdp.DataPretreat(tdp.DataPretreatConfig(**cfg_kw), T_lidar_imu=T, device="cpu"))


def _same_output(oj, ot, points_atol=0.0):
    assert (oj is None) == (ot is None)
    if oj is None:
        return
    assert ot["time"] == oj["time"] and ot["origin"] == oj["origin"]
    np.testing.assert_array_equal(ot["mask"], oj["mask"])
    np.testing.assert_allclose(ot["gnss_pose"], oj["gnss_pose"], atol=1e-6)
    np.testing.assert_allclose(ot["points"], oj["points"], atol=points_atol)


def test_data_pretreat_sync_and_pose():
    """test_components.py::TestDataPretreat::test_sync_and_pose on both, with
    an IMU that turns and a lidar offset from it."""
    T = np.eye(4)
    T[:3, 3] = [1.0, 2.0, 0.5]
    pj, pt = _pretreat_pair(T=T)
    rng = np.random.default_rng(3)
    for t in np.arange(0.0, 0.5, 0.01):
        q = np.array([np.cos(0.2 * t), 0.0, 0.0, np.sin(0.2 * t)])
        for p in (pj, pt):
            p.add_imu(t, q)
            p.add_gnss(t, 48.98 + t * 1e-4, 8.39, 116.0)
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    for t in (0.05, 0.15, 0.333):
        _same_output(pj.process(t, pts), pt.process(t, pts))
    _same_output(pj.process(0.45, pts), pt.process(0.45, pts))


def test_data_pretreat_deskew():
    """adjust_distortion=True: the de-skew on the DataPretreat's device."""
    T = np.eye(4)
    T[:3, 3] = [0.3, -0.2, 1.0]
    pj, pt = _pretreat_pair(dict(adjust_distortion=True), T=T)
    rng = np.random.default_rng(4)
    az = np.sort(rng.uniform(0, 2 * np.pi, 1024))
    pts = np.stack([12 * np.cos(az), 12 * np.sin(az), rng.uniform(-2, 1, 1024)], -1).astype(np.float32)
    mask = rng.uniform(size=1024) > 0.05
    for t in (0.0, 0.1, 0.2):
        for p in (pj, pt):
            p.add_imu(t, [1.0, 0.0, 0.0, 0.0])
            p.add_gnss(t, 48.98, 8.39 + t * 1e-4, 116.0)
            p.add_velocity(t, [10.0, 0.2, 0.0], [0.0, 0.01, 0.3])
    oj, ot = pj.process(0.1, pts, mask), pt.process(0.1, pts, mask)
    _same_output(oj, ot, points_atol=1e-5)
    assert np.abs(ot["points"] - pts).max() > 0.1  # the sweep was de-skewed


def test_data_pretreat_out_of_window_and_interp():
    pj, pt = _pretreat_pair()
    for p in (pj, pt):
        p.add_imu(0.0, [1, 0, 0, 0])
        p.add_gnss(0.0, 48.98, 8.39, 116.0)
        assert p.process(1.0, np.zeros((5, 3), np.float32)) is None
    recs_j = [jdp.StampedQuat(0.0, np.array([1.0, 0, 0, 0])), jdp.StampedQuat(1.0, np.array([-0.999, 0.04, 0, 0]))]
    recs_t = [tdp.StampedQuat(r.time, r.quat) for r in recs_j]
    for t in (-0.5, 0.25, 0.5, 0.9, 2.0):
        np.testing.assert_array_equal(tdp.interp_quat(recs_t, t), jdp.interp_quat(recs_j, t))
    vj = [jdp.StampedVec(0.0, np.array([1.0, 2.0])), jdp.StampedVec(0.4, np.array([3.0, -2.0]))]
    vt = [tdp.StampedVec(r.time, r.vec) for r in vj]
    for t in (-1.0, 0.1, 0.3, 1.0):
        np.testing.assert_array_equal(tdp.interp_vec(vt, t), jdp.interp_vec(vj, t))
    assert tdp.interp_quat([], 0.0) is None and tdp.interp_vec([], 0.0) is None
    T = np.eye(4)
    T[:3, 3] = [1.0, 2.0, 0.5]
    for a, b in zip(tdp.lever_arm_velocity([1.0, 0, 0], [0, 0, 0.3], T),
                    jdp.lever_arm_velocity([1.0, 0, 0], [0, 0, 0.3], T)):
        np.testing.assert_array_equal(a, b)


# -- ICP and the registration factory ----------------------------------------
def make_box_scene(n=3000, seed=0):
    """Points on the faces of a 20x20x4 box — full 6-DoF constraint
    (test_icp.py's scene)."""
    rng = np.random.default_rng(seed)
    per = n // 6
    pts = []
    for ax, val in [(0, -10), (0, 10), (1, -10), (1, 10), (2, 0), (2, 4)]:
        p = rng.uniform(-10, 10, size=(per, 3)).astype(np.float32)
        p[:, 2] = rng.uniform(0, 4, size=per)
        p[:, ax] = val
        pts.append(p)
    return np.concatenate(pts).astype(np.float32)


def make_blob_scene(n_blobs, pts_per_blob, seed):
    """Anisotropic Gaussian blobs (test_torch_ndt.py's make_scene)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-12, 12, size=(n_blobs, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(-2, 4, size=n_blobs)
    pts = []
    for c in centers:
        A = rng.normal(size=(3, 3)) * np.array([0.3, 0.3, 0.05])
        pts.append(c + rng.normal(size=(pts_per_blob, 3)) @ A.astype(np.float32))
    return np.concatenate(pts).astype(np.float32)


def _pose_gap(a, b):
    xi = _np(jse3.se3_log(jnp.asarray(np.linalg.inv(b) @ a, jnp.float32)))
    return float(np.abs(xi).max())


@pytest.mark.parametrize("mode,weighted", [("point_to_point", False), ("point_to_plane", False),
                                           ("point_to_plane", True)])
def test_icp_align_matches(mode, weighted):
    pts = make_box_scene(seed=2)
    kw = dict(mode=mode, grid_dims=(32, 32, 16), max_corr_dist=1.5, chunk=1024)
    cfg_j, cfg_t = jicp.ICPConfig(**kw), ticp.ICPConfig(**kw)
    origin = np.float32([-24.0, -24.0, -12.0])
    tgt_j = jicp.prepare_icp_target(JCloud.from_points(pts), cfg_j, origin=jnp.asarray(origin))
    tgt_t = ticp.prepare_icp_target(TCloud.from_points(pts), cfg_t, origin=origin)
    if mode == "point_to_plane":
        # normals within 1e-3: a point on the box's edge (two near-equal small
        # eigenvalues) turns by 2.3e-4
        np.testing.assert_allclose(_np(tgt_t.normals), np.asarray(tgt_j.normals), atol=1e-3)
    xi = np.float32([0.4, -0.3, 0.15, 0.02, -0.02, 0.04])
    T_true = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    rng = np.random.default_rng(3)
    src = pts[rng.choice(len(pts), 1000, replace=False)] @ np.linalg.inv(T_true)[:3, :3].T + np.linalg.inv(T_true)[:3, 3]
    src = src.astype(np.float32)
    w = np.ones(len(src), np.float32)
    if weighted:  # a dynamic cluster with weight 0 (test_icp.py's static-weight case)
        src = np.concatenate([src, pts[rng.choice(len(pts), 200)] + np.float32([0.8, 0.4, 0.0])])
        w = np.concatenate([w, np.zeros(200, np.float32)])
    res_j = jicp.icp_align(tgt_j, JCloud(points=jnp.asarray(src), mask=jnp.ones(len(src), bool),
                                         weights=jnp.asarray(w)), jnp.eye(4), cfg_j)
    res_t = ticp.icp_align(tgt_t, TCloud(points=torch.from_numpy(src), mask=torch.ones(len(src), dtype=torch.bool),
                                         weights=torch.from_numpy(w)), np.eye(4, dtype=np.float32), cfg_t)
    assert _pose_gap(_np(res_t.pose), np.asarray(res_j.pose)) < REG_TOL
    assert _pose_gap(_np(res_t.pose), T_true) < 0.05
    assert res_t.num_correspondences == int(res_j.num_correspondences)
    assert res_t.converged == bool(res_j.converged)
    assert abs(res_t.iterations - int(res_j.iterations)) <= 1
    assert abs(res_t.fitness - float(res_j.fitness)) <= 1e-4 * max(1.0, float(res_j.fitness))


def test_estimate_normals_matches():
    rng = np.random.default_rng(6)
    p = rng.uniform(-5, 5, size=(500, 3)).astype(np.float32)
    p[:, 2] = 0.05 * p[:, 0]
    origin = np.float32([-16.0, -16.0, -8.0])
    gj = j_build_bucket_grid(JCloud.from_points(p), 2.0, (16, 16, 8), origin=jnp.asarray(origin))
    gt = t_build_bucket_grid(TCloud.from_points(p), 2.0, (16, 16, 8), origin=origin)
    nj, okj = jicp.estimate_normals(JCloud.from_points(p), gj, k=8, radius=2.0, chunk=512)
    nt, okt = ticp.estimate_normals(TCloud.from_points(p), gt, k=8, radius=2.0, chunk=512)
    np.testing.assert_array_equal(_np(okt), np.asarray(okj))
    np.testing.assert_allclose(_np(nt), np.asarray(nj), atol=1e-4)


def test_registration_factory_matches():
    for name, cls in (("NDT", tfac.NDTRegistration), ("NDTMANUAL", tfac.NDTRegistration),
                      ("ICP", tfac.ICPRegistration), ("ICPMANUAL", tfac.ICPRegistration)):
        assert isinstance(tfac.make_registration(name), cls)
    assert tfac.make_registration("ICPMANUAL").cfg.mode == "point_to_point"
    assert tfac.make_registration("ICPPLANE").cfg.mode == "point_to_plane"
    with pytest.raises(ValueError):
        tfac.make_registration("WHAT")

    # NDT on test_torch_ndt.py's blob scene (TestFusedKernel's, well
    # conditioned: the box scene's NDT optimum is flat), ICP on the box scene
    rng = np.random.default_rng(5)
    blobs = make_blob_scene(25, 50, seed=3)
    box = make_box_scene(seed=5)
    ndt_kw = dict(grid_dims=(32, 32, 16), point_chunk=1024, stencil="direct7", max_compact_voxels=2048)
    icp_kw = dict(grid_dims=(48, 48, 16), max_corr_dist=1.0)
    cases = [
        ("NDT", blobs, blobs[rng.permutation(len(blobs))[:1024]] + np.float32([0.25, -0.15, 0.05]),
         JNDTConfig(**ndt_kw), TNDTConfig(**ndt_kw), REG_TOL),
        ("ICP", box, box[::3] + np.float32([0.3, -0.2, 0.05]), jicp.ICPConfig(**icp_kw), ticp.ICPConfig(**icp_kw),
         REG_TOL),
        ("ICPPLANE", box, box[::3] + np.float32([0.3, -0.2, 0.05]), jicp.ICPConfig(mode="point_to_plane", **icp_kw),
         ticp.ICPConfig(mode="point_to_plane", **icp_kw), REG_TOL),
    ]
    for name, pts, src, cfg_j, cfg_t, tol in cases:
        rj, rt = jfac.make_registration(name, config=cfg_j), tfac.make_registration(name, config=cfg_t)
        assert np.isinf(rt.get_fitness_score())
        rj.set_input_target(JCloud.from_points(pts))
        rt.set_input_target(TCloud.from_points(pts))
        pose_j, score_j = rj.scan_match(JCloud.from_points(src), np.eye(4))
        pose_t, score_t = rt.scan_match(TCloud.from_points(src), np.eye(4))
        assert isinstance(pose_t, np.ndarray) and isinstance(score_t, float)
        np.testing.assert_allclose(pose_t, np.asarray(pose_j), atol=tol, err_msg=name)
        assert abs(pose_t[0, 3] + (0.25 if name == "NDT" else 0.3)) < 0.05, name
        np.testing.assert_allclose(score_t, float(score_j), rtol=1e-3, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(rt.get_fitness_score(), rj.get_fitness_score(), rtol=1e-3, atol=1e-5, err_msg=name)


# -- cloud filters ----------------------------------------------------------
def test_cloud_filters_match():
    rng = np.random.default_rng(7)
    pts = rng.uniform(-5, 5, (2000, 3)).astype(np.float32)
    w = rng.uniform(0, 1, 2000).astype(np.float32)
    cj, ct = JCloud.from_points(pts, weights=w), TCloud.from_points(pts, weights=w)
    for kw in (dict(leaf_size=0.7), dict(leaf_size=[0.5, 0.8, 1.1], out_capacity=1500)):
        oj = jcf.make_cloud_filter("voxel", **kw).filter(cj)
        ot = tcf.make_cloud_filter("voxel_filter", **kw).filter(ct)
        np.testing.assert_array_equal(_np(ot.mask), np.asarray(oj.mask))
        np.testing.assert_allclose(_np(ot.points), np.asarray(oj.points), atol=2e-5)
        np.testing.assert_allclose(_np(ot.weights), np.asarray(oj.weights), atol=2e-5)
    bj = jcf.make_cloud_filter("box", origin=[1, 0, 0], size=[4, 6, 3]).filter(cj)
    bt = tcf.make_cloud_filter("box_filter", origin=[1, 0, 0], size=[4, 6, 3]).filter(ct)
    np.testing.assert_array_equal(_np(bt.mask), np.asarray(bj.mask))
    np.testing.assert_array_equal(_np(bt.points), pts)
    assert 0 < int(bt.mask.sum()) < 2000
    for name in ("no", "no_filter", "none"):
        assert tcf.make_cloud_filter(name).filter(ct) is ct
    assert isinstance(tcf.make_cloud_filter("voxel", leaf_size=0.5), tcf.VoxelFilter)
    with pytest.raises(ValueError):
        tcf.make_cloud_filter("bogus")


# -- watchdog and median (test_utils.py's cases on both) ----------------------
def test_streaming_median_matches():
    rng = np.random.default_rng(0)
    vals = rng.normal(size=101)
    mj, mt = JMedian(), TMedian()
    for i, v in enumerate(vals):
        mj.insert(float(v))
        mt.insert(float(v))
        assert mt.median() == mj.median() and len(mt) == len(mj) == i + 1
    assert abs(mt.median() - np.median(vals)) < 1e-12
    even = TMedian()
    for v in [1.0, 2.0, 3.0, 4.0]:
        even.insert(v)
    assert even.median() == 2.5
    with pytest.raises(ValueError):
        TMedian().median()


def test_run_health_matches():
    import time

    out = {}
    for mod in (jwd, twd):
        warns = []
        rh = mod.RunHealth(stage_budget_ms=0.0, max_step_translation=1.0, log=warns.append)
        with rh.stage("track"):
            time.sleep(0.001)
        p1 = np.eye(4)
        p1[:3, 3] = [5.0, 0, 0]
        flags = [rh.frame(np.eye(4)), rh.frame(p1), rh.frame(p1)]
        s = rh.summary()
        out[mod] = (flags, rh.divergences, rh.stages["track"].misses, s["frames"], s["stages"]["track"]["calls"],
                    [w.split(" took")[0] for w in warns[:1]] + warns[1:])
        stall = mod.RunHealth(stall_timeout_s=0.01)
        assert not stall.stalled()
        time.sleep(0.02)
        assert stall.stalled()
    assert out[twd] == out[jwd]
    assert out[twd][0] == [True, False, True]


# -- config -------------------------------------------------------------------
def _drop(d, key):
    return {k: (_drop(v, key) if isinstance(v, dict) else v) for k, v in d.items() if k != key}


# the port's own sections: the A-LOAM front end's settings and the front-end choice, which the JAX CLI
# hard-codes; a file without them gets the defaults, the JAX CLI's settings but for the padded rows
PORT_ONLY = ("aloam", "front_end_method")


def _port_only_defaults(ct):
    from lidar_slam_tpu_torch.pipeline.aloam import AloamConfig

    assert ct.aloam == AloamConfig() and ct.front_end_method == "ndt"
    return {k: v for k, v in dataclasses.asdict(ct).items() if k not in PORT_ONLY}


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_matches(path):
    """Every section's fields equal to the JAX SlamConfig's. The port's
    ScanContextConfig has no `search_ratio` (nothing read it: removed in the
    back-half port), so that one key is dropped from the JAX side; the
    port's own sections (PORT_ONLY) hold their defaults."""
    text = open(path).read()
    assert tconfig.parse_yaml(text) == yaml.safe_load(text)
    cj, ct = jconfig.load_config(path), tconfig.load_config(path)
    assert set(_port_only_defaults(ct)) == set(dataclasses.asdict(cj))
    for f in dataclasses.fields(ct):
        if f.name in PORT_ONLY:
            continue
        a, b = getattr(ct, f.name), getattr(cj, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == _drop(dataclasses.asdict(b), "search_ratio"), f.name
        else:
            assert a == b


def test_yaml_reader_subset():
    cases = [
        "a: 1\nb: [1, 2.5, x, true, ~]\nc:\n  d: true   # comment\n  e: null\n  f:\n    g: -3\nh:\n",
        "x: 1.0e-6\ny: 1e-6\nz: +7\nw: .5\nq: 'it''s # not a comment'\nr: \"s\"\ns: []\nt: [1, 2,]\nu: .inf\nv: yes",
        "# only a comment\n",
        "",
    ]
    for text in cases:
        assert tconfig.parse_yaml(text) == yaml.safe_load(text), text
    for bad in ("a:\n  - 1\n", "a: 0x10", "a: {b: 1}", "a: &x 1", "a: !!str 1", "a: 2001-01-01", "---\na: 1",
                "a: 1\na: 2", "a: [1, [2]]", "a: |\n  x", "a:\n\tb: 1", "a:\n    b: 1\n  c: 2"):
        with pytest.raises(tconfig.YAMLSubsetError):
            tconfig.parse_yaml(bad)


def test_config_errors_and_overrides(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text("front_end:\n  key_frame_distance: 3.5\n  ndt:\n    resolution: 2.0\n    max_iter: 10\n"
                 "back_end:\n  gnss_noise: [1.0, 1.0, 9.0]\n")
    for mod in (tconfig, jconfig):
        cfg = mod.load_config(str(p))
        assert cfg.front_end.key_frame_distance == 3.5 and cfg.front_end.ndt.resolution == 2.0
        assert cfg.front_end.ndt.max_iter == 10 and cfg.back_end.gnss_noise == (1.0, 1.0, 9.0)
        assert cfg.matching.box_size == 200.0
        over = mod.load_config(str(p), overrides={"front_end": {"local_frame_num": 7, "ndt": {"max_iter": 4}},
                                                  "data_dir": "x"})
        assert over.front_end.local_frame_num == 7 and over.front_end.ndt.max_iter == 4
        assert over.front_end.ndt.resolution == 2.0 and over.data_dir == "x"
    bad = tmp_path / "bad.yaml"
    for text in ("front_end:\n  bogus_key: 1\n", "bogus_section:\n  a: 1\n"):
        bad.write_text(text)
        for mod in (tconfig, jconfig):
            with pytest.raises(KeyError):
                mod.load_config(str(bad))
    assert _port_only_defaults(tconfig.load_config()) == _drop(dataclasses.asdict(jconfig.load_config()),
                                                                "search_ratio")


# -- viewer -------------------------------------------------------------------
@pytest.mark.parametrize("map_capacity", [1 << 21, 5000])
def test_viewer_matches(tmp_path, map_capacity):
    """Both viewers over one keyframe store (written once; the stores share
    a file format): the local and global maps, the pose correction, write_pcd
    and save_map's files, at the default map_capacity and at one that cuts
    the joint map. The port's save_map also reports the points the cut
    dropped (map_capacity_dropped; the JAX viewer drops them silently)."""
    rng = np.random.default_rng(8)
    world = SyntheticWorld.corridor(length=30, seed=2)
    gt = make_hairpin_trajectory(n_out=3, n_turn=2, n_back=1, speed=2.0, turn_radius=1.0)
    store_t = tks.KeyframeStore(str(tmp_path / "t"))
    for i in range(len(gt)):
        pts, mask, _ = simulate_scan(world, gt[i], n_points=3000, max_range=20.0, seed=i)
        store_t.save(i, pts, mask, gt[i], time=0.1 * i)
    store_j = jks.KeyframeStore(str(tmp_path / "t"), resume=True)
    cfg = dict(local_frame_num=3, local_map_leaf=0.3, global_map_leaf=0.5, map_capacity=map_capacity)
    offered = sum(int(store_t.load(i)["mask"].sum()) for i in range(len(gt)))
    vj = jviewer.Viewer(jviewer.ViewerConfig(**cfg), store_j)
    vt = tviewer.Viewer(tviewer.ViewerConfig(**cfg), store_t, device="cpu")
    odom = gt.astype(np.float32) @ np.float32([[1, -0.01, 0, 0.05], [0.01, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    for i in range(len(gt)):
        vj.update_with_new_key_frame(i, odom[i])
        vt.update_with_new_key_frame(i, odom[i])
        if i == 3:
            opt = gt[:3].astype(np.float32) + rng.normal(0, 0.01, (3, 4, 4)).astype(np.float32) * [1, 1, 1, 0]
            vj.update_with_optimized_poses(opt)
            vt.update_with_optimized_poses(opt)
    np.testing.assert_array_equal(np.stack(vt.corrected_poses), np.stack(vj.corrected_poses))
    for get in (lambda v: v.get_local_map(), lambda v: v.get_global_map(), lambda v: v.get_global_map(False)):
        a, b = get(vt), get(vj)
        assert a.shape == b.shape and len(a) > 100
        np.testing.assert_allclose(a, b, atol=2e-5)
    pcd_j, pcd_t = tmp_path / "j.pcd", tmp_path / "t.pcd"
    pts = rng.normal(0, 30, (50, 3)).astype(np.float32)
    jviewer.write_pcd(str(pcd_j), pts)
    tviewer.write_pcd(str(pcd_t), pts)
    assert pcd_t.read_text() == pcd_j.read_text()

    out_t = vt.save_map()
    files_t = {f: open(os.path.join(store_t.map_dir, f), "rb").read() for f in sorted(os.listdir(store_t.map_dir))}
    traj_t = np.loadtxt(os.path.join(store_t.traj_dir, "viewer_optimized.txt"))
    out_j = vj.save_map()
    assert out_t.pop("map_capacity_dropped") == max(0, offered - map_capacity)
    assert out_t == out_j
    assert out_j["map_points"] == min(offered, map_capacity)
    assert sorted(files_t) == sorted(os.listdir(store_j.map_dir)) == [
        "filtered_map.npz", "filtered_map.pcd", "map.npz", "map.pcd"]
    for name in ("map", "filtered_map"):
        with np.load(os.path.join(store_j.map_dir, f"{name}.npz")) as z:
            pj = z["points"]
            assert z.files == ["points"]
        pt = np.load(io.BytesIO(files_t[f"{name}.npz"]))["points"]
        np.testing.assert_allclose(pt, pj, atol=2e-5)
        head_t = files_t[f"{name}.pcd"].decode().splitlines()
        head_j = open(os.path.join(store_j.map_dir, f"{name}.pcd")).read().splitlines()
        assert head_t[:11] == head_j[:11] and len(head_t) == len(head_j)
        np.testing.assert_allclose(np.loadtxt(head_t[11:]), np.loadtxt(head_j[11:]), atol=2e-4)
    np.testing.assert_allclose(traj_t, np.loadtxt(os.path.join(store_j.traj_dir, "viewer_optimized.txt")), atol=1e-6)


def test_store_write_is_atomic(tmp_path, monkeypatch):
    """A keyframe record is written to a temporary file and renamed: a write
    cut off midway (a killed run) leaves no truncated record behind, which
    the JAX store's in-place write would (a resumed run then fails to load
    it). Records stay readable by the JAX store."""
    store = tks.KeyframeStore(str(tmp_path))
    pts = np.ones((10, 3), np.float32)
    store.save(0, pts, np.ones(10, bool), np.eye(4), time=0.5)

    def cut_off(file, **arrays):
        file.write(b"PK\x03\x04 partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(tks.np, "savez_compressed", cut_off)
    with pytest.raises(KeyboardInterrupt):
        store.save(1, pts, np.ones(10, bool), np.eye(4), time=0.6)
    monkeypatch.undo()
    assert not os.path.exists(os.path.join(store.kf_dir, "key_frame_1.npz"))
    reopened = jks.KeyframeStore(str(tmp_path), resume=True)
    assert len(reopened) == 1 and len(tks.KeyframeStore(str(tmp_path), resume=True)) == 1
    np.testing.assert_array_equal(reopened.load(0)["points"], pts)
    assert reopened.load(0)["time"] == 0.5
