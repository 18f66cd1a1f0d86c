"""Parity of the PyTorch port's map-matching localization with the JAX
package: the yaw-init height map and yaw search, Matching in both
initialization modes, matching_drive, and the config converter.

The scene is tests/test_slam_pipeline.py::TestMatchingLocalization's,
cut to size: a corridor world whose own points stand in for the viewer's
map (as bench.py's matching_leg does), 8 192-point raw scans, a 64 x 64 x 16
NDT grid under a 60 m crop box, a 64 x 64 height map. The port aligns with
gather="fused", the branch the card takes (on the CPU, ndt_newton's plain
version); the JAX package aligns with its own CPU path. Poses within 5e-3 m
of the JAX package's. Torch is pinned to one CPU thread while the file runs
(its default pool makes these small ops slower under the test workers).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.io import SyntheticWorld, make_trajectory, simulate_scan
from lidar_slam_tpu.models.registration import NDTConfig as JNDTConfig
from lidar_slam_tpu.pipeline import front_end as jfe
from lidar_slam_tpu.pipeline import matching as jm

from lidar_slam_tpu_torch import convert
from lidar_slam_tpu_torch.models.registration import NDTConfig as TNDTConfig
from lidar_slam_tpu_torch.ops import PointCloud as TCloud
from lidar_slam_tpu_torch.pipeline import front_end as tfe
from lidar_slam_tpu_torch.pipeline import matching as tm

_NDT = dict(resolution=1.0, grid_dims=(64, 64, 16), point_chunk=2048, max_iter=25)
_KW = dict(box_size=60.0, refresh_margin=26.0, local_map_capacity=1 << 15, frame_capacity=4096,
           raw_capacity=8192, height_map_dim=64)
CFG_J = jm.MatchingConfig(ndt=JNDTConfig(**_NDT, gather="auto"), **_KW)
CFG_T = tm.MatchingConfig(ndt=TNDTConfig(**_NDT, gather="fused"), **_KW)
N_FRAMES = 9
POSE_TOL = 5e-3


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    world = SyntheticWorld.corridor(length=60, width=14, seed=5, density=20)
    gt = make_trajectory(N_FRAMES, speed=1.0)
    frames = [simulate_scan(world, gt[i], t=i * 0.1, max_range=35.0, n_points=8192, seed=700 + i)[:2]
              for i in range(N_FRAMES)]
    return world.points, gt, frames


@pytest.fixture(scope="module")
def matchers(scene):
    gmap, _, _ = scene
    return jm.Matching(CFG_J, gmap), tm.Matching(CFG_T, gmap, device="cpu")


def test_configs_round_trip():
    """Both packages' MatchingConfig() and FrontEndConfig(), and this file's
    configs, carried across by convert.config_from_fields (nested ndt)."""
    for j, t in ((jm.MatchingConfig(), tm.MatchingConfig()), (jfe.FrontEndConfig(), tfe.FrontEndConfig()),
                 (CFG_J, dataclasses.replace(CFG_T, ndt=dataclasses.replace(CFG_T.ndt, gather="auto")))):
        assert convert.config_from_fields(type(t), dataclasses.asdict(j)) == t
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_height_map_and_yaw_search(matchers, scene):
    """_height_map over the local map and _yaw_search of one frame against
    it, on the same inputs: the height map to float32 rounding, the same
    best yaw and the 270 scores within 1e-4 relative."""
    mj, mt = matchers
    _, gt, frames = scene
    cloud = mt._local_cloud
    pos = np.asarray(gt[4][:3, 3], np.float32)
    origin = np.asarray(pos[:2] - 64 * 0.8 / 2.0, np.float32)
    hj = jm._height_map(jnp.asarray(_np(cloud.points)), jnp.asarray(_np(cloud.mask)), jnp.asarray(origin), 64, 0.8)
    ht = tm._height_map(cloud.points, cloud.mask, torch.as_tensor(origin), 64, 0.8)
    np.testing.assert_array_equal(_np(ht[2]), np.asarray(hj[2]))
    for a, b in zip(ht[:2], hj[:2]):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    assert 300 < int(_np(ht[2]).sum()) < 64 * 64

    scan = tm._frame(torch.as_tensor(frames[4][0]), torch.as_tensor(frames[4][1]), CFG_T)
    args = (pos, *(_np(h) for h in ht), origin)
    yj, sj = jm._yaw_search(jnp.asarray(_np(scan.points)), jnp.asarray(_np(scan.mask)),
                            *(jnp.asarray(a) for a in args), 64, 0.8, 270)
    yt, st = tm._yaw_search(scan.points, scan.mask, *(torch.as_tensor(a) for a in args), 64, 0.8, 270)
    assert float(yt) == float(yj) and int(torch.argmax(st)) == int(np.argmax(np.asarray(sj)))
    np.testing.assert_allclose(_np(st), np.asarray(sj), rtol=1e-4, atol=1e-4 * float(np.max(np.asarray(sj))))
    assert abs((float(yt) + np.pi) % (2 * np.pi) - np.pi) < 0.1


def test_full_pose_matches_reference(matchers, scene):
    """FullPose initialization at frame 1, then update over frames 2-8:
    poses within 5e-3 m of the JAX Matching, within 0.1 m of the truth, and
    the local map re-cropped around the same place by both."""
    mj, mt = matchers
    _, gt, frames = scene
    assert mt.crop_points == int(np.all(np.abs(scene[0]) <= CFG_T.box_size / 2, axis=1).sum()) < 1 << 15
    assert mt.update(*frames[0]) is None  # uninitialized: the scan is buffered
    assert mj.set_gnss_pose(gt[1]) and mt.set_gnss_pose(gt[1])
    for i in range(2, N_FRAMES):
        pj = mj.update(frames[i][0], jnp.asarray(frames[i][1]))
        pt = mt.update(*frames[i])
        np.testing.assert_allclose(pt[:3, 3], pj[:3, 3], atol=POSE_TOL, err_msg=f"frame {i}")
        np.testing.assert_allclose(pt[:3, :3], pj[:3, :3], atol=POSE_TOL, err_msg=f"frame {i}")
        assert np.linalg.norm(pt[:3, 3] - gt[i][:3, 3]) < 0.1, f"frame {i}"
    assert mt.local_map_origin[0] > 3.0  # refreshed on the way
    np.testing.assert_allclose(mt.local_map_origin, mj.local_map_origin, atol=POSE_TOL)


def test_matching_drive_matches_reference(matchers, scene):
    """matching_drive from the truth at frame 3 over frames 4-8 against the
    same maps: poses within 5e-3 m of the JAX drive's, no unresolved terms;
    and equal to the port's stepwise _match_step from the same guesses."""
    mj, mt = matchers
    _, gt, frames = scene
    center = np.asarray(gt[3][:3, 3], np.float32)
    mj.reset_local_map(center)
    mt.reset_local_map(center)
    pts = np.stack([f[0] for f in frames[4:]])
    msk = np.stack([f[1] for f in frames[4:]])
    cj, ct = mj._coarse_cfg(), mt._coarse_cfg()
    pj, uj = jm.matching_drive(mj.ndt_map, mj.coarse_ndt_map, jnp.asarray(pts), jnp.asarray(msk),
                               jnp.asarray(gt[3]), CFG_J, cj)
    pt, ut = tm.matching_drive(mt.ndt_map, mt.coarse_ndt_map, torch.as_tensor(pts), torch.as_tensor(msk),
                               gt[3], CFG_T, ct)
    np.testing.assert_allclose(_np(pt)[:, :3, 3], np.asarray(pj)[:, :3, 3], atol=POSE_TOL)
    assert float(ut.max()) == 0.0 == float(np.max(np.asarray(uj)))
    err = np.linalg.norm(_np(pt)[:, :3, 3] - gt[4:, :3, 3], axis=1)
    assert err.mean() < 0.1, err
    cur, step = torch.as_tensor(gt[3]), torch.eye(4)
    for k in range(len(pts)):
        _, _, pose, _ = tm._match_step(mt.ndt_map, mt.coarse_ndt_map, torch.as_tensor(pts[k]),
                                       torch.as_tensor(msk[k]), cur @ step, CFG_T, ct)
        np.testing.assert_array_equal(_np(pose), _np(pt[k]))
        step, cur = torch.linalg.solve(cur, pose), pose


def test_only_position_init_matches_reference(scene):
    """OnlyPosition initialization (test_slam_pipeline.py::TestMatchingLocalization::
    test_yaw_init_only_position, cut to size): the first update buffers
    the scan, two set_gnss_pose calls at the true position agree, and both
    packages take the same yaw, within 0.1 rad of the truth."""
    gmap, gt, frames = scene
    mj = jm.Matching(dataclasses.replace(CFG_J, init_mode="only_position"), gmap)
    mt = tm.Matching(dataclasses.replace(CFG_T, init_mode="only_position"), gmap, device="cpu")
    assert mj.update(frames[5][0], jnp.asarray(frames[5][1])) is None and mt.update(*frames[5]) is None
    pos = gt[5][:3, 3]
    assert [mt.set_gnss_pose(pos), mt.set_gnss_pose(pos)] == [mj.set_gnss_pose(pos), mj.set_gnss_pose(pos)]
    assert mt.has_inited() and mj.has_inited()
    np.testing.assert_allclose(mt.current_pose, mj.current_pose, atol=1e-6)
    yaw = np.arctan2(mt.current_pose[1, 0], mt.current_pose[0, 0])
    assert abs((yaw - np.arctan2(gt[5][1, 0], gt[5][0, 0]) + np.pi) % (2 * np.pi) - np.pi) < 0.1


def test_update_raises_on_unresolved(scene, monkeypatch):
    """Matching.update has no exact-path redo: were an alignment ever to
    report dropped derivative terms, the frame raises, after the two
    alignments and no third."""
    gmap, gt, frames = scene
    m = tm.Matching(CFG_T, gmap, device="cpu")
    m.set_gnss_pose(gt[1])
    calls = []
    align = tm.ndt_align

    def dropping(*a, **k):
        calls.append(a[3].gather)
        return dataclasses.replace(align(*a, **k), unresolved=1.0)

    monkeypatch.setattr(tm, "ndt_align", dropping)
    with pytest.raises(RuntimeError, match="unresolved"):
        m.update(*frames[2])
    assert calls == ["fused", "fused"]
    np.testing.assert_array_equal(m.current_pose, gt[1])


def test_box_cropped_map_order_and_truncation(scene):
    """The crop keeps the first local_map_capacity points inside the box
    and drops the rest, as the JAX package does (pipeline/matching.py:197):
    the local map is the downsample of exactly those points, and
    crop_points reports how many the box held, so a caller can see the
    cut."""
    gmap, _, _ = scene
    cfg = dataclasses.replace(CFG_T, local_map_capacity=2048)
    m = tm.Matching(cfg, gmap, device="cpu")
    inside = np.all(np.abs(gmap) <= cfg.box_size / 2, axis=1)
    assert m.crop_points == int(inside.sum()) > 2048
    ref = tm.voxel_downsample(TCloud.from_points(gmap[inside][:2048]), cfg.local_map_leaf, out_capacity=2048)
    np.testing.assert_array_equal(_np(m._local_cloud.mask), _np(ref.mask))
    np.testing.assert_array_equal(_np(m._local_cloud.points), _np(ref.points))
