"""Parity of the PyTorch port's front end with the JAX package: keyframe
static weights, the incremental map update, the host FrontEnd and the
scan-chained drive, on the scenes of tests/test_front_end.py.

Scans come from the shared numpy simulator; the JAX side runs on the CPU.
Trajectory tolerance: 2e-2 m, the JAX package's own drive-vs-stepwise
bound (test_front_end.py:92-94) — two implementations whose derivative
sums differ only in float32 summation order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from lidar_slam_tpu.io import SyntheticWorld, make_trajectory, simulate_scan
from lidar_slam_tpu.models.registration import NDTConfig as JNDTConfig
from lidar_slam_tpu.models.registration import ndt as jndt
from lidar_slam_tpu.pipeline import front_end as jfe

from lidar_slam_tpu_torch.models.registration import NDTConfig as TNDTConfig
from lidar_slam_tpu_torch.models.registration import ndt as tndt
from lidar_slam_tpu_torch.pipeline import front_end as tfe

_KW = dict(frame_capacity=8192, keyframe_capacity=8192, local_frame_num=10)
CFG_J = jfe.FrontEndConfig(
    ndt=JNDTConfig(resolution=1.0, grid_dims=(96, 96, 24), point_chunk=2048, max_iter=25, gather="auto"), **_KW
)
CFG_T = tfe.FrontEndConfig(
    ndt=TNDTConfig(resolution=1.0, grid_dims=(96, 96, 24), point_chunk=2048, max_iter=25, gather="auto"), **_KW
)
N_FRAMES = 12


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _corridor_frames(n=N_FRAMES):
    """The TestFrontEndDrive scene (test_front_end.py:61-66)."""
    world = SyntheticWorld.corridor(length=60, seed=5, curve=0.0)
    gt = make_trajectory(n, speed=1.0)
    frames = [
        simulate_scan(world, gt[i], t=i * 0.1, max_range=35.0, n_points=8192, seed=700 + i)[:2]
        for i in range(n)
    ]
    cap = CFG_J.raw_capacity
    pts_seq = np.zeros((n, cap, 3), np.float32)
    msk_seq = np.zeros((n, cap), bool)
    for i, (pts, mask) in enumerate(frames):
        pts_seq[i, : len(pts)] = pts
        msk_seq[i, : len(pts)] = mask
    return gt, frames, pts_seq, msk_seq


def test_bbox_weights():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-15, 15, size=(4096, 3)).astype(np.float32)
    boxes = np.concatenate(
        [rng.uniform(-10, 10, (8, 3)), rng.uniform(2, 6, (8, 3)), rng.uniform(-3, 3, (8, 1)),
         rng.uniform(0, 1, (8, 1))], axis=1,
    ).astype(np.float32)
    boxes_valid = boxes[:, 7] > 0.3
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [1.0, -2.0, 0.5]
    pose[:2, :2] = [[np.cos(0.3), -np.sin(0.3)], [np.sin(0.3), np.cos(0.3)]]
    # map memory: some centres near the current boxes (matches), some far
    centers = boxes[:, :3] @ pose[:3, :3].T + pose[:3, 3]
    map_centers = np.concatenate([centers[:5] + rng.normal(0, 0.8, (5, 3)), rng.uniform(-30, 30, (5, 3))])
    map_descs = np.concatenate([map_centers, rng.uniform(1, 5, (10, 4))], axis=1).astype(np.float32)
    map_centers = map_centers.astype(np.float32)
    map_valid = np.arange(10) != 3
    args = (pts, boxes, boxes_valid, pose, map_centers, map_descs, map_valid)
    wj, dj = jfe._bbox_weights(*(jnp.asarray(a) for a in args), base=5.0 / 12.0, radius=3.3)
    wt, dt = tfe._bbox_weights(*(_t(a) for a in args), base=5.0 / 12.0, radius=3.3)
    np.testing.assert_allclose(_np(wt), np.asarray(wj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(dt), np.asarray(dj), rtol=1e-6, atol=1e-5)
    w = np.asarray(wj)
    assert (w < 1.0).sum() > 50 and (w == 1.0).sum() > 1000


def test_incremental_map_update():
    """Two keyframes through the update (the second one recenters and
    evicts the first), fine and derived coarse maps against JAX."""
    gt, frames, _, _ = _corridor_frames(n=6)
    fine_j = dataclasses.replace(CFG_J.ndt, dense_stats=False)
    fine_t = dataclasses.replace(CFG_T.ndt, dense_stats=False)
    coarse_j, coarse_t = jfe.coarse_tracking_cfg(CFG_J.ndt), tfe.coarse_tracking_cfg(CFG_T.ndt)
    p = 8192
    kfs = []
    for i in (0, 5):
        pts, mask = frames[i]
        kf = tfe.voxel_downsample(
            tfe._preprocess(_t(pts), _t(mask), 8192, 0.5), 0.5, out_capacity=p
        )
        kfs.append((_np(kf.points), _np(kf.mask), gt[i]))
    o0 = tfe.FrontEnd._lattice_origin(gt[0][:3, 3], fine_t, snap_mult=2.0)
    js = (jndt.empty_ndt_sums(jnp.asarray(o0), fine_j), jndt.empty_ndt_sums(jnp.asarray(o0), coarse_j))
    ts = tndt.empty_ndt_sums(o0, fine_t)
    old = (np.zeros((p, 3), np.float32), np.zeros(p, bool), np.ones(p, np.float32))
    w = np.random.default_rng(1).uniform(0.3, 1.0, p).astype(np.float32)
    for k, (kp, km, pose) in enumerate(kfs):
        # the second keyframe moves the window far enough to recenter it
        origin = tfe.FrontEnd._lattice_origin(pose[:3, 3] + np.float32([12.0 * k, 0, 0]), fine_t, snap_mult=2.0)
        args = (*old, kp, km, w, pose, origin, origin)
        oj = jfe._incremental_map_update(*js, *(jnp.asarray(a) for a in args), fine_j, coarse_j)
        ot = tfe._incremental_map_update(ts, *(_t(a) for a in args[:6]), pose, origin, fine_t, coarse_t)
        np.testing.assert_allclose(_np(ot[1]), np.asarray(oj[2]), atol=1e-5)  # world points
        for mt, mj in ((ot[2], oj[3]), (ot[3], oj[4])):
            np.testing.assert_array_equal(_np(mt.origin), np.asarray(mj.origin))
            np.testing.assert_array_equal(_np(mt.keys), np.asarray(mj.keys))
            np.testing.assert_array_equal(_np(mt.index), np.asarray(mj.index))
            np.testing.assert_allclose(_np(mt.packed)[:, :4], np.asarray(mj.packed)[:, :4], atol=1e-4)
            np.testing.assert_array_equal(_np(mt.packed)[:, 10:12], np.asarray(mj.packed)[:, 10:12])
        js, ts = oj[:2], ot[0]
        old = (np.asarray(oj[2]), km, w)  # evict this keyframe next time
    assert np.count_nonzero(np.asarray(js[0].count)) > 1000


def test_front_end_matches_reference():
    """FrontEnd.update, frame by frame: same keyframe flags, poses within
    2e-2 m of the JAX FrontEnd."""
    gt, frames, _, _ = _corridor_frames()
    fj = jfe.FrontEnd(CFG_J)
    ft = tfe.FrontEnd(CFG_T, device="cpu")
    fj.set_init_pose(gt[0])
    ft.set_init_pose(gt[0])
    for i, (pts, mask) in enumerate(frames):
        pj, kj = fj.update(pts, jnp.asarray(mask))
        pt, kt = ft.update(pts, mask)
        assert kt == kj, f"frame {i}"
        np.testing.assert_allclose(pt[:3, 3], pj[:3, 3], atol=2e-2, err_msg=f"frame {i}")
    assert ft.n_keyframes == fj.n_keyframes >= 4
    np.testing.assert_allclose(pt[:3, 3], gt[-1][:3, 3], atol=0.35)


def test_front_end_drive_matches_reference():
    """front_end_drive over the same sequence: keyframe flags equal to the
    JAX drive's, poses within 2e-2 m; and the input state is untouched."""
    gt, _, pts_seq, msk_seq = _corridor_frames()
    st_j = jfe.init_front_end_drive(CFG_J, init_pose=gt[0])
    _, pj, kj, uj = jfe.front_end_drive(st_j, jnp.asarray(pts_seq), jnp.asarray(msk_seq), CFG_J)
    st_t = tfe.init_front_end_drive(CFG_T, init_pose=gt[0], device="cpu")
    world0 = st_t.kf_world.clone()
    out_t, pt, kt, ut = tfe.front_end_drive(st_t, _t(pts_seq), _t(msk_seq), CFG_T)
    assert _np(kt).tolist() == np.asarray(kj).tolist()
    assert float(ut.max()) == 0.0 and float(np.max(np.asarray(uj))) == 0.0
    np.testing.assert_allclose(_np(pt)[:, :3, 3], np.asarray(pj)[:, :3, 3], atol=2e-2)
    assert out_t.n_keyframes == int(np.asarray(kj).sum())
    assert torch.equal(st_t.kf_world, world0) and st_t.n_keyframes == 0


def _convoy_sequence(n=8):
    """The pacing-convoy world of test_front_end.py:97-124, cut to n frames."""
    world = SyntheticWorld.corridor(length=90, seed=3, curve=0.0, density=5.0, n_poles=8, width=12.0)
    for x0, y0 in [(26.0, 2.8), (30.0, -2.8), (34.0, 2.8), (38.0, -2.8)]:
        world.add_moving_box([x0, y0, 1.5], [10.0, 2.5, 3.0], 0.0, [0.7, 0.0], n_points=3000)
    gt = make_trajectory(n, speed=1.0)
    cap, nb_max = CFG_J.raw_capacity, CFG_J.max_bboxes
    pts_seq = np.zeros((n, cap, 3), np.float32)
    msk_seq = np.zeros((n, cap), bool)
    box_seq = np.zeros((n, nb_max, 8), np.float32)
    bok_seq = np.zeros((n, nb_max), bool)
    for i in range(n):
        pts, mask, bboxes = simulate_scan(world, gt[i], t=float(i), max_range=25.0, n_points=8192, seed=900 + i)
        pts_seq[i, : len(pts)] = pts
        msk_seq[i, : len(pts)] = mask
        box_seq[i, : len(bboxes)] = bboxes
        bok_seq[i, : len(bboxes)] = True
    return gt, pts_seq, msk_seq, box_seq, bok_seq


def test_weighted_front_end_matches_reference():
    """FrontEnd.update with detector boxes: keyframe weights, the bbox
    memory ring and the poses against the JAX FrontEnd."""
    n = 6
    gt, pts_seq, msk_seq, box_seq, bok_seq = _convoy_sequence(n)
    fj = jfe.FrontEnd(CFG_J)
    ft = tfe.FrontEnd(CFG_T, device="cpu")
    fj.set_init_pose(gt[0])
    ft.set_init_pose(gt[0])
    for i in range(n):
        boxes = box_seq[i, : int(bok_seq[i].sum())]
        pj, kj = fj.update(pts_seq[i], jnp.asarray(msk_seq[i]), bboxes=boxes)
        pt, kt = ft.update(pts_seq[i], msk_seq[i], bboxes=boxes)
        assert kt == kj, f"frame {i}"
        np.testing.assert_allclose(pt[:3, 3], pj[:3, 3], atol=2e-2, err_msg=f"frame {i}")
    assert ft.map_bbox_cursor == fj.map_bbox_cursor > 0
    np.testing.assert_array_equal(ft.map_bbox_valid, fj.map_bbox_valid)
    np.testing.assert_allclose(_np(ft.map_bbox_descs), np.asarray(fj.map_bbox_descs), atol=2e-2)
    np.testing.assert_allclose(_np(ft.kf_weights), np.asarray(fj.kf_weights), atol=1e-3)
    assert (_np(ft.kf_weights)[_np(ft.kf_masks)] < 0.5).sum() > 100


def test_weighted_drive_matches_reference():
    """The bbox path of the drive (static weighting from the first keyframe
    and the bbox memory ring) on the pacing-convoy world, 8 frames."""
    n = 8
    gt, pts_seq, msk_seq, box_seq, bok_seq = _convoy_sequence(n)
    st_j = jfe.init_front_end_drive(CFG_J, init_pose=gt[0])
    sj, pj, kj, _ = jfe.front_end_drive(
        st_j, jnp.asarray(pts_seq), jnp.asarray(msk_seq), CFG_J, jnp.asarray(box_seq), jnp.asarray(bok_seq)
    )
    st_t = tfe.init_front_end_drive(CFG_T, init_pose=gt[0], device="cpu")
    stt, pt, kt, _ = tfe.front_end_drive(st_t, _t(pts_seq), _t(msk_seq), CFG_T, _t(box_seq), _t(bok_seq))
    assert _np(kt).tolist() == np.asarray(kj).tolist()
    np.testing.assert_allclose(_np(pt)[:, :3, 3], np.asarray(pj)[:, :3, 3], atol=2e-2)
    assert int(stt.map_bbox_cursor) == int(sj.map_bbox_cursor) > 0
    np.testing.assert_array_equal(_np(stt.map_bbox_valid), np.asarray(sj.map_bbox_valid))
    np.testing.assert_allclose(_np(stt.map_bbox_centers), np.asarray(sj.map_bbox_centers), atol=2e-2)
    # the keyframe weights (static weighting) reached the map's statistics
    np.testing.assert_allclose(_np(stt.kf_weights), np.asarray(sj.kf_weights), atol=1e-3)
    assert (_np(stt.kf_weights) < 0.5).sum() > 100
