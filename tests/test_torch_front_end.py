"""Parity of the PyTorch port's front end with the JAX package: keyframe
static weights, the incremental map update, the host FrontEnd and the
scan-chained drive, on the scenes of tests/test_front_end.py.

Scans come from the shared numpy simulator; the JAX side runs on the CPU.
Torch is pinned to one CPU thread while the file runs.
Trajectory tolerance: 2e-2 m, the JAX package's own drive-vs-stepwise
bound (test_front_end.py:92-94) — two implementations whose derivative
sums differ only in float32 summation order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
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
# the branch the card takes: each alignment one ndt_newton call (its plain version on the CPU)
CARD_NDT = dataclasses.replace(CFG_T.ndt, gather="fused")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one CPU thread while this file runs: its default pool made
    these small host-loop ops several times slower under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _eigenvalues64(sums, keys):
    """Eigenvalues (ascending) of each compact row's voxel covariance, in
    float64 from the reference sums."""
    v = np.maximum(keys, 0)
    n = np.maximum(np.asarray(sums.count, np.float64)[v], 1.0)
    rel = np.asarray(sums.psum, np.float64)[v] / n[:, None]
    pp = np.asarray(sums.ppsum, np.float64)[v] / n[:, None]
    i6 = [[0, 1, 2], [1, 3, 4], [2, 4, 5]]
    return np.linalg.eigvalsh(pp[:, i6] - rel[:, :, None] * rel[:, None, :])


def _jax_local_map_on_lattice(monkeypatch):
    """Make the JAX FrontEnd build its rebuilt coarse map with the port's
    corner (coarse_origin): the same sums and keys, looked up where they
    were scattered. The JAX package's own corner makes tracking diverge."""
    build = jfe._build_local_map

    def on_lattice(*args, **kw):
        cloud, fine, coarse = build(*args, **kw)
        if coarse is not None:
            coarse = coarse.replace(
                origin=jnp.asarray(tfe.coarse_origin(np.asarray(fine.origin), coarse.resolution)))
        return cloud, fine, coarse

    monkeypatch.setattr(jfe, "_build_local_map", on_lattice)


def _keyframes(frames, gt, idx, rng):
    """Keyframe records as a store holds them: the sensor-frame points of
    raw scans `idx` with their poses, weights on every other one."""
    recs = []
    for k, i in enumerate(idx):
        pts, mask = frames[i]
        rec = {"points": pts[mask], "pose": gt[i]}
        if k % 2:
            rec["weights"] = rng.uniform(0.2, 1.0, int(mask.sum())).astype(np.float32)
        recs.append(rec)
    return recs


@pytest.mark.parametrize("n_keyframes", [4, 10])
def test_build_local_map_matches_reference(n_keyframes):
    """_build_local_map on a window of downsampled keyframes (4 of 10 slots
    filled: no 0.3 m filter; 10: filtered): the same cloud, the fine and
    coarse maps' keys, index and counts equal to the JAX package's, their
    statistics within 1e-5. The coarse map's corner is the JAX map's rounded
    to the 2 m lattice its sums were scattered on (here z's fine corner,
    -11 m, is odd): every point looks up the cell it was scattered into,
    where from the JAX map's corner about half do not."""
    gt, frames, _, _ = _corridor_frames(n=2 * n_keyframes)
    rng = np.random.default_rng(3)
    k, p = CFG_J.local_frame_num, CFG_J.keyframe_capacity
    kf_p, kf_m = np.zeros((k, p, 3), np.float32), np.zeros((k, p), bool)
    kf_w = np.ones((k, p), np.float32)
    poses, valid = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1)), np.zeros(k, bool)
    for s in range(n_keyframes):
        i = 2 * s
        kf = tfe.voxel_downsample(tfe._preprocess(_t(frames[i][0]), _t(frames[i][1]), 8192, 0.5), 0.5,
                                  out_capacity=p)
        kf_p[s], kf_m[s], poses[s], valid[s] = _np(kf.points), _np(kf.mask), gt[i], True
        kf_w[s] = rng.uniform(0.3, 1.0, p)
    center = gt[2 * n_keyframes - 2][:3, 3]
    cj, mj, cmj = jfe._build_local_map(*(jnp.asarray(a) for a in (kf_p, kf_m, kf_w, poses, valid)),
                                       jnp.int32(n_keyframes), jnp.asarray(center), CFG_J)
    ct, mt, cmt = tfe._build_local_map(_t(kf_p), _t(kf_m), _t(kf_w), poses, valid, n_keyframes, center, CFG_T)
    np.testing.assert_array_equal(_np(ct.mask), np.asarray(cj.mask))
    np.testing.assert_allclose(_np(ct.points), np.asarray(cj.points), atol=1e-5)
    np.testing.assert_allclose(_np(ct.weights), np.asarray(cj.weights), atol=1e-5)
    ccfg = dataclasses.replace(CFG_J.ndt, resolution=2.0, grid_dims=(48, 48, 12))
    np.testing.assert_array_equal(_np(mt.origin), np.asarray(mj.origin))
    np.testing.assert_array_equal(_np(cmt.origin), tfe.coarse_origin(np.asarray(cmj.origin), 2.0))
    assert np.asarray(cmj.origin)[2] % 2.0 == 1.0 and np.all(_np(cmt.origin) % 2.0 == 0.0)
    pts = np.asarray(cj.points)[np.asarray(cj.mask)]
    scattered = np.floor(pts / 2.0) - np.round(np.asarray(cmj.origin) / 2.0)
    assert np.array_equal(np.floor((pts - _np(cmt.origin)) / 2.0), scattered)
    assert 0.2 < np.mean(np.any(np.floor((pts - np.asarray(cmj.origin)) / 2.0) != scattered, axis=1)) < 0.8
    for t, j, c in ((mt, mj, CFG_J.ndt), (cmt, cmj, ccfg)):
        np.testing.assert_array_equal(_np(t.keys), np.asarray(j.keys))
        np.testing.assert_array_equal(_np(t.index), np.asarray(j.index))
        np.testing.assert_array_equal(_np(t.count), np.asarray(j.count))
        tp, jp = _np(t.packed), np.asarray(j.packed)
        np.testing.assert_allclose(tp[:, :4], jp[:, :4], rtol=1e-5, atol=1e-5)  # mean, weight
        np.testing.assert_allclose(_np(t.mean), np.asarray(j.mean), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(t.staticvalue), np.asarray(j.staticvalue), rtol=1e-5, atol=1e-5)
        # the valid flag rests on float32 rounding where the voxel is
        # degenerate (the reference sums name those rows); the inverse
        # covariances are left to the alignments of the front-end tests: on
        # line-like voxels (poles) the closed-form eigenvectors are
        # ill-conditioned in both packages
        sums = jndt.scatter_to_sums(jndt.empty_ndt_sums(j.origin, c), cj.points, cj.mask, cj.weights)
        used = np.asarray(j.keys) >= 0
        ev = _eigenvalues64(sums, np.asarray(j.keys))
        waived = used & (ev[:, 0] <= 1e-4 * ev[:, 2])
        np.testing.assert_array_equal(tp[~waived, 10], jp[~waived, 10])
        assert waived.sum() < 0.5 * used.sum()
    assert int((_np(mt.keys) >= 0).sum()) > 300


def test_rebuilt_map_front_end_matches_reference(monkeypatch):
    """FrontEnd(incremental_map=False), the local map rebuilt from the
    keyframe window at each keyframe (0.3 m filtered from the third on),
    through the card's branch (gather="fused": ndt_newton's plain version
    here): the same keyframe flags as the JAX FrontEnd (its coarse map on
    the port's corner), poses within 5e-3 m."""
    _jax_local_map_on_lattice(monkeypatch)
    gt, frames, _, _ = _corridor_frames()
    kw = dict(incremental_map=False, local_map_filter_min_frames=3)
    fj = jfe.FrontEnd(dataclasses.replace(CFG_J, **kw))
    ft = tfe.FrontEnd(dataclasses.replace(CFG_T, ndt=CARD_NDT, **kw), device="cpu")
    fj.set_init_pose(gt[0])
    ft.set_init_pose(gt[0])
    for i, (pts, mask) in enumerate(frames):
        pj, kj = fj.update(pts, jnp.asarray(mask))
        pt, kt = ft.update(pts, mask)
        assert kt == kj, f"frame {i}"
        np.testing.assert_allclose(pt[:3, 3], pj[:3, 3], atol=5e-3, err_msg=f"frame {i}")
    assert ft.n_keyframes == fj.n_keyframes >= 4 and ft.fine_sums is None and ft.local_map_cloud is not None
    np.testing.assert_allclose(pt[:3, 3], gt[-1][:3, 3], atol=0.35)


@pytest.mark.parametrize("incremental", [True, False])
def test_restore_matches_reference(incremental, monkeypatch):
    """FrontEnd.restore from stored keyframes (tests/test_checkpoint_resume.py's
    resume, through the tracking state), then two updates through the
    card's branch: the same slot cursor, keyframes and map keys as the JAX
    FrontEnd.restore, poses within 2e-2 m, this file's bound (each
    alignment stops once a step is under trans_eps = 1 cm, and the 0.3 m-
    filtered coarse map's degenerate voxels, whose valid flags rest on
    float32 rounding, move where the coarse pass hands over)."""
    _jax_local_map_on_lattice(monkeypatch)
    gt, frames, _, _ = _corridor_frames()
    recs = _keyframes(frames, gt, (0, 2, 4, 6, 7), np.random.default_rng(4))
    cfg = dict(incremental_map=incremental)
    fj = jfe.FrontEnd(dataclasses.replace(CFG_J, **cfg))
    ft = tfe.FrontEnd(dataclasses.replace(CFG_T, ndt=CARD_NDT, **cfg), device="cpu")
    for f in (fj, ft):
        f.restore(recs, total_keyframes=13, last_pose=gt[9], predict_pose=gt[10])
    assert (ft.kf_cursor, ft.n_keyframes) == (fj.kf_cursor, fj.n_keyframes) == (13, 13)
    np.testing.assert_array_equal(ft.kf_valid, fj.kf_valid)
    np.testing.assert_array_equal(_np(ft.kf_masks), np.asarray(fj.kf_masks))
    np.testing.assert_allclose(_np(ft.kf_weights), np.asarray(fj.kf_weights), atol=1e-5)
    np.testing.assert_array_equal(_np(ft.ndt_map.keys), np.asarray(fj.ndt_map.keys))
    np.testing.assert_array_equal(ft.last_pose, gt[9])
    for i in (10, 11):
        pj, kj = fj.update(frames[i][0], jnp.asarray(frames[i][1]))
        pt, kt = ft.update(*frames[i])
        assert kt == kj
        np.testing.assert_allclose(pt[:3, 3], pj[:3, 3], atol=2e-2, err_msg=f"frame {i}")
        assert np.linalg.norm(pt[:3, 3] - gt[i][:3, 3]) < 0.1
