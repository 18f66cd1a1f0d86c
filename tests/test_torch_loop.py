"""Parity of the port's Scan Context, point-NN fitness and loop closing with
the JAX package.

Inputs come from the port's and the JAX package's identical synthetic
generators (seeded numpy). Scan Context descriptors are max-heights, exact
on both sides, and retrieval returns the same index and shift. The fitness
agrees to float32 rounding (rtol 1e-5). `LoopClosing` runs on
test_loop_closing.py's hairpin (the same world, trajectory and
configuration; the keyframe records are stored padded to the scan size with
their mask, so the JAX verification compiles once). A candidate's
verification does not feed back into detection (`update` resets its skip
counter on any candidate), so both packages drive the whole hairpin with
verification recorded, not run: the same candidates, yaw hints and
counters. Then both verify every candidate of the return leg: the same
accepted pairs, fitness within 1e-4, relative poses within 5e-3 (the NDT
alignment parity tolerance of test_torch_ndt.py::test_align_parity). The
turn's candidates, which both reject at three attempts each, are not
re-verified; the false pair holds rejection on both packages. The config's
gather="auto" takes the host Newton loop on the CPU; with gather="fused"
the port verifies as it does on the card (ndt_newton, here its plain
version, the pose read off its result and the fitness at that pose), and
the return leg is verified that way too, against the same JAX loops.
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.geom.se3 import euler_xyz_to_matrix
from lidar_slam_tpu.io import SyntheticWorld, make_hairpin_trajectory, make_trajectory, simulate_scan
from lidar_slam_tpu.io.keyframe_store import KeyframeStore as JStore
from lidar_slam_tpu.models import scan_context as jsc
from lidar_slam_tpu.models.registration import NDTConfig as JNDTConfig
from lidar_slam_tpu.models.registration import point_nn_fitness_score as j_fitness
from lidar_slam_tpu.ops import PointCloud as JCloud
from lidar_slam_tpu.pipeline import loop_closing as jlc

from lidar_slam_tpu_torch import convert
from lidar_slam_tpu_torch.io import KeyframeStore as TStore
from lidar_slam_tpu_torch.models import scan_context as tsc
from lidar_slam_tpu_torch.models.registration import NDTConfig as TNDTConfig
from lidar_slam_tpu_torch.models.registration import point_nn_fitness_score as t_fitness
from lidar_slam_tpu_torch.ops import PointCloud as TCloud
from lidar_slam_tpu_torch.pipeline import loop_closing as tlc

REL_POSE_ATOL = 5e-3
N_OUT, N_TURN = 10, 12  # test_loop_closing.py's hairpin: the return leg starts at frame 22
FITNESS_ATOL = 1e-4
CFG_J = jsc.ScanContextConfig(num_exclude_recent=5)
CFG_T = tsc.ScanContextConfig(num_exclude_recent=5)


def _scan(world, pose, seed):
    pts, mask, _ = simulate_scan(world, pose, n_points=8192, max_range=70.0, seed=seed)
    return pts, mask


def _desc_pair(pts, mask):
    j = np.asarray(jsc.make_scancontext(jnp.asarray(pts), jnp.asarray(mask), CFG_J))
    t = tsc.make_scancontext(torch.as_tensor(pts), torch.as_tensor(mask), CFG_T)
    return j, t


class TestScanContext:
    def test_descriptor_and_keys(self):
        world = SyntheticWorld.corridor(length=60, seed=0)
        pts, mask = _scan(world, make_trajectory(1)[0], 1)
        mask[::7] = False
        j, t = _desc_pair(pts, mask)
        np.testing.assert_array_equal(t.numpy(), j)
        assert (j > 0).sum() > 50
        np.testing.assert_allclose(tsc.ring_key(t).numpy(), np.asarray(jsc.ring_key(jnp.asarray(j))), rtol=1e-6)
        np.testing.assert_allclose(tsc.sector_key(t).numpy(), np.asarray(jsc.sector_key(jnp.asarray(j))), rtol=1e-6)

    def test_distance_and_shift(self):
        """A yaw-rotated scan of one place and a scan of another: the same
        distance (atol 1e-6) and best shift."""
        world = SyntheticWorld.corridor(length=120, seed=2)
        poses = make_trajectory(60, speed=2.0)
        pts, mask = _scan(world, poses[2], 3)
        yaw = np.deg2rad(60.0)
        R = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]], np.float32)
        a_j, a_t = _desc_pair(pts, mask)
        shifts = []
        for other in ((pts @ R.T).astype(np.float32), _scan(world, poses[50], 4)[0]):
            b_j, b_t = _desc_pair(other, mask)
            dj, sj = jsc.sc_distance(jnp.asarray(a_j), jnp.asarray(b_j))
            dt, st = tsc.sc_distance(a_t, b_t)
            np.testing.assert_allclose(float(dt), float(dj), atol=1e-6)
            assert int(st) == int(sj)
            shifts.append(int(st))
        assert min(abs(shifts[0] - 10), abs(shifts[0] - 50)) <= 1  # 60 degrees = 10 sectors

    def test_detect_loop_takes_ties_lowest_index_first(self):
        """A history with repeated descriptors (equal ring-key distances
        around the top-k cut and at the best distance): the same index,
        distance and shift as lax.top_k's order gives."""
        world = SyntheticWorld.corridor(length=60, seed=3)
        fwd = make_trajectory(12, speed=2.0)
        descs = [_desc_pair(*_scan(world, fwd[i], 10 + i))[0] for i in range(6)]
        hist = np.stack([descs[k] for k in (3, 1, 1, 4, 0, 0, 2, 0, 5, 5, 3, 0, 4, 1)]).astype(np.float32)
        query = descs[0].copy()
        valid = np.arange(len(hist)) < 12
        for k in (3, 4, 10):
            cj = dataclasses.replace(CFG_J, num_candidates=k)
            ct = dataclasses.replace(CFG_T, num_candidates=k)
            j = jsc.detect_loop(jnp.asarray(query), jsc.ring_key(jnp.asarray(query)), jnp.asarray(hist),
                                jsc.ring_key(jnp.asarray(hist)), jnp.asarray(valid), cj)
            q = torch.as_tensor(query)
            t = tsc.detect_loop(q, tsc.ring_key(q), torch.as_tensor(hist), tsc.ring_key(torch.as_tensor(hist)),
                                torch.as_tensor(valid), ct)
            assert int(t[0]) == int(j[0]) == 4  # the first of the equal rows
            assert float(t[1]) == pytest.approx(float(j[1]), abs=1e-6)
            assert int(t[2]) == int(j[2])

    def test_manager_retrieval_and_carry_across(self):
        """Both managers over the same drive and revisit: the same detect()
        after every add; the JAX history converted to the port detects the
        same; the port's history grows by doubling."""
        world = SyntheticWorld.corridor(length=60, seed=3)
        fwd = make_trajectory(12, speed=2.0)
        mj = jsc.SCManager(CFG_J, capacity=64)
        mt = tsc.SCManager(CFG_T, capacity=4, device="cpu")
        scans = [_scan(world, fwd[i], 10 + i) for i in range(12)] + [_scan(world, fwd[0], 99)]
        for pts, mask in scans:
            mj.add(pts, mask)
            mt.add(pts, mask)
            (ij, dj, yj), (it, dt, yt) = mj.detect(), mt.detect()
            assert it == ij and yt == pytest.approx(yj, abs=1e-9)
            assert dt == pytest.approx(dj, abs=1e-6) or dt == dj == float("inf")
        assert it == 0 and dt < 0.05  # the revisit of frame 0
        assert mt.capacity == 16 and mt.count == 13
        np.testing.assert_array_equal(mt.descs[:13], mj.descs[:13])
        np.testing.assert_allclose(mt.ring_keys, np.asarray(mj._rk_dev[:13]), rtol=1e-6)
        mc = convert.sc_manager_from_numpy(mj.descs, mj.count, CFG_T, device="cpu")
        assert mc.count == 13 and mc.detect() == mt.detect()


def test_fitness_matches_reference():
    """Masked clouds near the origin (the |q|^2 - 2 q.t + |t|^2 form loses
    float32 digits far from it): rtol 1e-5 against the JAX package, and 1e-4
    against a float64 brute force; a chunk that does not divide the target."""
    rng = np.random.default_rng(0)
    tgt = rng.uniform(-6, 6, size=(3000, 3)).astype(np.float32)
    src = (tgt[rng.choice(3000, 900, replace=False)] + rng.normal(0, 0.05, (900, 3))).astype(np.float32)
    src[:40] += 5.0  # some beyond max_radius of every target: clamped
    tm, sm = rng.random(3000) < 0.9, rng.random(900) < 0.95
    pose = np.asarray(euler_xyz_to_matrix(jnp.float32(0.01), jnp.float32(-0.02), jnp.float32(0.03)))
    pose = np.array(pose, np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = pose
    T[:3, 3] = [0.05, -0.03, 0.02]
    for chunk in (2048, 700):
        j = float(j_fitness(JCloud(points=jnp.asarray(tgt), mask=jnp.asarray(tm)),
                            JCloud(points=jnp.asarray(src), mask=jnp.asarray(sm)), jnp.asarray(T), chunk=chunk))
        t = t_fitness(TCloud(points=torch.as_tensor(tgt), mask=torch.as_tensor(tm)),
                      TCloud(points=torch.as_tensor(src), mask=torch.as_tensor(sm)), T, chunk=chunk)
        assert t.shape == () and t.dtype == torch.float32
        np.testing.assert_allclose(float(t), j, rtol=1e-5)
    xp = src[sm].astype(np.float64) @ T[:3, :3].T.astype(np.float64) + T[:3, 3]
    d2 = ((xp[:, None, :] - tgt[tm][None].astype(np.float64)) ** 2).sum(-1).min(1)
    np.testing.assert_allclose(float(t), np.minimum(d2, 4.0).mean(), rtol=1e-4)


def _loop_configs():
    kw = dict(loop_step=1, diff_num=12, extend_frame_num=2, submap_capacity=32768, scan_capacity=8192)
    ndt = dict(resolution=1.0, grid_dims=(96, 96, 24), point_chunk=2048, max_iter=25)
    return (jlc.LoopClosingConfig(ndt=JNDTConfig(**ndt), sc=jsc.ScanContextConfig(num_exclude_recent=12), **kw),
            tlc.LoopClosingConfig(ndt=TNDTConfig(**ndt), sc=tsc.ScanContextConfig(num_exclude_recent=12), **kw))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch's small CPU ops run faster on one thread than on a pool that
    parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hairpin(tmp_path_factory):
    """test_loop_closing.py's hairpin drive through both packages'
    LoopClosing over one keyframe store, written by the JAX package and read
    by each package's own KeyframeStore, with each verification recorded as
    a candidate (index0, index1, yaw hint) instead of run."""
    root = str(tmp_path_factory.mktemp("loop_kf"))
    world = SyntheticWorld.corridor(length=50.0, width=14.0, density=25.0, seed=9)
    gt = make_hairpin_trajectory(n_out=N_OUT, n_turn=N_TURN, n_back=8, speed=1.0, turn_radius=1.0)
    store = JStore(root)
    for i in range(len(gt)):
        pts, mask, _ = simulate_scan(world, gt[i], t=i * 0.1, max_range=40.0, n_points=8192, seed=900 + i)
        store.save(i, pts, mask, gt[i], time=i * 0.1)
    cfg_j, cfg_t = _loop_configs()
    lj = jlc.LoopClosing(cfg_j, store)
    lt = tlc.LoopClosing(cfg_t, TStore(root, resume=True), device="cpu")
    cands = {}
    for lc in (lj, lt):
        cands[lc] = []
        lc._verify = lambda i0, i1, yaw, c=cands[lc]: c.append((i0, i1, yaw))
        for i in range(len(gt)):
            assert lc.update(i, gt[i]) is None
        del lc._verify  # the class's own from here on
    return gt, lj, lt, cands[lj], cands[lt]


@pytest.fixture(scope="module")
def return_leg_loops(hairpin):
    """Both packages' verification of every candidate of the return leg."""
    _, lj, lt, cands, _ = hairpin
    back = [c for c in cands if c[1] >= N_OUT + N_TURN]
    return back, [lj._verify(*c) for c in back], [lt._verify(*c) for c in back]


@pytest.fixture(scope="module")
def card_branch(hairpin):
    """The port's LoopClosing of `hairpin` with gather="fused": the
    verification branch the card takes."""
    lf = copy.copy(hairpin[2])
    lf.cfg = dataclasses.replace(lf.cfg, ndt=dataclasses.replace(lf.cfg.ndt, gather="fused"))
    assert tlc.takes_newton_kernel(dataclasses.replace(lf.cfg.ndt, dense_stats=False), torch.device("cpu"))
    return lf


class TestLoopClosing:
    def test_same_candidates_as_reference(self, hairpin):
        _, lj, lt, cands_j, cands_t = hairpin
        assert [c[:2] for c in cands_t] == [c[:2] for c in cands_j]
        np.testing.assert_allclose([c[2] for c in cands_t], [c[2] for c in cands_j], atol=1e-9)
        assert any(c[1] < N_OUT + N_TURN for c in cands_t)  # the turn's candidates are there too
        assert (lt._skip_cnt, lt._skip_num) == (lj._skip_cnt, lj._skip_num)
        np.testing.assert_array_equal(lt.sc.descs[: lt.sc.count], lj.sc.descs[: lj.sc.count])

    def test_same_loops_as_reference(self, hairpin, return_leg_loops):
        gt = hairpin[0]
        back, loops_j, loops_t = return_leg_loops
        assert len(back) >= 3
        assert [l is None for l in loops_t] == [l is None for l in loops_j]
        loops_t = [l for l in loops_t if l is not None]
        loops_j = [l for l in loops_j if l is not None]
        assert loops_t and all(l.fitness <= 0.2 for l in loops_t)
        for a, b in zip(loops_t, loops_j):
            assert (a.index0, a.index1) == (b.index0, b.index1)
            assert a.fitness == pytest.approx(b.fitness, abs=FITNESS_ATOL)
            np.testing.assert_allclose(a.relative_pose, b.relative_pose, atol=REL_POSE_ATOL)
        lp = loops_t[0]
        rel_gt = np.linalg.inv(gt[lp.index0]) @ gt[lp.index1]
        assert lp.index1 - lp.index0 >= 12
        assert np.linalg.norm(lp.relative_pose[:3, 3] - rel_gt[:3, 3]) < 0.2

    def test_card_branch_same_loops_as_reference(self, card_branch, return_leg_loops, monkeypatch):
        """The return leg verified through ndt_newton (one call an attempt):
        the same accepted pairs as JAX, fitness within FITNESS_ATOL,
        relative poses within REL_POSE_ATOL."""
        calls = []
        align = tlc.ndt_newton_align
        monkeypatch.setattr(tlc, "ndt_newton_align", lambda *a: calls.append(1) or align(*a))
        back, loops_j, _ = return_leg_loops
        before = card_branch.attempts
        loops_f = [card_branch._verify(*c) for c in back]
        assert len(calls) == card_branch.attempts - before >= len(back)
        assert [l is None for l in loops_f] == [l is None for l in loops_j]
        assert any(l is not None for l in loops_f)
        for a, b in zip(loops_f, loops_j):
            if a is not None:
                assert (a.index0, a.index1) == (b.index0, b.index1)
                assert a.fitness == pytest.approx(b.fitness, abs=FITNESS_ATOL)
                np.testing.assert_allclose(a.relative_pose, b.relative_pose, atol=REL_POSE_ATOL)

    def test_false_pair_rejected(self, hairpin):
        """test_loop_closing.py's false pair, rejected by both packages."""
        _, lj, lt, _, _ = hairpin
        assert lt._verify(1, 14, 0.0) is None
        assert lj._verify(1, 14, 0.0) is None

    def test_yaw_discrepancy_fallback(self, hairpin, return_leg_loops):
        """test_loop_closing.py's drifted heading (0.4 rad): the port's
        retry recovers it, at the JAX package's pose."""
        gt, lj, lt, _, _ = hairpin
        lp = next(l for l in return_leg_loops[2] if l is not None)
        saved = lt.key_poses[lp.index1].copy()
        Rz = np.asarray(euler_xyz_to_matrix(jnp.float32(0), jnp.float32(0), jnp.float32(0.4)))
        bad = saved.copy()
        bad[:3, :3] = saved[:3, :3] @ Rz
        rel = gt[lp.index0][:3, :3].T @ gt[lp.index1][:3, :3]
        true_yaw = float(np.arctan2(rel[1, 0], rel[0, 0]))
        outs = []
        for lc in (lt, lj):
            lc.key_poses[lp.index1] = bad
            try:
                outs.append(lc._verify(lp.index0, lp.index1, true_yaw))
            finally:
                lc.key_poses[lp.index1] = saved
        assert outs[0] is not None and outs[0].fitness < 0.2
        assert outs[0].fitness == pytest.approx(outs[1].fitness, abs=FITNESS_ATOL)
        np.testing.assert_allclose(outs[0].relative_pose, outs[1].relative_pose, atol=REL_POSE_ATOL)
