"""The CUDA kernels K1 (csrc/ndt_fused.cu), K2 (csrc/knn_fused.cu) and K3
(csrc/ndt_gather.cu) against their plain PyTorch versions on an NVIDIA GPU.
Every test here needs the card and skips without one; the file imports no
jax, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

K1's tolerances are bench.py's kernel parity gate (bench.py:187-189):
score rtol 2e-4; gradient rtol 2e-3, atol 1e-3; Hessian rtol 2e-3, atol
1e-2, with the Hessian's atol widened to 1e-5 of its largest entry where
that is more: each entry sums ~1e5 float32 terms of both signs, and one
that cancels to near zero keeps the rounding of the large terms (measured
on an H100: 0.0125 on an entry of -0.64 beside entries of 1.5e3).

K2 and K3 are compared exactly: K2 computes each distance with the same
float32 operations as its plain version (no FMA contraction) and breaks
ties on the same row; K3 sums the same rows (one, or two in either order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch.models.registration import NDTConfig, build_ndt_map
from lidar_slam_tpu_torch.models.registration.ndt import _reduce
from lidar_slam_tpu_torch.ops import PointCloud, voxel_downsample
from lidar_slam_tpu_torch.ops.cuda import knn_fused, ndt_fused, ndt_gather
from lidar_slam_tpu_torch.ops.hashgrid import build_bucket_grid

pytestmark = pytest.mark.cuda

CFG = NDTConfig(grid_dims=(64, 64, 16), point_chunk=4096, gather="fused", max_compact_voxels=8192)
ORIGIN = np.asarray([-32.0, -32.0, -8.0], np.float32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA code with no CPU mode")
    return torch.device("cuda")


def _scene(seed=0, n_blobs=120, per_blob=80):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-28, 28, size=(n_blobs, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(-5, 6, size=n_blobs)
    pts = [c + rng.normal(size=(per_blob, 3)) @ (rng.normal(size=(3, 3)) * [0.5, 0.5, 0.08])
           for c in centers]
    return np.concatenate(pts).astype(np.float32)


def _inputs(dev, n=5000, seed=1):
    pts = _scene()
    rng = np.random.default_rng(seed)
    w_map = rng.uniform(0.2, 1.0, len(pts)).astype(np.float32)
    m = build_ndt_map(PointCloud.from_points(pts, weights=w_map, device=dev), CFG, origin=ORIGIN)
    src = pts[rng.choice(len(pts), n, replace=False)] + rng.normal(0, 0.03, (n, 3)).astype(np.float32)
    src[:20] += np.float32([80.0, 0.0, 0.0])  # outside the grid
    src[20:25] = np.nan  # non-finite, unmasked
    mask = rng.random(n) < 0.95
    mask[20:25] = True
    w = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return m, torch.as_tensor(src, device=dev), torch.as_tensor(mask, device=dev), torch.as_tensor(w, device=dev)


def _assert_parity(k, p):
    np.testing.assert_allclose(k[0], p[0], rtol=2e-4)
    np.testing.assert_allclose(k[1:7], p[1:7], rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(k[7:28], p[7:28], rtol=2e-3, atol=max(1e-2, 1e-5 * np.abs(p[7:28]).max()))
    assert k[28] == 0.0


@pytest.mark.parametrize("stencil", ["direct7", "radius27"])
@pytest.mark.parametrize("weight_derivatives", [True, False])
def test_kernel_matches_plain(dev, stencil, weight_derivatives):
    m, src, mask, w = _inputs(dev)
    cfg = dataclasses.replace(CFG, stencil=stencil, weight_derivatives=weight_derivatives)
    for pose in ([0.1, -0.05, 0.02, 0.01, -0.01, 0.02], [0.3, 0.2, -0.1, 0.05, 0.0, -0.3]):
        pose = np.asarray(pose, np.float32)
        before = ndt_fused.launches
        k = _reduce(m, src, mask, w, pose, cfg).cpu().numpy()
        assert ndt_fused.launches == before + 1
        p = _reduce(m, src, mask, w, pose, dataclasses.replace(cfg, gather="two_level")).cpu().numpy()
        assert ndt_fused.launches == before + 1  # the plain path launches nothing
        assert np.isfinite(k).all() and abs(k[0]) > 1.0
        _assert_parity(k, p)


def test_deterministic_and_empty(dev):
    m, src, mask, w = _inputs(dev, n=9000)
    pose = np.asarray([0.1, -0.05, 0.02, 0.01, -0.01, 0.02], np.float32)
    a = _reduce(m, src, mask, w, pose, CFG).cpu().numpy()
    b = _reduce(m, src, mask, w, pose, CFG).cpu().numpy()
    np.testing.assert_array_equal(a, b)  # fixed-order reduction, no atomics
    z = _reduce(m, src[:0], mask[:0], w[:0], pose, CFG).cpu().numpy()
    np.testing.assert_array_equal(z, np.zeros(32, np.float32))


def test_map_and_downsample_repeat_bit_for_bit(dev):
    """The scatters under the map build and the voxel downsample sum in a
    fixed order on the card (scatter_sum), so repeated runs agree to the
    bit, and so do the trajectories built on them."""
    pts = torch.as_tensor(_scene(seed=2), device=dev)
    cloud = PointCloud(points=pts, mask=torch.ones(len(pts), dtype=torch.bool, device=dev))
    a, b = (voxel_downsample(cloud, 0.3, out_capacity=len(pts)) for _ in range(2))
    assert torch.equal(a.points, b.points) and torch.equal(a.mask, b.mask)
    m1, m2 = (build_ndt_map(cloud, CFG, origin=ORIGIN) for _ in range(2))
    assert torch.equal(m1.packed, m2.packed) and torch.equal(m1.index, m2.index)


def test_wrapper_rejects_bad_inputs(dev):
    m, src, mask, w = _inputs(dev, n=256)
    pose = np.zeros(6, np.float32)
    with pytest.raises(ValueError):
        _reduce(m, src.double(), mask, w, pose, CFG)
    with pytest.raises(ValueError):
        _reduce(m, src, mask, w[:100], pose, CFG)
    with pytest.raises(ValueError):
        _reduce(m, src.t().contiguous().t(), mask, w, pose, CFG)


def _knn_inputs(dev, n=6000, seed=3):
    """A clustered cloud (cells of a few to hundreds of points) with exact
    duplicates, queries on it and around it, some masked or outside."""
    rng = np.random.default_rng(seed)
    pts = _scene(seed=seed)[:n].copy()
    pts[-200:] = pts[:200]  # exact duplicates: ties broken on the sorted row
    mask = rng.random(len(pts)) < 0.9
    q = np.concatenate([pts[:300], rng.uniform(-30, 30, size=(700, 3)).astype(np.float32),
                        np.float32([[500.0, 0.0, 0.0], [np.nan, 0.0, 0.0]])])
    qmask = rng.random(len(q)) < 0.9
    qmask[-2:] = True
    ring = rng.integers(0, 64, len(pts)).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return PointCloud(points=t(pts), mask=t(mask)), t(q), t(qmask), t(ring)


@pytest.mark.parametrize("k,cell,radius,extras", [(5, 1.0, 1.0, False), (8, 5.0, 5.0, True), (8, 2.0, 1.5, True)])
def test_knn_kernel_matches_plain(dev, k, cell, radius, extras):
    cloud, q, qm, ring = _knn_inputs(dev)
    grid = build_bucket_grid(cloud, cell, (96, 96, 24))
    ex = ring if extras else None
    before = knn_fused.launches
    r = knn_fused.window_knn(grid, q, qm, k, radius, ex)
    assert knn_fused.launches == before + 1
    p = knn_fused.knn_exact_plain(grid, q, qm, k, radius, ex)
    assert knn_fused.launches == before + 1  # the plain path launches nothing
    assert set(r) == set(p)
    for key in r:
        assert torch.equal(r[key], p[key]), key
    ok = r["ok"].cpu().numpy()
    on_target = cloud.mask[:300].cpu().numpy() & qm[:300].cpu().numpy()  # each finds itself
    assert ok[:300][on_target, 0].all() and not ok[-2:].any() and ok.sum() > 1000


def test_knn_kernel_repeats_and_empty(dev):
    cloud, q, qm, ring = _knn_inputs(dev)
    grid = build_bucket_grid(cloud, 5.0, (32, 32, 8))
    a = knn_fused.window_knn(grid, q, qm, 8, 5.0, ring)
    b = knn_fused.window_knn(grid, q, qm, 8, 5.0, ring)
    assert all(torch.equal(a[key], b[key]) for key in a)
    e = knn_fused.window_knn(grid, q[:0], qm[:0], 8, 5.0, ring)
    assert e["idx"].shape == (0, 8) and e["pts"].shape == (0, 8, 3)


def test_knn_wrapper_rejects_bad_inputs(dev):
    cloud, q, qm, ring = _knn_inputs(dev, n=1000)
    grid = build_bucket_grid(cloud, 1.0, (64, 64, 16))
    cpu_grid = build_bucket_grid(PointCloud(points=cloud.points.cpu(), mask=cloud.mask.cpu()), 1.0, (64, 64, 16))
    before = knn_fused.launches
    with pytest.raises(ValueError):  # CPU grid, CUDA queries
        knn_fused.window_knn(cpu_grid, q, qm, 5, 1.0)
    with pytest.raises(ValueError):  # dtype
        knn_fused.window_knn(grid, q.double(), qm, 5, 1.0)
    with pytest.raises(ValueError):  # non-contiguous
        knn_fused.window_knn(grid, q.t().contiguous().t(), qm, 5, 1.0)
    with pytest.raises(ValueError, match="cell_size"):
        knn_fused.window_knn(grid, q, qm, 5, 1.5)
    with pytest.raises(ValueError):  # k the kernel is not compiled for
        knn_fused.window_knn(grid, q, qm, 6, 1.0)
    assert knn_fused.launches == before


def _gather_inputs(dev, seed=0):
    rng = np.random.default_rng(seed)
    c = 4097
    keys = np.full(c, -1, np.int32)
    used = rng.choice(200_000, 3000, replace=False).astype(np.int32)
    keys[:3000] = used
    keys[3000] = used[11]  # a duplicate key: its two rows sum
    table = rng.normal(size=(c, 16)).astype(np.float32)
    table[3001:] = 0.0
    vids = np.concatenate([rng.choice(used, 20000), rng.integers(200_000, 300_000, 4000), np.full(584, -2)])
    rng.shuffle(vids)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return t(keys), t(table), t(vids.reshape(-1, 7).astype(np.int32)), used


def test_gather_kernel_matches_plain(dev):
    keys, table, vids, used = _gather_inputs(dev)
    before = ndt_gather.launches
    k = ndt_gather.gather_stats_onehot(keys, table, vids)
    assert ndt_gather.launches == before + 1
    p = ndt_gather.gather_stats_plain(keys, table, vids)
    assert ndt_gather.launches == before + 1
    assert torch.equal(k, p)
    hit = vids == int(used[11])
    assert hit.any() and torch.equal(k[hit][0], table[11] + table[3000])
    assert not k[vids == -2].any()


def test_gather_wrapper_rejects_bad_inputs(dev):
    keys, table, vids, _ = _gather_inputs(dev)
    before = ndt_gather.launches
    with pytest.raises(ValueError):  # CPU keys, CUDA ids
        ndt_gather.gather_stats_onehot(keys.cpu(), table, vids)
    with pytest.raises(ValueError):  # dtype
        ndt_gather.gather_stats_onehot(keys, table.double(), vids)
    with pytest.raises(ValueError):  # non-contiguous
        ndt_gather.gather_stats_onehot(keys, table, vids.t().contiguous().t())
    assert ndt_gather.launches == before


def test_onehot_derivatives_match_two_level(dev):
    """gather="onehot" (K3 + the plain math) gives the two_level sums."""
    m, src, mask, w = _inputs(dev)
    pose = np.asarray([0.1, -0.05, 0.02, 0.01, -0.01, 0.02], np.float32)
    for stencil in ("direct7", "radius27"):
        cfg = dataclasses.replace(CFG, stencil=stencil)
        before = ndt_gather.launches
        a = _reduce(m, src, mask, w, pose, dataclasses.replace(cfg, gather="onehot")).cpu().numpy()
        assert ndt_gather.launches > before
        b = _reduce(m, src, mask, w, pose, dataclasses.replace(cfg, gather="two_level")).cpu().numpy()
        np.testing.assert_array_equal(a, b)


def test_aloam_pipeline_on_card_matches_cpu(dev):
    """The A-LOAM pipeline with K2 on the card against the CPU run of the
    same configuration (K2's plain version): poses within 5e-3 m, the
    correspondence-flip tolerance of the JAX package's own A-LOAM tests."""
    from lidar_slam_tpu_torch.io import SyntheticWorld, make_trajectory, simulate_spinning_scan
    from lidar_slam_tpu_torch.pipeline import aloam

    fe = aloam.FeatureExtractionConfig(n_scans=64, min_range=2.5, capacity=16384, max_sharp=256,
                                       max_less_sharp=2048, max_flat=512, max_less_flat=4096)
    mp = aloam.AloamMappingConfig(corner_map_capacity=4096, surf_map_capacity=8192, grid_dims=(64, 64, 16),
                                  stack_corner_capacity=2048, stack_surf_capacity=4096, knn="fused")
    od = aloam.AloamOdometryConfig(knn="fused")
    world = SyntheticWorld.corridor(length=60.0, width=18.0, density=300.0, seed=2)
    traj = make_trajectory(4, speed=0.8)
    frames = [simulate_spinning_scan(world, traj[i], t=i * 0.1, n_scans=64, n_azimuth=256, seed=i) for i in range(4)]
    poses = {}
    for d in (dev, torch.device("cpu")):
        pipe = aloam.AloamPipeline(fe, od, mp, device=d)
        pipe.set_init_pose(traj[0])
        before = knn_fused.launches
        poses[d.type] = pipe.update_batch(frames)
        assert (knn_fused.launches > before) == (d.type == "cuda")
    card, cpu = poses["cuda"], poses["cpu"]
    np.testing.assert_allclose(card, cpu, atol=5e-3)
    assert np.abs(card[:, :3, 3] - traj[:, :3, 3]).max() < 0.1
