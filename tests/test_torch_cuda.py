"""The CUDA kernels K1 (csrc/ndt_fused.cu), the whole-alignment Newton
kernel (csrc/ndt_newton.cu), K2 (csrc/knn_fused.cu) and K3
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

The Newton kernel is held to its plain version's iteration count and
flags and to 1e-4 on the pose where the alignment converges in a few
steps. From a far start (8-16 iterations) the two may stop a step apart:
they sum in different orders, the iterates carry that rounding from step
to step, and the plain version alone, given its points in another order,
moves by millimetres (tests/test_torch_newton.py::
test_plain_order_sensitivity). There the poses are held to trans_eps and
two iterations, and the kernel's score and Hessian at its own final pose
to the plain sums at that pose at K1's tolerances; its gradient, whose
entries cancel to near zero at an optimum and keep the sums' rounding,
through the Newton step it makes, H^-1 (g - g_plain), within 1e-4.

K2 and K3 are compared exactly: K2 computes each distance with the same
float32 operations as its plain version (no FMA contraction) and breaks
ties on the same row, with every compiled number of lanes per query and
for any query order; K3 sums the same rows (one, or two in
either order), and a longer run of equal keys in ascending row order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch.models.registration import NDTConfig, build_ndt_map
from lidar_slam_tpu_torch.models.registration import ndt as tndt
from lidar_slam_tpu_torch.models.registration.ndt import _reduce
from lidar_slam_tpu_torch.ops import PointCloud, voxel_downsample
from lidar_slam_tpu_torch.ops.cuda import knn_fused, ndt_fused, ndt_gather, ndt_newton
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


def test_one_shot_kernel_is_one_launch(dev):
    """K1's evaluation is one kernel launch (the last block sums the
    partials), within the parity tolerances of its plain version."""
    from torch.profiler import ProfilerActivity, profile

    m, src, mask, w = _inputs(dev)
    pose = np.asarray([0.1, -0.05, 0.02, 0.01, -0.01, 0.02], np.float32)
    _reduce(m, src, mask, w, pose, CFG)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        k = _reduce(m, src, mask, w, pose, CFG)
        torch.cuda.synchronize()
    ours = [e for e in prof.key_averages() if "ndt_" in e.key]
    assert [e.count for e in ours] == [1], [(e.key, e.count) for e in ours]
    p = _reduce(m, src, mask, w, pose, dataclasses.replace(CFG, gather="two_level"))
    _assert_parity(k.cpu().numpy(), p.cpu().numpy())


def _newton_call(m, src, mask, w, pose, stencil):
    d1, d2 = CFG.gauss_params()
    kw = dict(dims=m.dims, resolution=m.resolution, d1=float(np.float32(d1)), d2=float(np.float32(d2)),
              stencil=stencil, weight_derivatives=True, max_iter=CFG.max_iter, trans_eps=CFG.trans_eps,
              step_size=CFG.step_size, score_rel_tol=0.0)
    pose0 = torch.as_tensor(np.asarray(pose, np.float32), device=src.device)
    return (src, mask, w, m.index, m.packed, m.origin, pose0), kw


NEWTON_POSES = ([0.1, -0.05, 0.02, 0.01, -0.01, 0.02], [0.3, 0.2, -0.1, 0.05, 0.0, -0.03])


def _align_scene(dev, stencil):
    """tests/test_torch_newton.py's _fused_setup scene (the JAX tests'
    blobs, a weighted 1024-point source, a 0.3 m first guess), where the
    alignment converges in a few steps to one optimum."""
    rng = np.random.default_rng(3)
    centers = rng.uniform(-12, 12, size=(25, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(-2, 4, size=25)
    blobs = []
    for c in centers:
        A = rng.normal(size=(3, 3)) * np.array([0.3, 0.3, 0.05])
        blobs.append(c + rng.normal(size=(50, 3)) @ A.astype(np.float32))
    pts = np.concatenate(blobs).astype(np.float32)
    cfg = NDTConfig(grid_dims=(32, 32, 16), stencil=stencil, max_compact_voxels=2048, gather="fused")
    m = build_ndt_map(PointCloud.from_points(pts, device=dev), cfg, origin=np.float32([-16.0, -16.0, -8.0]))
    rng = np.random.default_rng(5)
    src = pts[rng.permutation(len(pts))[:1024]]
    w = rng.uniform(0.2, 1.0, size=1024).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return m, t(src), torch.ones(1024, dtype=torch.bool, device=dev), t(w), [0.25, -0.15, 0.05, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("stencil", ["direct7", "radius27"])
def test_newton_kernel_matches_plain(dev, stencil):
    m, src, mask, w, pose = _align_scene(dev, stencil)
    N = ndt_newton
    args, kw = _newton_call(m, src, mask, w, pose, stencil)
    before = N.launches
    k = N.ndt_newton(*args, **kw).cpu().numpy()
    assert N.launches == before + 1
    p = N.ndt_newton_plain(*args, **kw).cpu().numpy()
    assert N.launches == before + 1  # the plain path launches nothing
    assert k[N.ITERATIONS] == p[N.ITERATIONS] and k[N.CONVERGED] == p[N.CONVERGED] == 1.0
    np.testing.assert_allclose(k[N.POSE], p[N.POSE], rtol=0, atol=1e-4)
    np.testing.assert_allclose(k[N.SCORE], p[N.SCORE], rtol=2e-4)
    np.testing.assert_allclose(k[N.ROTATION], p[N.ROTATION], rtol=0, atol=1e-6)
    assert k[N.N_VALID] == p[N.N_VALID] == 1024 and k[N.UNRESOLVED] == 0.0


@pytest.mark.parametrize("stencil", ["direct7", "radius27"])
def test_newton_kernel_from_far_starts(dev, stencil):
    """The 5000-point scene (outside, non-finite and masked points among
    them) from NEWTON_POSES: the kernel's sums at its final pose against
    the plain sums there, its pose within trans_eps and two iterations of
    the plain version's (see the module note). The readings are printed
    (pytest -s)."""
    m, src, mask, w = _inputs(dev)
    N = ndt_newton
    for pose in NEWTON_POSES:
        args, kw = _newton_call(m, src, mask, w, pose, stencil)
        k = N.ndt_newton(*args, **kw).cpu().numpy()
        p = N.ndt_newton_plain(*args, **kw).cpu().numpy()
        R, t, jang, hang = N.pose_coefficients(torch.as_tensor(k[N.POSE], device=dev))
        at_k = ndt_fused.ndt_reduce_plain(
            src, mask, w, m.index, m.packed, m.origin, R, t, jang, hang, dims=m.dims, resolution=m.resolution,
            d1=kw["d1"], d2=kw["d2"], stencil=stencil, weight_derivatives=True,
        ).cpu().numpy()
        print(f"[far start {stencil}] {pose}: iterations kernel {int(k[N.ITERATIONS])}, plain "
              f"{int(p[N.ITERATIONS])}; max |kernel - plain| pose {np.abs(k[N.POSE] - p[N.POSE]).max():.3e}")
        sums = np.concatenate([k[N.SCORE:N.HESS.stop], [0.0]])
        _assert_parity(sums, np.concatenate([at_k[:1], sums[1:7], at_k[7:]]))  # score, Hessian
        _, g, h, _ = ndt_fused.unpack_results(at_k)
        assert np.abs(np.linalg.solve(h.astype(np.float64), (sums[1:7] - g).astype(np.float64))).max() <= 1e-4
        assert k[N.CONVERGED] == p[N.CONVERGED] == 1.0 and abs(k[N.ITERATIONS] - p[N.ITERATIONS]) <= 2
        np.testing.assert_allclose(k[N.POSE], p[N.POSE], rtol=0, atol=CFG.trans_eps)
        assert k[N.N_VALID] == p[N.N_VALID] == int(mask.sum()) and k[N.UNRESOLVED] == 0.0


def test_newton_kernel_repeats_and_empty(dev):
    """Fixed-order sums: a rerun is bit-identical. With no masked-in point
    the loop stops at once on the degenerate step, keeping the guess."""
    m, src, mask, w = _inputs(dev, n=9000)
    args, kw = _newton_call(m, src, mask, w, NEWTON_POSES[1], "radius27")
    a = ndt_newton.ndt_newton(*args, **kw)
    b = ndt_newton.ndt_newton(*args, **kw)
    assert torch.equal(a, b)
    for n, keep in ((0, False), (256, False)):
        args, kw = _newton_call(m, src[:n], mask[:n] & keep, w[:n], NEWTON_POSES[1], "direct7")
        e = ndt_newton.ndt_newton(*args, **kw).cpu().numpy()
        np.testing.assert_array_equal(e[ndt_newton.POSE], np.float32(NEWTON_POSES[1]))
        assert e[ndt_newton.ITERATIONS] == 1 and e[ndt_newton.N_VALID] == 0 and e[ndt_newton.SCORE] == 0


def test_device_pose_math_matches_torch(dev):
    """The kernel's pose coefficients against the plain version's torch
    ops on the card (both use the device's sinf / cosf): equal, or within
    one float32 ulp at the scale of a sine."""
    for pose in ([0.1, -0.2, 0.3, 0.2, -0.4, 0.7], [0.0, 0.0, 0.0, 5e-5, -0.3, 1e-5], [1.5, 2.0, -0.5, -9.9e-5, 1e-4, -3.0]):
        p = torch.as_tensor(pose, dtype=torch.float32, device=dev)
        k = ndt_newton.device_pose_coefficients(p).cpu().numpy()
        R, t, jang, hang = (a.cpu() for a in ndt_newton.pose_coefficients(p))
        want = np.frombuffer(bytes(ndt_fused._pack_params(np.zeros(3), R, t, jang, hang, (1, 1, 1), 1.0, 1.0, 1.0,
                                                          1, True)), np.float32)[:93]
        np.testing.assert_allclose(k, want, rtol=0, atol=np.spacing(np.float32(1.0)))


def test_ndt_align_on_card_is_one_launch_and_one_sync(dev):
    """ndt_align on CUDA tensors: one ndt_newton launch, one host sync (its
    result copy), the host loop's pose to 1e-4."""
    import warnings

    m, src, mask, w = _inputs(dev)
    cloud = PointCloud(points=src, mask=mask, weights=w)
    guess = torch.as_tensor(tndt._pose_to_matrix(np.float32(NEWTON_POSES[0])))
    tndt.ndt_align(m, cloud, guess, CFG)  # warm-up: the build and the first launch
    torch.cuda.synchronize()
    before = (ndt_newton.launches, ndt_fused.launches)
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            r = tndt.ndt_align(m, cloud, guess, CFG)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n_sync = sum("called a synchronizing CUDA operation" in str(x.message) for x in syncs)
    assert n_sync == 1 and (ndt_newton.launches, ndt_fused.launches) == (before[0] + 1, before[1])
    host = tndt.ndt_align_host_loop(m, cloud, guess, CFG)
    assert r.iterations == host.iterations and r.converged == host.converged
    np.testing.assert_allclose(r.pose.numpy(), host.pose.numpy(), atol=1e-4)
    assert float(r.trans_probability) == pytest.approx(float(host.trans_probability), rel=1e-4)


def test_newton_wrapper_rejects_bad_inputs(dev):
    m, src, mask, w = _inputs(dev, n=256)
    args, kw = _newton_call(m, src, mask, w, NEWTON_POSES[0], "direct7")
    before = ndt_newton.launches
    with pytest.raises(ValueError):  # the pose on the host
        ndt_newton.ndt_newton(*args[:6], args[6].cpu(), **kw)
    with pytest.raises(ValueError):  # dtype
        ndt_newton.ndt_newton(src.double(), *args[1:], **kw)
    with pytest.raises(ValueError):
        ndt_newton.ndt_newton(*args, **dict(kw, stencil="radius9"))
    with pytest.raises(ValueError):
        ndt_newton.device_pose_coefficients(args[6].cpu())
    assert ndt_newton.launches == before


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


def _knn_extras(kind, n, dev, seed=7):
    """None, or '<dtype>_<E>' extras ([N] for int32_1d, else [N, E])."""
    if kind is None:
        return None
    rng = np.random.default_rng(seed)
    if kind == "int32_1d":
        return torch.as_tensor(rng.integers(0, 64, n).astype(np.int32), device=dev)
    dtype, e = kind.split("_")
    if dtype == "int32":
        return torch.as_tensor(rng.integers(-1000, 1000, (n, int(e))).astype(np.int32), device=dev)
    return torch.as_tensor(rng.normal(size=(n, int(e))).astype(np.float32), device=dev)


def _assert_knn_equal(r, p, perm=None):
    """Every key of the kernel's dict equal to the plain version's (for the
    queries in `perm`'s order when given)."""
    assert set(r) == set(p)
    for key in r:
        want = p[key] if perm is None or key == "unresolved" else p[key][perm]
        assert r[key].dtype == want.dtype and torch.equal(r[key], want), key


@pytest.mark.parametrize("lanes", knn_fused.LANES)
@pytest.mark.parametrize("k,cell,radius,extras", [
    (5, 1.0, 1.0, None), (8, 5.0, 5.0, "int32_1d"), (8, 2.0, 1.5, "float32_3"), (5, 2.0, 2.0, "int32_0"),
])
def test_knn_kernel_matches_plain(dev, k, cell, radius, extras, lanes):
    """Every compiled lane count against the plain version, every key
    equal: queries unsorted, sorted by cell (as the path sorts them) and in
    a random order; int32 and float32 extras, E = 0, 1, 3."""
    from lidar_slam_tpu_torch.pipeline.aloam.odometry import sort_by_cell

    cloud, q, qm, _ = _knn_inputs(dev)
    grid = build_bucket_grid(cloud, cell, (96, 96, 24))
    ex = _knn_extras(extras, cloud.points.shape[0], dev)
    before = knn_fused.launches
    r = knn_fused.window_knn(grid, q, qm, k, radius, ex, lanes=lanes)
    assert knn_fused.launches == before + 1
    p = knn_fused.knn_exact_plain(grid, q, qm, k, radius, ex)
    assert knn_fused.launches == before + 1  # the plain path launches nothing
    _assert_knn_equal(r, p)
    ok = r["ok"].cpu().numpy()
    on_target = cloud.mask[:300].cpu().numpy() & qm[:300].cpu().numpy()  # each finds itself
    assert ok[:300][on_target, 0].all() and not ok[-2:].any() and ok.sum() > 1000
    for order in (sort_by_cell(grid, q, qm), torch.randperm(len(q), generator=torch.Generator().manual_seed(1))):
        order = order.to(dev)
        r = knn_fused.window_knn(grid, q[order], qm[order], k, radius, ex, lanes=lanes)
        _assert_knn_equal(r, p, order)


@pytest.mark.parametrize("lanes", knn_fused.LANES)
def test_knn_kernel_crowded_cell(dev, lanes):
    """3 000 points in one 5 m cell and queries in it: every lane count
    scans the whole crowded cell and drops no candidate."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(0.2, 4.8, size=(3000, 3)).astype(np.float32)
    pts = np.concatenate([pts, rng.uniform(-20, 20, size=(500, 3)).astype(np.float32)])
    cloud = PointCloud(points=torch.as_tensor(pts, device=dev), mask=torch.ones(len(pts), dtype=torch.bool, device=dev))
    grid = build_bucket_grid(cloud, 5.0, (16, 16, 8), origin=np.float32([-40.0, -40.0, -20.0]))
    assert int(grid.cell_counts.max()) >= 3000
    q = torch.as_tensor(np.sort(rng.uniform(0.2, 4.8, size=(512, 3)).astype(np.float32), axis=0), device=dev)
    qm = torch.ones(len(q), dtype=torch.bool, device=dev)
    ring = _knn_extras("int32_1d", len(pts), dev)
    r = knn_fused.window_knn(grid, q, qm, 8, 5.0, ring, lanes=lanes)
    _assert_knn_equal(r, knn_fused.knn_exact_plain(grid, q, qm, 8, 5.0, ring))
    assert r["ok"].all()


def test_knn_kernel_repeats_and_empty(dev):
    cloud, q, qm, ring = _knn_inputs(dev)
    grid = build_bucket_grid(cloud, 5.0, (32, 32, 8))
    a = knn_fused.window_knn(grid, q, qm, 8, 5.0, ring)
    b = knn_fused.window_knn(grid, q, qm, 8, 5.0, ring)
    assert all(torch.equal(a[key], b[key]) for key in a)
    e = knn_fused.window_knn(grid, q[:0], qm[:0], 8, 5.0, ring)
    p = knn_fused.knn_exact_plain(grid, q[:0], qm[:0], 8, 5.0, ring)
    assert e["idx"].shape == (0, 8) and e["pts"].shape == (0, 8, 3) and e["extras"].shape == (0, 8, 1)
    _assert_knn_equal(e, p)


def test_knn_wrapper_is_one_kernel_and_no_sync(dev):
    """A call makes no host sync (sync debug mode "error" raises on one),
    and runs on the device one kernel and no copy or fill: 3 calls in a
    torch.profiler window show 3 launches of it and nothing else. A window
    now and then comes back empty on the card, so up to 3 are taken."""
    from torch.profiler import ProfilerActivity, profile

    cloud, q, qm, ring = _knn_inputs(dev)
    grid = build_bucket_grid(cloud, 5.0, (32, 32, 8))
    knn_fused.window_knn(grid, q, qm, 8, 5.0, ring)  # warm-up: the build and the first launch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        knn_fused.window_knn(grid, q, qm, 8, 5.0, ring)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                knn_fused.window_knn(grid, q, qm, 8, 5.0, ring)
            torch.cuda.synchronize()
        device_work = [(e.key, e.count) for e in prof.key_averages() if e.self_device_time_total > 0]
        if device_work:
            break
    assert len(device_work) == 1 and "knn_kernel" in device_work[0][0] and device_work[0][1] == 3, device_work


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
    with pytest.raises(ValueError):  # lanes the kernel is not compiled for
        knn_fused.window_knn(grid, q, qm, 5, 1.0, lanes=2)
    with pytest.raises(ValueError):  # extras of another dtype
        knn_fused.window_knn(grid, q, qm, 5, 1.0, ring.long())
    with pytest.raises(ValueError):  # extras on the CPU
        knn_fused.window_knn(grid, q, qm, 5, 1.0, ring.cpu())
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
    """The general entry (keys unsorted, one repeated, -1 in the tail)
    against the plain version, to the bit."""
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


def test_gather_kernel_long_runs(dev):
    """Runs of equal keys that cross fence segments (lengths 1-300, some
    ending on a segment's last key) and keys that fill whole segments: each
    run's rows summed in ascending row order, as a numpy running sum adds
    them; ids between and past the keys give zero rows."""
    rng = np.random.default_rng(4)
    lengths = np.concatenate([rng.integers(1, 300, 60), [16, 32, 64, 15, 17, 63, 65, 1]])
    ids = np.cumsum(rng.integers(2, 9, len(lengths))).astype(np.int32)
    keys = np.repeat(ids, lengths)
    keys = np.concatenate([keys, np.full(37, -1, np.int32)])
    order = rng.permutation(len(keys))  # rows in any order: the wrapper sorts
    keys = keys[order]
    table = rng.normal(size=(len(keys), 16)).astype(np.float32)
    vids = np.concatenate([ids, ids - 1, [ids[-1] + 1, 2**31 - 1, -2, 0]]).astype(np.int32)
    want = np.zeros((len(vids), 16), np.float32)
    for i, v in enumerate(vids):
        rows = np.flatnonzero(keys == v)  # ascending row order
        if len(rows):
            want[i] = np.add.accumulate(table[rows], axis=0)[-1]
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    k = ndt_gather.gather_stats_onehot(t(keys), t(table), t(vids[:, None]))
    np.testing.assert_array_equal(k[:, 0].cpu().numpy(), want)
    srt = np.argsort(keys.view(np.uint32), kind="stable")  # the same keys presorted: rows in key order
    s = ndt_gather.gather_stats_sorted(t(keys[srt]), t(table[srt]), t(vids[:, None]))
    np.testing.assert_array_equal(s[:, 0].cpu().numpy(), want)


def _map_vids(m, src, stencil):
    cell = torch.floor((src - torch.as_tensor(m.origin, device=src.device)) / m.resolution).to(torch.int32)
    cand = cell[:, None, :] + torch.as_tensor(ndt_fused.STENCIL_OFFSETS[stencil], device=src.device)[None]
    dims = torch.as_tensor(m.dims, dtype=torch.int32, device=src.device)
    inb = torch.all((cand >= 0) & (cand < dims), dim=-1)
    vid = (cand[..., 0] * m.dims[1] + cand[..., 1]) * m.dims[2] + cand[..., 2]
    return torch.where(inb, vid, -2).contiguous()


@pytest.mark.parametrize("cap", [8192, 64], ids=["tail", "full"])
@pytest.mark.parametrize("stencil", ["direct7", "radius27"])
def test_sorted_gather_matches_plain_on_map(dev, cap, stencil):
    """The presorted entry on a map's keys and table and the stencil ids of
    its points (some off the grid: -2), to the bit: with room for
    every voxel (a -1 tail), and a full compact table (every row used but
    the sentinel)."""
    m, src, _, _ = _inputs(dev)
    if cap != CFG.max_compact_voxels:
        cloud = PointCloud.from_points(_scene(), device=dev)
        m = build_ndt_map(cloud, dataclasses.replace(CFG, max_compact_voxels=cap), origin=ORIGIN)
    used = int((m.keys >= 0).sum())
    assert (used == cap) == (cap == 64)
    vids = _map_vids(m, src, stencil)
    before = ndt_gather.launches
    k = ndt_gather.gather_stats_sorted(m.keys, m.packed, vids)
    assert ndt_gather.launches == before + 1
    p = ndt_gather.gather_stats_plain(m.keys, m.packed, vids)
    assert torch.equal(k, p) and int((k[..., 10] > 0.5).sum()) > 100


def test_sorted_gather_is_one_kernel_and_no_sync(dev):
    """A presorted call makes no host sync (sync debug mode "error" raises
    on one) and runs one kernel on the device, no sort, copy or fill: 3
    calls in a torch.profiler window show 3 launches of it and nothing
    else. A window now and then comes back empty, so up to 3 are taken."""
    from torch.profiler import ProfilerActivity, profile

    m, src, _, _ = _inputs(dev)
    vids = _map_vids(m, src, "radius27")
    ndt_gather.gather_stats_sorted(m.keys, m.packed, vids)  # warm-up: the build and the first launch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ndt_gather.gather_stats_sorted(m.keys, m.packed, vids)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                ndt_gather.gather_stats_sorted(m.keys, m.packed, vids)
            torch.cuda.synchronize()
        device_work = [(e.key, e.count) for e in prof.key_averages() if e.self_device_time_total > 0]
        if device_work:
            break
    assert len(device_work) == 1 and "ndt_gather" in device_work[0][0] and device_work[0][1] == 3, device_work


def test_gather_wrapper_rejects_bad_inputs(dev):
    keys, table, vids, _ = _gather_inputs(dev)
    before = ndt_gather.launches
    for entry in (ndt_gather.gather_stats_onehot, ndt_gather.gather_stats_sorted):
        with pytest.raises(ValueError):  # CPU keys, CUDA ids
            entry(keys.cpu(), table, vids)
        with pytest.raises(ValueError):  # dtype
            entry(keys, table.double(), vids)
        with pytest.raises(ValueError):  # non-contiguous
            entry(keys, table, vids.t().contiguous().t())
        with pytest.raises(ValueError):  # a table of another length
            entry(keys, table[1:], vids)
    with pytest.raises(ValueError, match="aligned"):  # keys off a 16-byte boundary
        ndt_gather.gather_stats_sorted(keys[1:], table[1:], vids)
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
