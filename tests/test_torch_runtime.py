"""The port's last single-device modules against the JAX package's:
SLR clustering (models/clustering.py) and the native host runtime
(native.py, built from runtime/lidar_runtime.cpp with g++), on the JAX
tests' inputs (tests/test_components.py::TestSLRClustering,
tests/test_native.py), made with numpy from a seed. The JAX package's
timers (utils/timing.py) have no port: the port times through its run's
tracer (utils/watchdog.py, tests/test_torch_trace.py).

Clustering labels and sizes are integers: equal. The native runtime's
voxel centroids: within 1e-4 of the port's voxel_downsample (the JAX test's
bound) and equal to the JAX package's library's. The native tests skip only
where no g++ builds the runtime.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu import native as jnative
from lidar_slam_tpu.models import clustering as jclust

from lidar_slam_tpu_torch import native as tnative
from lidar_slam_tpu_torch.models import clustering as tclust
from lidar_slam_tpu_torch.ops import PointCloud, finite_mask, range_mask, voxel_downsample


def _two_objects(angle=0.0):
    """TestSLRClustering's organized mini-sweep (4 rings x 64 azimuth bins,
    two box-like objects apart in azimuth), rotated about z by `angle`."""
    n_rings, n_az = 4, 64
    pts = np.zeros((n_rings * n_az, 3), np.float32)
    mask = np.zeros(n_rings * n_az, bool)
    ring = np.repeat(np.arange(n_rings), n_az).astype(np.int32)
    for r in range(n_rings):
        for a in range(5, 15):
            pts[r * n_az + a] = [5.0 + 0.01 * a, 0.1 * a, 0.2 * r]
            mask[r * n_az + a] = True
        for a in range(40, 50):
            pts[r * n_az + a] = [-8.0 - 0.01 * a, -0.1 * a, 0.2 * r]
            mask[r * n_az + a] = True
    c, s = np.cos(angle), np.sin(angle)
    R = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return (pts @ R.T).astype(np.float32), mask, ring, n_az, jclust.SLRConfig(n_scans=4), tclust.SLRConfig(n_scans=4)


def _random_sweep():
    """A denser organized sweep: 8 rings x 128 bins of walls and blobs with
    dropped returns, so runs break and merge in many places."""
    rng = np.random.default_rng(3)
    n_rings, n_az = 8, 128
    az = np.linspace(0, 2 * np.pi, n_az, endpoint=False)
    rng_m = np.where((az % 1.0) < 0.5, 6.0, 11.0)[None, :] + rng.normal(0, 0.05, (n_rings, n_az))
    elev = np.linspace(-0.2, 0.15, n_rings)[:, None]
    pts = np.stack([rng_m * np.cos(az), rng_m * np.sin(az), rng_m * np.tan(elev)], axis=-1).reshape(-1, 3)
    mask = rng.uniform(size=n_rings * n_az) < 0.85
    ring = np.repeat(np.arange(n_rings), n_az).astype(np.int32)
    return (pts.astype(np.float32), mask, ring, n_az, jclust.SLRConfig(n_scans=n_rings),
            tclust.SLRConfig(n_scans=n_rings))


SCENES = {"two_objects": _two_objects, "rotated": lambda: _two_objects(2.1), "sweep": _random_sweep}


@pytest.mark.parametrize("scene", list(SCENES))
def test_slr_cluster_matches_reference(scene):
    pts, mask, ring, n_az, cfg_j, cfg_t = SCENES[scene]()
    ref = np.asarray(jclust.slr_cluster(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(ring), n_az, cfg_j))
    got = tclust.slr_cluster(torch.as_tensor(pts), torch.as_tensor(mask), torch.as_tensor(ring), n_az, cfg_t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    if scene != "sweep":  # TestSLRClustering's assertions
        la, lb = ref[5:15], ref[40:50]
        assert len(set(la.tolist())) == 1 and len(set(lb.tolist())) == 1 and la[0] != lb[0]
        assert ref[3 * n_az + 7] == la[0]
    n = len(pts)
    for segments in (n, 64):  # every label, and labels past the histogram dropped
        np.testing.assert_array_equal(tclust.cluster_sizes(got, segments).numpy(),
                                      np.asarray(jclust.cluster_sizes(jnp.asarray(ref), segments)))


def _rows_sorted(a):
    return a[np.lexsort(a.T)]


@pytest.fixture(scope="module")
def built():
    if not tnative.native_available():
        pytest.skip("no g++ to build runtime/lidar_runtime.cpp")


def test_native_voxel_matches_reference(built):
    """tests/test_native.py's cloud: the same count and centroids as the JAX
    package's library, and the port's voxel_downsample's to 1e-4."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 10, (20000, 4)).astype(np.float32)
    pts[::40] = np.nan
    out, msk, n = tnative.voxel_downsample_native(pts, leaf=0.5, capacity=32768, min_range=1.0, max_range=100.0)
    assert msk.sum() == n
    if jnative.native_available():
        out_j, msk_j, n_j = jnative.voxel_downsample_native(pts, leaf=0.5, capacity=32768, min_range=1.0,
                                                            max_range=100.0)
        assert n == n_j
        np.testing.assert_array_equal(_rows_sorted(out[msk]), _rows_sorted(out_j[msk_j]))
    p = torch.as_tensor(pts[:, :3])
    m = finite_mask(p) & range_mask(p, 1.0, 100.0)
    ref = voxel_downsample(PointCloud(points=torch.where(m[:, None], p, 0.0), mask=m), 0.5, out_capacity=32768)
    assert n == int(ref.num_valid())
    np.testing.assert_allclose(_rows_sorted(ref.points[ref.mask].numpy()), _rows_sorted(out[msk]), atol=1e-4)


def test_native_range_and_nan_filtering(built):
    pts = np.array([[0.1, 0, 0, 0], [50, 0, 0, 0], [np.nan, 0, 0, 0], [5, 0, 0, 0]], np.float32)
    out, msk, n = tnative.voxel_downsample_native(pts, leaf=1.0, capacity=8, min_range=1.0, max_range=10.0)
    assert n == 1
    np.testing.assert_allclose(out[msk][0], [5, 0, 0], atol=1e-6)


def test_native_bin_roundtrip(built, tmp_path):
    scan = np.random.default_rng(1).normal(size=(1000, 4)).astype(np.float32)
    p = str(tmp_path / "scan.bin")
    scan.tofile(p)
    back = tnative.read_velodyne_bin_native(p)
    np.testing.assert_array_equal(back, scan)
    if jnative.native_available():
        np.testing.assert_array_equal(back, jnative.read_velodyne_bin_native(p))
    with pytest.raises(IOError):
        tnative.read_velodyne_bin_native(str(tmp_path / "missing.bin"))


def test_native_prefetcher_order_and_content(built, tmp_path):
    """Frames come back in path order (tagged by y), each the library's own
    downsample of that file, then None."""
    rng = np.random.default_rng(2)
    paths, scans = [], []
    for i in range(4):
        s = rng.uniform(2, 20, (5000, 4)).astype(np.float32)
        s[:, 1] = i
        p = str(tmp_path / f"{i:06d}.bin")
        s.tofile(p)
        paths.append(p)
        scans.append(s)
    pf = tnative.NativePrefetcher(paths, leaf=0.1, capacity=16384, min_range=0.5, n_threads=3, lookahead=2)
    for i in range(4):
        pts, msk, n = pf.next()
        assert n > 0 and msk.sum() == n
        np.testing.assert_allclose(pts[msk][:, 1], i, atol=0.2)
        ref, ref_msk, ref_n = tnative.voxel_downsample_native(scans[i], 0.1, 16384, min_range=0.5, max_range=120.0)
        assert n == ref_n
        np.testing.assert_array_equal(_rows_sorted(pts[msk]), _rows_sorted(ref[ref_msk]))
    assert pf.next() is None
    pf.close()
