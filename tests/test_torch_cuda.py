"""Kernel K1 (csrc/ndt_fused.cu) against its plain PyTorch version on an
NVIDIA GPU. Every test here needs the card and skips without one; the file
imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are bench.py's kernel parity gate (bench.py:187-189): score
rtol 2e-4; gradient rtol 2e-3, atol 1e-3; Hessian rtol 2e-3, atol 1e-2,
with the Hessian's atol widened to 1e-5 of its largest entry where that is
more: each entry sums ~1e5 float32 terms of both signs, and one that
cancels to near zero keeps the rounding of the large terms (measured on an
H100: 0.0125 on an entry of -0.64 beside entries of 1.5e3).
"""

import dataclasses

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch.models.registration import NDTConfig, build_ndt_map
from lidar_slam_tpu_torch.models.registration.ndt import _reduce
from lidar_slam_tpu_torch.ops import PointCloud, voxel_downsample
from lidar_slam_tpu_torch.ops.cuda import ndt_fused

pytestmark = pytest.mark.cuda

CFG = NDTConfig(grid_dims=(64, 64, 16), point_chunk=4096, gather="fused", max_compact_voxels=8192)
ORIGIN = np.asarray([-32.0, -32.0, -8.0], np.float32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 is a CUDA kernel with no CPU mode")
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
