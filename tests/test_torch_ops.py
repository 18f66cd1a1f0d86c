"""Parity of the PyTorch port's geometry and point-cloud ops with the JAX
package, plus the port's plumbing (no jax import, TF32 off, device pick).

Inputs are made with numpy from a seed and fed to both packages; the JAX
side runs on the CPU. Tolerances are float32 rounding of reordered sums
unless stated otherwise.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.geom import se3 as jgeom
from lidar_slam_tpu.models import ground_seg as jgs
from lidar_slam_tpu.ops import PointCloud as JCloud
from lidar_slam_tpu.ops import pointcloud as jpc
from lidar_slam_tpu.ops import rotated_box_mask as j_rotated_box_mask
from lidar_slam_tpu.ops import sym_eigh3 as j_sym_eigh3
from lidar_slam_tpu.ops import voxel_downsample as j_voxel_downsample

import lidar_slam_tpu_torch as port
from lidar_slam_tpu_torch import geom as tgeom
from lidar_slam_tpu_torch.models import ground_seg as tgs
from lidar_slam_tpu_torch.ops import pointcloud as tpc
from lidar_slam_tpu_torch.ops import PointCloud as TCloud
from lidar_slam_tpu_torch.ops import rotated_box_mask as t_rotated_box_mask
from lidar_slam_tpu_torch.ops import scatter_sum
from lidar_slam_tpu_torch.ops import sym_eigh3 as t_sym_eigh3
from lidar_slam_tpu_torch.ops import voxel_downsample as t_voxel_downsample


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    """A torch tensor holding a (writable) copy of a numpy or JAX array."""
    return torch.as_tensor(np.array(x))


class TestPlumbing:
    def test_import_leaves_jax_out(self):
        """Importing every module of the port imports no jax and loads no
        file of the JAX package, by name or by path."""
        root = Path(__file__).resolve().parents[1]
        port_modules = sorted(
            ".".join(p.relative_to(root).with_suffix("").parts).removesuffix(".__init__")
            for p in (root / "lidar_slam_tpu_torch").rglob("*.py")
        )
        assert "lidar_slam_tpu_torch.ops.cuda.ndt_newton" in port_modules
        ref_dir = str(root / "lidar_slam_tpu") + "/"
        code = (
            "import importlib, sys\n"
            f"for m in {port_modules!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'lidar_slam_tpu' or m.startswith('lidar_slam_tpu.')))\n"
            "print(sorted(m.__name__ for m in list(sys.modules.values()) "
            f"if (getattr(m, '__file__', None) or '').startswith({ref_dir!r})))\n"
        )
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, check=True, cwd=root,
        )
        assert out.stdout.split("\n")[:2] == ["[]", "[]"], out.stdout

    def test_tf32_disabled(self):
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False

    def test_device_never_falls_back_to_cpu(self):
        assert port.device("cpu").type == "cpu"
        if torch.cuda.is_available():
            assert port.device("cuda").type == "cuda"
            assert port.device().type == "cuda"
        else:
            with pytest.raises(RuntimeError):
                port.device("cuda")
            with pytest.raises(RuntimeError):
                port.device()

    def test_synthetic_data_is_the_reference_generator(self):
        """The port's own copy of the generator makes the reference's data."""
        from lidar_slam_tpu import io as jio

        from lidar_slam_tpu_torch import io as tio

        assert tio.SyntheticWorld is not jio.SyntheticWorld
        assert tio.SyntheticWorld.__module__ == "lidar_slam_tpu_torch.io.synthetic"
        jw = jio.SyntheticWorld.corridor(length=40.0, seed=3)
        tw = tio.SyntheticWorld.corridor(length=40.0, seed=3)
        np.testing.assert_array_equal(jw.points, tw.points)
        pose = np.eye(4, dtype=np.float32)
        jp, jm, _ = jio.simulate_scan(jw, pose, n_points=2048, seed=5)
        tp, tm, _ = tio.simulate_scan(tw, pose, n_points=2048, seed=5)
        np.testing.assert_array_equal(jp, tp)
        np.testing.assert_array_equal(jm, tm)
        jt, tt = jio.make_trajectory(12, speed=0.8), tio.make_trajectory(12, speed=0.8)
        np.testing.assert_array_equal(jt, tt)
        np.testing.assert_array_equal(jio.make_hairpin_trajectory(12), tio.make_hairpin_trajectory(12))
        js, jsm = jio.simulate_spinning_scan(jw, jt[3], t=0.3, n_scans=16, n_azimuth=128, seed=2)
        ts, tsm = tio.simulate_spinning_scan(tw, tt[3], t=0.3, n_scans=16, n_azimuth=128, seed=2)
        np.testing.assert_array_equal(js, ts)
        np.testing.assert_array_equal(jsm, tsm)
        noisy = tt + np.float32(0.01)
        assert tio.ate_rmse(noisy, tt) == jio.ate_rmse(noisy, jt)


class TestSE3:
    def _twists(self, n=16, seed=0):
        rng = np.random.default_rng(seed)
        xi = rng.normal(0, 0.6, size=(n, 6)).astype(np.float32)
        xi[0] = 0.0  # identity: Taylor branches
        xi[1, 3:] = 1e-6
        return xi

    def test_exp_log(self):
        xi = self._twists()
        Tj = np.asarray(jgeom.se3_exp(jnp.asarray(xi)))
        Tt = _np(tgeom.se3_exp(torch.as_tensor(xi)))
        np.testing.assert_allclose(Tt, Tj, atol=2e-6)
        np.testing.assert_allclose(
            _np(tgeom.se3_log(_t(Tj))), np.asarray(jgeom.se3_log(jnp.asarray(Tj))), atol=2e-5
        )

    def test_euler_roundtrip_and_pose_ops(self):
        rng = np.random.default_rng(1)
        ang = rng.uniform(-1.2, 1.2, size=(3, 32)).astype(np.float32)
        Rj = np.asarray(jgeom.euler_xyz_to_matrix(*(jnp.asarray(a) for a in ang)))
        Rt = _np(tgeom.euler_xyz_to_matrix(*(torch.as_tensor(a) for a in ang)))
        np.testing.assert_allclose(Rt, Rj, atol=1e-6)
        for a_t, a_j in zip(tgeom.matrix_to_euler_xyz(_t(Rj)), jgeom.matrix_to_euler_xyz(jnp.asarray(Rj))):
            np.testing.assert_allclose(_np(a_t), np.asarray(a_j), atol=1e-5)

        t = rng.normal(size=(32, 3)).astype(np.float32)
        Tj = np.asarray(jgeom.make_pose(jnp.asarray(Rj), jnp.asarray(t)))
        Tt = tgeom.make_pose(_t(Rj), torch.as_tensor(t))
        np.testing.assert_array_equal(_np(Tt), Tj)
        np.testing.assert_allclose(
            _np(tgeom.pose_inverse(Tt)), np.asarray(jgeom.pose_inverse(jnp.asarray(Tj))), atol=1e-6
        )
        pts = rng.normal(size=(32, 50, 3)).astype(np.float32)
        np.testing.assert_allclose(
            _np(tgeom.transform_points(Tt, torch.as_tensor(pts))),
            np.asarray(jgeom.transform_points(jnp.asarray(Tj), jnp.asarray(pts))),
            atol=1e-5,
        )


class TestVoxelDownsample:
    @pytest.mark.parametrize("leaf,out_cap", [(0.5, 4096), (0.3, 2048), (1.0, 300)])
    def test_matches_reference(self, leaf, out_cap):
        rng = np.random.default_rng(int(leaf * 10) + out_cap)
        n = 8192
        pts = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
        pts[:, 2] *= 0.2
        pts[: n // 4] = pts[: n // 4, :] * 0.05  # a dense cluster
        mask = rng.random(n) < 0.9
        w = rng.uniform(0.2, 1.0, n).astype(np.float32)

        j = j_voxel_downsample(
            JCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask), weights=jnp.asarray(w)),
            leaf, out_capacity=out_cap,
        )
        t = t_voxel_downsample(
            TCloud(points=torch.as_tensor(pts), mask=torch.as_tensor(mask), weights=torch.as_tensor(w)),
            leaf, out_capacity=out_cap,
        )
        # both emit voxels in packed-key order, so rows correspond one to
        # one; masks are exact, centroids/weight means agree to f32
        # reordered-sum rounding
        np.testing.assert_array_equal(_np(t.mask), np.asarray(j.mask))
        np.testing.assert_allclose(_np(t.points), np.asarray(j.points), atol=2e-5)
        np.testing.assert_allclose(_np(t.weights), np.asarray(j.weights), atol=2e-6)

    def test_scatter_sum_is_index_add(self):
        rng = np.random.default_rng(6)
        idx = rng.integers(0, 40, 3000)  # many duplicates
        keep = rng.random(3000) < 0.7
        idx[~keep & (rng.random(3000) < 0.5)] = 10**6  # dropped rows may hold any index
        for shape in ((3000,), (3000, 6)):
            vals = rng.normal(size=shape).astype(np.float32)
            target = torch.as_tensor(rng.normal(size=(40, *shape[1:])).astype(np.float32))
            before = target.clone()
            out = scatter_sum(target, torch.as_tensor(idx), torch.as_tensor(vals), torch.as_tensor(keep))
            want = before.index_add(0, torch.as_tensor(idx[keep]), torch.as_tensor(vals[keep]))
            assert out.shape == target.shape
            torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
            assert torch.equal(target, before)  # a new tensor; the input is untouched

    def test_scatter_sum_is_thread_count_free(self, monkeypatch):
        """The CPU map build gives the same stats, to the bit, at 1 and at 8
        threads, and they are the one-thread index_put_ accumulate's (each
        row: its start value, then its values in input order). A first
        scatter into zeros, then one into those sums (a nonzero start)."""
        from lidar_slam_tpu_torch.models.registration import ndt as tndt

        rng = np.random.default_rng(5)
        pts = rng.normal(0.0, 1.5, size=(60000, 3)).astype(np.float32)  # ~500 points a voxel at the core
        mask = torch.as_tensor(rng.random(len(pts)) < 0.9)
        cfg = tndt.NDTConfig(grid_dims=(16, 16, 16), max_compact_voxels=4096)
        origin = np.float32([-8.0, -8.0, -8.0])

        def sums():
            s = tndt.empty_ndt_sums(origin, cfg)
            s = tndt.scatter_to_sums(s, torch.as_tensor(pts), mask)
            return tndt.scatter_to_sums(s, torch.as_tensor(pts[::-1].copy()), mask.flip(0), sign=-0.5)

        def index_put_sum(target, index, values, keep):
            n, rows = index.shape[0], target.shape[0]
            idx = torch.where(keep, index, rows + torch.arange(n))
            out = torch.cat([target, target.new_zeros((n, *target.shape[1:]))])
            return out.index_put_((idx,), values, accumulate=True)[:rows]

        threads = torch.get_num_threads()
        try:
            torch.set_num_threads(1)
            one = sums()
            with monkeypatch.context() as m:
                m.setattr(tndt, "scatter_sum", index_put_sum)
                ref = sums()
            torch.set_num_threads(8)
            eight = sums()
        finally:
            torch.set_num_threads(threads)
        for field in ("count", "psum", "ppsum", "wsum"):
            assert torch.equal(getattr(one, field), getattr(eight, field)), field
            assert torch.equal(getattr(one, field), getattr(ref, field)), field
        a, b = tndt.finalize_ndt_sums(one, cfg), tndt.finalize_ndt_sums(eight, cfg)
        assert int((a.keys >= 0).sum()) > 100
        assert torch.equal(a.packed, b.packed) and torch.equal(a.keys, b.keys)

    def test_all_masked(self):
        pts = np.ones((64, 3), np.float32)
        t = t_voxel_downsample(
            TCloud(points=torch.as_tensor(pts), mask=torch.zeros(64, dtype=torch.bool)), 0.5, out_capacity=16
        )
        assert not bool(t.mask.any())


class TestEigh3:
    def test_matches_reference(self):
        rng = np.random.default_rng(2)
        A = rng.normal(size=(512, 3, 3)).astype(np.float32)
        A = A @ A.transpose(0, 2, 1) * np.float32([1.0, 0.3, 0.01])[None, :, None]
        A = 0.5 * (A + A.transpose(0, 2, 1))
        A[0] = np.eye(3) * 2.0  # isotropic
        A[1] = np.diag([1e-6, 1.0, 1.0])  # repeated
        A = A.astype(np.float32)
        ej, vj = j_sym_eigh3(jnp.asarray(A))
        et, vt = t_sym_eigh3(torch.as_tensor(A))
        np.testing.assert_allclose(_np(et), np.asarray(ej), rtol=1e-5, atol=1e-5)
        # same closed form on both sides: eigenvectors agree up to sign, and
        # V diag(l) V^T agrees wherever the basis is degenerate
        np.testing.assert_allclose(np.abs(_np(vt)), np.abs(np.asarray(vj)), atol=2e-3)

        def recon(e, v):
            return v @ (e[:, :, None] * v.transpose(0, 2, 1))

        np.testing.assert_allclose(
            recon(_np(et), _np(vt)), recon(np.asarray(ej), np.asarray(vj)), atol=1e-4
        )


class TestRotatedBoxMask:
    def test_matches_reference(self):
        rng = np.random.default_rng(4)
        pts = rng.uniform(-10, 10, size=(3000, 3)).astype(np.float32)
        boxes = np.concatenate(
            [
                rng.uniform(-8, 8, size=(12, 3)),
                rng.uniform(1, 5, size=(12, 3)),
                rng.uniform(-np.pi, np.pi, size=(12, 1)),
            ],
            axis=1,
        ).astype(np.float32)
        j = np.asarray(j_rotated_box_mask(jnp.asarray(pts), jnp.asarray(boxes)))
        t = _np(t_rotated_box_mask(torch.as_tensor(pts), torch.as_tensor(boxes)))
        np.testing.assert_array_equal(t, j)
        assert t.sum() > 50


class TestMasksAndDenseDownsample:
    def test_range_and_box_masks(self):
        """range_mask and box_crop_mask (tests/test_ops.py:47-56) on seeded
        points, some exactly on the edges: equal to the JAX masks."""
        rng = np.random.default_rng(11)
        pts = rng.uniform(-60, 60, size=(5000, 3)).astype(np.float32)
        pts[:8] = [[1, 0, 0], [50, 0, 0], [0, 0, 0], [np.nan, 0, 0], [-20, 5, 3], [20, -5, -3], [20, 5, 4], [0, 0, -3]]
        for lo, hi in ((0.0, np.inf), (1.0, 50.0), (5.0, 30.0)):
            j = np.asarray(jpc.range_mask(jnp.asarray(pts), min_range=lo, max_range=hi))
            t = _np(tpc.range_mask(_t(pts), min_range=lo, max_range=hi))
            np.testing.assert_array_equal(t, j)
        j = np.asarray(jpc.box_crop_mask(jnp.asarray(pts), [-20, -5, -3], [20, 5, 3]))
        t = _np(tpc.box_crop_mask(_t(pts), [-20, -5, -3], [20, 5, 3]))
        np.testing.assert_array_equal(t, j)
        assert t[4] and t[5] and not t[6] and 5 < t.sum() < len(pts)

    @pytest.mark.parametrize("dims", [(352, 352, 96), (64, 64, 16)])
    def test_voxel_downsample_dense_matches_reference(self, dims):
        """voxel_downsample_dense against the JAX function on
        tests/test_ops.py:141-160's cloud: the same voxels in the same
        order, centroids and weights to 1e-6; with (64, 64, 16) cells most
        points fall outside the grid and are dropped by both."""
        rng = np.random.default_rng(0)
        pts = rng.uniform(-40, 40, (20000, 3)).astype(np.float32)
        pts[:, 2] = rng.uniform(-2, 10, 20000)
        mask = rng.uniform(size=20000) > 0.1
        w = rng.uniform(0, 1, 20000).astype(np.float32)
        j = jpc.voxel_downsample_dense(
            JCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask), weights=jnp.asarray(w)), 0.5,
            out_capacity=16384, dims=dims,
        )
        t = tpc.voxel_downsample_dense(TCloud(points=_t(pts), mask=_t(mask), weights=_t(w)), 0.5,
                                       out_capacity=16384, dims=dims)
        np.testing.assert_array_equal(_np(t.mask), np.asarray(j.mask))
        np.testing.assert_allclose(_np(t.points), np.asarray(j.points), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(t.weights), np.asarray(j.weights), rtol=0, atol=1e-6)
        assert 1000 < int(_np(t.mask).sum()) <= 16384


def _gpf_margins(pts, mask, cfg):
    """The least distance, over GPF's thresholds, of each point from where
    its ground decision flips: |z - (lpr + th_seeds)| for the seed and
    ||plane distance| - th_dist| for each refit, in float64 (the JAX and
    port masks may differ only where this is tiny)."""
    p = pts.astype(np.float64)
    usable = mask & (p[:, 2] > -1.5 * cfg.sensor_height)
    lpr = np.sort(p[usable, 2])[: cfg.num_lpr].mean()
    margin = np.abs(p[:, 2] - (lpr + cfg.th_seeds))
    ground = usable & (p[:, 2] < lpr + cfg.th_seeds)
    for _ in range(cfg.num_iter):
        mu = p[ground].mean(axis=0)
        normal = np.linalg.eigh(np.cov((p[ground] - mu).T, bias=True))[1][:, 0]
        dist = np.abs((p - mu) @ normal)
        margin = np.minimum(margin, np.abs(dist - cfg.th_dist))
        ground = usable & (dist < cfg.th_dist)
    return margin


class TestGroundSeg:
    @pytest.mark.parametrize("seed,tilt", [(0, 0.0), (1, 0.04)])
    def test_matches_reference(self, seed, tilt):
        """segment_ground against the JAX function on a noisy, optionally
        tilted ground with poles, walls and spurious low returns: the masks
        equal except at points within 1e-4 m of th_seeds or th_dist."""
        rng = np.random.default_rng(seed)
        n_g, n_p = 6000, 2000
        gx, gy = rng.uniform(-30, 30, n_g), rng.uniform(-30, 30, n_g)
        ground = np.stack([gx, gy, -1.8 + tilt * gx + rng.normal(0, 0.08, n_g)], axis=-1)
        other = np.stack([rng.uniform(-30, 30, n_p), rng.uniform(-30, 30, n_p), rng.uniform(-2.2, 3.0, n_p)], axis=-1)
        pts = np.concatenate([ground, other, [[0, 0, -9.0], [1, 1, -8.0]]]).astype(np.float32)
        mask = rng.uniform(size=len(pts)) > 0.05
        cfg = jgs.GroundSegConfig()
        gj, nj = (np.asarray(a) for a in jgs.segment_ground(
            JCloud(points=jnp.asarray(np.where(mask[:, None], pts, 0.0)), mask=jnp.asarray(mask)), cfg))
        gt, nt = (_np(a) for a in tgs.segment_ground(
            TCloud(points=_t(np.where(mask[:, None], pts, 0.0)), mask=_t(mask)), tgs.GroundSegConfig()))
        near = _gpf_margins(np.where(mask[:, None], pts, 0.0), mask, cfg) < 1e-4
        np.testing.assert_array_equal(gt[~near], gj[~near])
        np.testing.assert_array_equal(nt[~near], nj[~near])
        assert near.sum() <= 5 and not (gt[-2:] | nt[-2:]).any()
        assert gt[:n_g][mask[:n_g]].mean() > 0.8 and 0.3 < nt[n_g:].mean() < 0.95
