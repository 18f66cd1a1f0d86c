"""Parity of the PyTorch port's NDT module with the JAX package: map build
and incremental maintenance, the derivative reduction (kernel K1's plain
version on the CPU), the host Newton loop, the LM solver, the NDT fitness
score, and the state converter.

Inputs are made with numpy from a seed; the JAX side runs on the CPU (its
fused Pallas kernel in interpret mode). On CPU tensors the port's K1
wrapper runs its plain version; the CUDA kernel itself is checked against
that plain version on the card by tests/test_torch_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.models.registration import ndt as jndt
from lidar_slam_tpu.ops import PointCloud as JCloud

from lidar_slam_tpu_torch import convert
from lidar_slam_tpu_torch.models.registration import ndt as tndt
from lidar_slam_tpu_torch.ops import PointCloud as TCloud
from lidar_slam_tpu_torch.ops.cuda import ndt_fused

CFG_J = jndt.NDTConfig(grid_dims=(32, 32, 16), point_chunk=1024)
CFG_T = tndt.NDTConfig(grid_dims=(32, 32, 16), point_chunk=1024)
ORIGIN = np.asarray([-16.0, -16.0, -8.0], np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def make_scene(n_blobs=40, pts_per_blob=60, seed=0):
    """Anisotropic Gaussian blobs (the JAX tests' scene generator)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-12, 12, size=(n_blobs, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(-2, 4, size=n_blobs)
    pts = []
    for c in centers:
        A = rng.normal(size=(3, 3)) * np.array([0.3, 0.3, 0.05])
        pts.append(c + rng.normal(size=(pts_per_blob, 3)) @ A.astype(np.float32))
    return np.concatenate(pts).astype(np.float32)


def port_map_of(m) -> tndt.NDTMap:
    """The JAX map's leaves, carried into the port (convert.py)."""
    return convert.ndt_map_from_numpy(
        *(np.asarray(getattr(m, k)) for k in
          ("origin", "count", "mean", "icov", "staticvalue", "valid", "index", "packed", "keys")),
        dims=m.dims, resolution=m.resolution, device="cpu",
    )


def port_sums_of(s) -> tndt.NDTMapSums:
    return convert.ndt_sums_from_numpy(
        *(np.asarray(getattr(s, k)) for k in ("origin", "count", "psum", "ppsum", "wsum")),
        dims=s.dims, resolution=s.resolution, device="cpu",
    )


def assert_sums_close(t, j):
    np.testing.assert_array_equal(_np(t.count), np.asarray(j.count))
    np.testing.assert_allclose(_np(t.psum), np.asarray(j.psum), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(t.ppsum), np.asarray(j.ppsum), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(t.wsum), np.asarray(j.wsum), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(t.origin), np.asarray(j.origin))
    assert tuple(t.dims) == tuple(j.dims) and t.resolution == j.resolution


def _degenerate_rows(sums, keys, tol=1e-4):
    """Compact rows whose voxel covariance (float64, from the reference
    sums) has a smallest eigenvalue within `tol` of zero relative to the
    largest. There the valid flag (smallest eigenvalue >= 0) rests on the
    last bits of the float32 moment sums, which summation order changes."""
    keys = np.asarray(keys)
    v = np.maximum(keys, 0)
    n = np.maximum(np.asarray(sums.count, np.float64)[v], 1.0)
    rel = np.asarray(sums.psum, np.float64)[v] / n[:, None]
    pp = np.asarray(sums.ppsum, np.float64)[v] / n[:, None]
    i6 = [[0, 1, 2], [1, 3, 4], [2, 4, 5]]
    cov = pp[:, i6] - rel[:, :, None] * rel[:, None, :]
    ev = np.linalg.eigvalsh(cov)
    return (keys >= 0) & (np.abs(ev[:, 0]) <= tol * np.maximum(ev[:, 2], 1e-30))


def assert_maps_close(t, j, dense=True, sums_j=None):
    """Keys and index exact; packed rows to f32 rounding of the moment sums
    (icov amplifies it near degeneracy). Valid flags are exact, except on
    rows `_degenerate_rows` waives when the reference sums are given."""
    np.testing.assert_array_equal(_np(t.keys), np.asarray(j.keys))
    np.testing.assert_array_equal(_np(t.index), np.asarray(j.index))
    tp, jp = _np(t.packed), np.asarray(j.packed)
    flip = tp[:, 10] != jp[:, 10]
    if flip.any():
        assert sums_j is not None, f"valid flags differ on rows {np.flatnonzero(flip)}"
        waived = _degenerate_rows(sums_j, np.asarray(j.keys))
        assert not (flip & ~waived).any(), f"valid flags differ on rows {np.flatnonzero(flip & ~waived)}"
    np.testing.assert_allclose(tp[:, :4], jp[:, :4], rtol=1e-5, atol=1e-5)  # mean, weight
    both = ~flip
    np.testing.assert_allclose(tp[both, 4:10], jp[both, 4:10], rtol=2e-3, atol=1e-2)  # icov
    np.testing.assert_array_equal(tp[:, 11:], jp[:, 11:])  # count, pad
    np.testing.assert_array_equal(_np(t.count), np.asarray(j.count))
    if dense:
        tv, jv = _np(t.valid), np.asarray(j.valid)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_allclose(_np(t.mean), np.asarray(j.mean), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(t.icov), np.asarray(j.icov), rtol=2e-3, atol=1e-2)
        np.testing.assert_allclose(_np(t.staticvalue), np.asarray(j.staticvalue), rtol=1e-5, atol=1e-6)


class TestMapSide:
    def _clouds(self):
        rng = np.random.default_rng(3)
        a = make_scene(12, 40, seed=0)
        b = make_scene(12, 40, seed=1)
        wa = rng.uniform(0.2, 1.0, len(a)).astype(np.float32)
        mb = rng.random(len(b)) < 0.8
        return a, wa, b, mb

    def test_build_ndt_map(self):
        pts = make_scene(20, 50, seed=1)
        w = np.random.default_rng(2).uniform(0.2, 1.0, len(pts)).astype(np.float32)
        j = jndt.build_ndt_map(JCloud.from_points(pts, weights=w), CFG_J, origin=jnp.asarray(ORIGIN))
        t = tndt.build_ndt_map(TCloud.from_points(pts, weights=w), CFG_T, origin=ORIGIN)
        assert_maps_close(t, j)
        # origin inferred from the cloud
        j2 = jndt.build_ndt_map(JCloud.from_points(pts), CFG_J)
        t2 = tndt.build_ndt_map(TCloud.from_points(pts), CFG_T)
        np.testing.assert_array_equal(_np(t2.origin), np.asarray(j2.origin))
        assert_maps_close(t2, j2)

    def test_scatter_add_evict_finalize(self):
        a, wa, b, mb = self._clouds()
        js = jndt.empty_ndt_sums(jnp.asarray(ORIGIN), CFG_J)
        ts = tndt.empty_ndt_sums(ORIGIN, CFG_T)
        js = jndt.scatter_to_sums(js, jnp.asarray(a), jnp.ones(len(a), bool), jnp.asarray(wa))
        ts = tndt.scatter_to_sums(ts, _t(a), torch.ones(len(a), dtype=torch.bool), _t(wa))
        js = jndt.scatter_to_sums(js, jnp.asarray(b), jnp.asarray(mb))
        ts = tndt.scatter_to_sums(ts, _t(b), _t(mb))
        assert_sums_close(ts, js)
        assert_maps_close(tndt.finalize_ndt_sums(ts, CFG_T), jndt.finalize_ndt_sums(js, CFG_J), sums_j=js)

        # signed evict of `a` plus a re-add of `b` in one pass
        both = np.concatenate([a, b])
        signs = np.concatenate([-np.ones(len(a)), np.ones(len(b))]).astype(np.float32)
        mask = np.concatenate([np.ones(len(a), bool), mb])
        w = np.concatenate([wa, np.ones(len(b), np.float32)])
        js = jndt.scatter_to_sums(js, jnp.asarray(both), jnp.asarray(mask), jnp.asarray(w), signs=jnp.asarray(signs))
        ts = tndt.scatter_to_sums(ts, _t(both), _t(mask), _t(w), signs=_t(signs))
        assert_sums_close(ts, js)
        cfg_j = dataclasses.replace(CFG_J, dense_stats=False, max_compact_voxels=300)
        cfg_t = dataclasses.replace(CFG_T, dense_stats=False, max_compact_voxels=300)
        assert_maps_close(
            tndt.finalize_ndt_sums(ts, cfg_t), jndt.finalize_ndt_sums(js, cfg_j), dense=False, sums_j=js
        )

    def test_recenter_and_coarsen(self):
        a, wa, b, mb = self._clouds()
        js = jndt.scatter_to_sums(
            jndt.empty_ndt_sums(jnp.asarray(ORIGIN), CFG_J), jnp.asarray(a), jnp.ones(len(a), bool), jnp.asarray(wa)
        )
        ts = tndt.scatter_to_sums(
            tndt.empty_ndt_sums(ORIGIN, CFG_T), _t(a), torch.ones(len(a), dtype=torch.bool), _t(wa)
        )
        for shift in ([4.0, -2.0, 2.0], [-6.0, 8.0, -2.0], [40.0, 0.0, 0.0]):
            new_origin = ORIGIN + np.float32(shift)
            jr = jndt.recenter_ndt_sums(js, jnp.asarray(new_origin))
            tr = tndt.recenter_ndt_sums(ts, new_origin)
            assert_sums_close(tr, jr)
        # coarsen needs the origin on the 2*res lattice: ORIGIN is
        jc = jndt.coarsen_ndt_sums(js)
        tc = tndt.coarsen_ndt_sums(ts)
        np.testing.assert_array_equal(_np(tc.count), np.asarray(jc.count))
        np.testing.assert_allclose(_np(tc.psum), np.asarray(jc.psum), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(_np(tc.ppsum), np.asarray(jc.ppsum), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(_np(tc.wsum), np.asarray(jc.wsum), rtol=1e-5, atol=1e-5)
        assert tc.dims == tuple(jc.dims) and tc.resolution == jc.resolution
        ccfg_j = jndt.NDTConfig(resolution=2.0, grid_dims=(16, 16, 8), dense_stats=False)
        ccfg_t = tndt.NDTConfig(resolution=2.0, grid_dims=(16, 16, 8), dense_stats=False)
        assert_maps_close(
            tndt.finalize_ndt_sums(tc, ccfg_t), jndt.finalize_ndt_sums(jc, ccfg_j), dense=False, sums_j=jc
        )

    def test_convert_round_trip(self):
        pts = make_scene(10, 40, seed=9)
        j = jndt.build_ndt_map(JCloud.from_points(pts), CFG_J, origin=jnp.asarray(ORIGIN))
        t = port_map_of(j)
        for k in ("origin", "count", "mean", "icov", "staticvalue", "valid", "index", "packed", "keys"):
            np.testing.assert_array_equal(_np(getattr(t, k)), np.asarray(getattr(j, k)), err_msg=k)
        assert t.dims == tuple(j.dims) and t.resolution == j.resolution
        js = jndt.scatter_to_sums(
            jndt.empty_ndt_sums(jnp.asarray(ORIGIN), CFG_J), jnp.asarray(pts), jnp.ones(len(pts), bool)
        )
        ts = port_sums_of(js)
        for k in ("origin", "count", "psum", "ppsum", "wsum"):
            np.testing.assert_array_equal(_np(getattr(ts, k)), np.asarray(getattr(js, k)), err_msg=k)
        cfg = convert.config_from_fields(tndt.NDTConfig, dataclasses.asdict(CFG_J))
        assert cfg == CFG_T


class TestAlignSide:
    def test_stencils_and_angle_tensors(self):
        np.testing.assert_array_equal(ndt_fused.STENCIL_OFFSETS["direct7"], jndt._stencil7())
        np.testing.assert_array_equal(ndt_fused.STENCIL_OFFSETS["radius27"], jndt._stencil27())
        for pose in ([0.1, -0.2, 0.3, 0.2, -0.4, 0.7], [0.0, 0.0, 0.0, 5e-5, -0.3, 1e-5]):
            pose = np.asarray(pose, np.float32)
            jj, jh = jndt._angle_jacobian_tensors(jnp.asarray(pose))
            tj, th = tndt._angle_jacobian_tensors(pose)
            np.testing.assert_allclose(tj, np.asarray(jj), atol=1e-6)
            np.testing.assert_allclose(th, np.asarray(jh), atol=1e-6)

    def test_solve_newton(self):
        rng = np.random.default_rng(0)
        for _ in range(4):
            A = rng.normal(size=(6, 6)).astype(np.float32)
            H = (A @ A.T - 2.0 * np.eye(6)).astype(np.float32)  # indefinite
            g = rng.normal(size=6).astype(np.float32)
            np.testing.assert_allclose(
                tndt._solve_newton(H, g), np.asarray(jndt._solve_newton(jnp.asarray(H), jnp.asarray(g))),
                rtol=1e-4, atol=1e-5,
            )

    def test_onehot_gather_equals_two_level(self):
        """gather="onehot" fetches the same rows by key (K3's plain version
        on the CPU), so its sums equal two_level's; an unknown mode raises."""
        pts = make_scene(5, 30, seed=0)
        m = tndt.build_ndt_map(TCloud.from_points(pts), CFG_T, origin=ORIGIN)
        args = (m, _t(pts), torch.ones(len(pts), dtype=torch.bool), np.zeros(6, np.float32))
        onehot = tndt.ndt_derivatives(*args, dataclasses.replace(CFG_T, gather="onehot"))
        two_level = tndt.ndt_derivatives(*args, CFG_T)
        for a, b in zip(onehot, two_level):
            np.testing.assert_array_equal(_np(a), _np(b))
        with pytest.raises(ValueError, match="gather"):
            tndt.ndt_derivatives(*args, dataclasses.replace(CFG_T, gather="sorted"))

    @pytest.mark.parametrize("stencil", ["direct7", "radius27"])
    @pytest.mark.parametrize("weight_derivatives", [True, False])
    def test_derivatives_match_two_level(self, stencil, weight_derivatives):
        """Port (plain K1 path) vs JAX two_level on the SAME map, converted."""
        pts = make_scene(20, 50, seed=1)
        rng = np.random.default_rng(2)
        w_map = rng.uniform(0.2, 1.0, len(pts)).astype(np.float32)
        cfg_j = dataclasses.replace(CFG_J, stencil=stencil, weight_derivatives=weight_derivatives)
        cfg_t = dataclasses.replace(CFG_T, stencil=stencil, weight_derivatives=weight_derivatives, gather="auto")
        jm = jndt.build_ndt_map(JCloud.from_points(pts, weights=w_map), cfg_j, origin=jnp.asarray(ORIGIN))
        tm = port_map_of(jm)
        src = pts[rng.choice(len(pts), 700, replace=False)] + rng.normal(0, 0.02, (700, 3)).astype(np.float32)
        mask = rng.random(700) < 0.95
        w = rng.uniform(0.2, 1.0, 700).astype(np.float32)
        pose = np.asarray([0.05, -0.03, 0.02, 0.01, -0.02, 0.03], np.float32)
        sj, gj, hj = jndt.ndt_derivatives(jm, jnp.asarray(src), jnp.asarray(mask), jnp.asarray(pose), cfg_j, True, weights=jnp.asarray(w))
        st, gt, ht, ut = tndt.ndt_derivatives(tm, _t(src), _t(mask), pose, cfg_t, True, weights=_t(w), return_unresolved=True)
        assert float(ut) == 0.0
        np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)
        np.testing.assert_allclose(_np(gt), np.asarray(gj), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(_np(ht), np.asarray(hj), rtol=1e-4, atol=1e-3)

        # a non-finite point, even unmasked, contributes nothing (the fused
        # reference's isfinite guard; the JAX two_level path would give NaN)
        mask[5] = False
        s0, g0, h0 = tndt.ndt_derivatives(tm, _t(src), _t(mask), pose, cfg_t, True, weights=_t(w))
        src[5], mask[5] = np.nan, True
        sn, gn, hn = tndt.ndt_derivatives(tm, _t(src), _t(mask), pose, cfg_t, True, weights=_t(w))
        assert float(sn) == float(s0)
        np.testing.assert_array_equal(_np(gn), _np(g0))
        np.testing.assert_array_equal(_np(hn), _np(h0))

    @pytest.mark.parametrize("stencil", ["direct7", "radius27"])
    def test_derivatives_match_fused_pallas(self, stencil):
        """Port vs the JAX fused Pallas kernel (interpret mode) on the
        TestFusedKernel setup of tests/test_ndt.py, same map."""
        pts = make_scene(25, 50, seed=3)
        cfg_j = dataclasses.replace(CFG_J, stencil=stencil, max_compact_voxels=2048, fused_window=512)
        cfg_t = dataclasses.replace(CFG_T, stencil=stencil, max_compact_voxels=2048, gather="fused")
        jm = jndt.build_ndt_map(JCloud.from_points(pts), cfg_j, origin=jnp.asarray(ORIGIN))
        rng = np.random.default_rng(5)
        src = pts[rng.permutation(len(pts))[:1024]]
        weights = rng.uniform(0.2, 1.0, size=1024).astype(np.float32)
        pose6 = np.asarray([0.12, -0.08, 0.03, 0.01, -0.02, 0.04], np.float32)
        sj, gj, hj, uj = jndt._ndt_derivatives_fused(
            jm, jnp.asarray(src), jnp.ones(1024, bool), jnp.asarray(pose6), cfg_j, jnp.asarray(weights), True
        )
        assert float(uj) == 0.0
        st, gt, ht = tndt.ndt_derivatives(
            port_map_of(jm), _t(src), torch.ones(1024, dtype=torch.bool), pose6, cfg_t, True, weights=_t(weights)
        )
        # the tolerances of tests/test_ndt.py::TestFusedKernel
        np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)
        np.testing.assert_allclose(_np(gt), np.asarray(gj), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(_np(ht), np.asarray(hj), rtol=1e-4, atol=1e-3)

    def _fused_setup(self, cfg_j, cfg_t):
        """tests/test_ndt.py::TestFusedKernel's scene: map, weighted source."""
        pts = make_scene(25, 50, seed=3)
        jm = jndt.build_ndt_map(JCloud.from_points(pts), cfg_j, origin=jnp.asarray(ORIGIN))
        rng = np.random.default_rng(5)
        src = pts[rng.permutation(len(pts))[:1024]]
        weights = rng.uniform(0.2, 1.0, size=1024).astype(np.float32)
        guess = np.eye(4, dtype=np.float32)
        guess[:3, 3] = [0.25, -0.15, 0.05]
        return pts, jm, src, weights, guess

    @pytest.mark.parametrize("port_map", [True, False])
    @pytest.mark.parametrize("max_step_iterations", [0, 10])
    def test_align_parity(self, port_map, max_step_iterations):
        """Same optimum as the JAX align (test_ndt.py:234-243, atol 5e-3),
        on the JAX map carried over and on the port's own build of it, for
        the clamped Newton step and the More-Thuente line search."""
        kw = dict(stencil="direct7", max_compact_voxels=2048, max_step_iterations=max_step_iterations)
        cfg_j = dataclasses.replace(CFG_J, **kw)
        cfg_t = dataclasses.replace(CFG_T, **kw)
        pts, jm, src, w, guess = self._fused_setup(cfg_j, cfg_t)
        tm = port_map_of(jm) if port_map else tndt.build_ndt_map(TCloud.from_points(pts), cfg_t, origin=ORIGIN)
        rj = jndt.ndt_align(jm, JCloud.from_points(src, weights=w), jnp.asarray(guess), cfg_j)
        rt = tndt.ndt_align(tm, TCloud.from_points(src, weights=w), torch.as_tensor(guess), cfg_t)
        np.testing.assert_allclose(_np(rt.pose), np.asarray(rj.pose), atol=5e-3)
        assert rt.unresolved == 0.0

    def test_small_offset_recovery(self):
        """tests/test_ndt.py::TestAlign's recovery bounds on the port alone.
        (Pose parity with JAX is not asserted on this scene: the Hessian is
        indefinite for the first iterations, and the two packages' iterates,
        equal to 1e-7 for three steps, then part by float32 summation order
        and stop at different points of the flat optimum.)"""
        from lidar_slam_tpu.geom import pose_inverse, se3_exp, se3_log, transform_points

        pts = make_scene(40, 60, seed=4)
        tm = tndt.build_ndt_map(TCloud.from_points(pts), CFG_T, origin=ORIGIN)
        T_true = se3_exp(jnp.asarray([0.3, -0.2, 0.1, 0.02, -0.01, 0.03], jnp.float32))
        sel = np.random.default_rng(5).choice(len(pts), 1500, replace=False)
        src = np.asarray(transform_points(pose_inverse(T_true), jnp.asarray(pts[sel])))
        r = tndt.ndt_align(tm, TCloud.from_points(src), torch.eye(4), CFG_T)
        err = np.asarray(se3_log(pose_inverse(T_true) @ jnp.asarray(_np(r.pose))))
        assert np.abs(err[:3]).max() < 0.1, err
        assert np.abs(err[3:]).max() < 0.02, err

    def test_empty_map_keeps_the_guess(self):
        m = tndt.finalize_ndt_sums(tndt.empty_ndt_sums(ORIGIN, CFG_T), CFG_T)
        guess = torch.eye(4)
        guess[:3, 3] = torch.tensor([0.5, -0.25, 0.125])
        src = TCloud.from_points(make_scene(3, 20, seed=0))
        r = tndt.ndt_align(m, src, guess, CFG_T)
        np.testing.assert_allclose(_np(r.pose), _np(guess), atol=1e-6)
        assert r.converged and r.iterations == 1


class TestLMAndFitness:
    """lm_align and ndt_fitness_score on tests/test_ndt.py's scenes."""

    @pytest.mark.parametrize("gather", ["two_level", "fused"])
    def test_lm_matches_reference(self, gather):
        """ndt_align(solver="lm") against the JAX package's on
        tests/test_ndt.py:271-285's scene: poses within 5e-3 m / rad (the
        iteration counts may differ: accept or reject turns on float32
        noise), both recovering the identity. gather="fused" is the card's
        branch: each evaluation goes through K1's wrapper (its plain version
        here), once per LM evaluation."""
        pts = make_scene(30, 60, seed=2)
        jm = jndt.build_ndt_map(JCloud.from_points(pts), CFG_J, origin=jnp.asarray(ORIGIN))
        guess = np.eye(4, dtype=np.float32)
        guess[:3, 3] = [0.2, 0.1, 0.0]
        rj = jndt.ndt_align(jm, JCloud.from_points(pts[:1500], capacity=1500), jnp.asarray(guess),
                            dataclasses.replace(CFG_J, solver="lm"))
        calls = []
        plain = ndt_fused.ndt_reduce_plain
        with pytest.MonkeyPatch.context() as mp:
            # K1's wrapper takes its plain version (fused); two_level calls it directly
            for module in (ndt_fused, tndt):
                mp.setattr(module, "ndt_reduce_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
            rt = tndt.ndt_align(port_map_of(jm), TCloud.from_points(pts[:1500]), torch.as_tensor(guess),
                                dataclasses.replace(CFG_T, solver="lm", gather=gather))
        pj, pt = np.asarray(rj.pose), _np(rt.pose)
        np.testing.assert_allclose(pt[:3, 3], pj[:3, 3], atol=5e-3)
        np.testing.assert_allclose(pt[:3, :3], pj[:3, :3], atol=5e-3)
        assert np.linalg.norm(pt[:3, 3]) < 0.05 and np.linalg.norm(pj[:3, 3]) < 0.05
        assert len(calls) == rt.iterations + 1 and rt.unresolved == 0.0
        np.testing.assert_allclose(rt.score, float(rj.score), rtol=1e-3)

    def test_lm_does_not_follow_thread_count(self):
        """ndt_align(solver="lm") on the plain reduction (gather two_level)
        from tests/test_torch_cuda.py's far start, 5000 points, radius27:
        the same pose to the bit and the same evaluations at one torch
        thread and at eight, so its accept or reject cannot follow the
        thread count."""
        import test_torch_cuda

        m, src, mask, w = test_torch_cuda._inputs(torch.device("cpu"))
        cfg = dataclasses.replace(test_torch_cuda.CFG, solver="lm", gather="two_level", stencil="radius27")
        guess = tndt._pose_to_matrix(np.asarray(test_torch_cuda.NEWTON_POSES[1], np.float32))
        frame = TCloud(points=src, mask=mask, weights=w)
        threads = torch.get_num_threads()
        runs = []
        try:
            for n in (1, 8):
                torch.set_num_threads(n)
                runs.append(tndt.ndt_align(m, frame, torch.as_tensor(guess), cfg))
        finally:
            torch.set_num_threads(threads)
        a, b = runs
        assert a.iterations == b.iterations and a.score == b.score
        np.testing.assert_array_equal(_np(a.pose), _np(b.pose))

    def test_lm_rejects_bad_steps(self):
        """From a guess where the damped step lowers the score, the trial is
        rejected, the pose kept and lambda grown ninefold until a step is
        accepted; a step of 0 (singular system) is never accepted."""
        H = -np.eye(6, dtype=np.float32)
        g = np.zeros(6, np.float32)
        delta, bad = tndt._solve_damped(-H, -g, np.float32(1e-4))
        assert not bad and np.all(delta == 0.0)
        delta, bad = tndt._solve_damped(np.zeros((6, 6), np.float32), np.ones(6, np.float32), np.float32(0.0))
        assert bad and np.all(delta == 0.0)
        evals = []

        def derivs(p, _):
            evals.append(p.copy())
            score = -np.float32(np.sum((p - 1.0) ** 2)) - (np.float32(10.0) if len(evals) == 2 else 0.0)
            return score, -2.0 * (p - 1.0), -2.0 * np.eye(6, dtype=np.float32), np.float32(0.0)

        r = tndt.lm_align(derivs, np.eye(4, dtype=np.float32), CFG_T, 1)
        # the first trial is rejected: the next starts from the same pose with a shorter step
        assert np.all(evals[0] == 0.0) and np.all((0.0 < evals[2]) & (evals[2] < evals[1]))
        assert r.converged and r.iterations < CFG_T.max_iter
        np.testing.assert_allclose(tndt._matrix_to_pose(r.pose), np.ones(6), atol=2e-2)

    def test_fitness_matches_reference(self):
        """ndt_fitness_score against the JAX function (tests/test_ndt.py:
        180-190's scene) at a good and a bad pose and at a max_range whose
        stencil reaches its cap, within 1e-5 relative; a map without dense
        stats raises."""
        pts = make_scene(30, 50, seed=7)
        jm = jndt.build_ndt_map(JCloud.from_points(pts), CFG_J, origin=jnp.asarray(ORIGIN))
        tm = port_map_of(jm)
        rng = np.random.default_rng(5)
        src = pts[:500] + rng.normal(0, 0.05, (500, 3)).astype(np.float32)
        mask = rng.uniform(size=500) > 0.1
        bad = np.eye(4, dtype=np.float32)
        bad[:3, 3] = [1.5, 1.5, 0.0]
        bad[:2, :2] = [[np.cos(0.2), -np.sin(0.2)], [np.sin(0.2), np.cos(0.2)]]
        fits = []
        for T, max_range in ((np.eye(4, dtype=np.float32), 4.0), (bad, 4.0), (bad, 10.0), (bad, 0.5)):
            fj = float(jndt.ndt_fitness_score(jm, JCloud(points=jnp.asarray(src), mask=jnp.asarray(mask)),
                                              jnp.asarray(T), CFG_J, max_range=max_range))
            ft = float(tndt.ndt_fitness_score(tm, TCloud(points=_t(src), mask=_t(mask)), torch.as_tensor(T), CFG_T,
                                              max_range=max_range))
            np.testing.assert_allclose(ft, fj, rtol=1e-5)
            fits.append(ft)
        assert fits[0] < 0.5 < fits[1]
        sparse = tndt.build_ndt_map(TCloud.from_points(pts), dataclasses.replace(CFG_T, dense_stats=False),
                                    origin=ORIGIN)
        with pytest.raises(ValueError, match="dense"):
            tndt.ndt_fitness_score(sparse, TCloud.from_points(src), torch.eye(4), CFG_T)
