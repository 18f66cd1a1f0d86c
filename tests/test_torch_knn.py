"""Parity of the port's bucket grid, kernel K2's plain version (exact gated
k-NN) and kernel K3's plain version (the NDT stat gather by key) with the
JAX package.

Inputs are made with numpy from a seed and fed to both packages; the JAX
side runs on the CPU, its Pallas kernels in interpret mode. On CPU tensors
the port's kernel wrappers run their plain versions; the CUDA kernels
themselves are held against those on the card by tests/test_torch_cuda.py.
Grids, selections and gathered rows are compared exactly: both sides
compute every distance as (dx*dx + dy*dy) + dz*dz in float32 and break ties
on the same index. Distances are compared to 1e-6 relative (XLA may
associate the sum of squares otherwise: one ulp).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.models.registration import ndt as jndt
from lidar_slam_tpu.ops import PointCloud as JCloud
from lidar_slam_tpu.ops import hashgrid as jgrid
from lidar_slam_tpu.ops.pallas import knn_fused as jknn
from lidar_slam_tpu.ops.pallas import ndt_reduce as jreduce

from lidar_slam_tpu_torch import convert
from lidar_slam_tpu_torch.models.registration import ndt as tndt
from lidar_slam_tpu_torch.ops import PointCloud as TCloud
from lidar_slam_tpu_torch.ops import hashgrid as tgrid
from lidar_slam_tpu_torch.ops.cuda import knn_fused, ndt_gather

ORIGIN = np.asarray([-8.0, -8.0, -4.0], np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cloud(n=600, seed=0, extent=7.5, dup=0):
    """Uniform points, 10% masked, the last `dup` rows copies of the first."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    pts[:, 2] *= 0.4
    if dup:
        pts[-dup:] = pts[:dup]
    mask = rng.random(n) < 0.9
    if dup:
        mask[:dup] = mask[-dup:] = True
    return pts, mask


def _grids(pts, mask, cell, dims, origin):
    j = jgrid.build_bucket_grid(
        JCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask)), cell, dims,
        origin=None if origin is None else jnp.asarray(origin),
    )
    t = tgrid.build_bucket_grid(TCloud(points=torch.as_tensor(pts), mask=torch.as_tensor(mask)), cell, dims, origin)
    return j, t


class TestBucketGrid:
    @pytest.mark.parametrize("origin", [ORIGIN, None], ids=["explicit_origin", "centroid_origin"])
    def test_build_matches_reference(self, origin):
        pts, mask = _cloud(dup=40)
        pts[:5] = 50.0  # outside the grid: dropped
        j, t = _grids(pts, mask, 1.0, (16, 16, 8), origin)
        # the default origin is the masked centroid: a float32 sum taken in
        # another order (one ulp); no point of this cloud lies that close to
        # a cell boundary, so the grids agree exactly
        np.testing.assert_allclose(_np(t.origin), np.asarray(j.origin), rtol=0, atol=1e-6)
        for k in ("points", "point_idx", "valid", "cell_starts", "cell_counts"):
            np.testing.assert_array_equal(_np(getattr(t, k)), np.asarray(getattr(j, k)), err_msg=k)
        assert t.cell_size == float(j.cell_size) and t.dims == tuple(j.dims)

    def test_knn_query_matches_reference_and_brute_force(self):
        """tests/test_ops.py::TestBucketGridKNN's case through both packages."""
        rng = np.random.default_rng(2)
        targets = rng.uniform(-8, 8, size=(500, 3)).astype(np.float32)
        queries = rng.uniform(-8, 8, size=(100, 3)).astype(np.float32)
        origin = np.full(3, -16.0, np.float32)
        j, t = _grids(targets, np.ones(500, bool), 2.0, (16, 16, 16), origin)
        ji, jd, jo = (np.asarray(a) for a in jgrid.knn_query(j, jnp.asarray(queries), k=3, max_radius=2.0, bucket_k=32, chunk=64))
        ti, td, to = (_np(a) for a in tgrid.knn_query(t, torch.as_tensor(queries), k=3, max_radius=2.0, bucket_k=32, chunk=64))
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(ti[to], ji[jo])
        np.testing.assert_allclose(td, jd, rtol=1e-6)

        d = np.linalg.norm(targets[None] - queries[:, None], axis=-1)
        d[d > 2.0] = np.inf
        bidx = np.argsort(d, axis=1, kind="stable")[:, :3]
        bdist = np.take_along_axis(d, bidx, axis=1)
        np.testing.assert_array_equal(to, np.isfinite(bdist))
        np.testing.assert_array_equal(ti[to], bidx[to])
        np.testing.assert_allclose(td[to], bdist[to], atol=1e-5)

    def test_knn_query_bucket_cut(self):
        """A cell holding more than bucket_k points is truncated, as in JAX."""
        pts = np.zeros((40, 3), np.float32) + np.float32([0.3, 0.3, 0.3])
        pts += np.random.default_rng(0).normal(0, 0.01, (40, 3)).astype(np.float32)
        q = np.asarray([[0.3, 0.3, 0.3], [5.0, 5.0, 5.0]], np.float32)
        origin = np.full(3, -4.0, np.float32)
        j, t = _grids(pts, np.ones(40, bool), 1.0, (8, 8, 8), origin)
        jr = jgrid.knn_query(j, jnp.asarray(q), k=6, max_radius=1.0, bucket_k=4, chunk=2)
        tr = tgrid.knn_query(t, torch.as_tensor(q), k=6, max_radius=1.0, bucket_k=4, chunk=2)
        np.testing.assert_array_equal(_np(tr[0]), np.asarray(jr[0]))
        np.testing.assert_allclose(_np(tr[1]), np.asarray(jr[1]), rtol=1e-6)
        np.testing.assert_array_equal(_np(tr[2]), np.asarray(jr[2]))
        assert _np(tr[2])[0].sum() == 4 and not _np(tr[2])[1].any()


def _extras(kind, n, rng):
    """Per-target-point extras in the caller's layout: None, or
    '<dtype>_<E>' ([N] for int32_1d, else [N, E])."""
    if kind is None:
        return None
    if kind == "int32_1d":
        return rng.integers(0, 64, n).astype(np.int32)
    dtype, e = kind.split("_")
    if dtype == "int32":
        return rng.integers(-1000, 1000, (n, int(e))).astype(np.int32)
    return rng.normal(size=(n, int(e))).astype(np.float32)


class TestExactKnn:
    @pytest.mark.parametrize("k,radius,extras_kind", [
        (5, 1.0, None), (8, 2.0, "int32_1d"), (8, 2.0, "float32_3"), (5, 1.0, "int32_0"), (5, 2.0, "float32_1"),
        (8, 1.0, "int32_3"),
    ])
    def test_plain_matches_window_knn(self, k, radius, extras_kind):
        """knn_exact_plain vs the JAX kernel (interpret mode). The table has
        <= 2048 rows, so the kernel's window is the whole table and its
        `unresolved` is 0: its result is exact gated k-NN too. Duplicate
        points tie exactly; both break the tie on the lower sorted row.
        Queries come unsorted, some masked, some non-finite, one outside
        the grid. Extras: int32 or float32, [N] or [N, E] with E = 0, 1, 3;
        both return them as float32 [Q, k, E]."""
        pts, mask = _cloud(n=1500, seed=3, dup=60)
        rng = np.random.default_rng(4)
        queries = np.concatenate([
            pts[:60],  # on the duplicated points
            rng.uniform(-8, 8, size=(300, 3)).astype(np.float32),
            np.float32([[40.0, 0.0, 0.0], [-7.9, 7.9, -3.9]]),  # outside / at the grid edge
            np.float32([[np.nan, 0.0, 0.0], [0.0, np.inf, 0.0]]),  # non-finite, masked in
        ])
        qmask = rng.random(len(queries)) < 0.85
        qmask[:60] = True
        qmask[-2:] = True
        extras = _extras(extras_kind, len(pts), rng)
        cell = max(radius, 1.0)
        j, t = _grids(pts, mask, cell, (16, 16, 8), ORIGIN)

        jr = jknn.window_knn(
            j, jnp.asarray(queries), jnp.asarray(qmask), k=k, max_radius=radius,
            extras=None if extras is None else jnp.asarray(extras), interpret=True,
        )
        assert float(jr["unresolved"]) == 0.0
        tr = knn_fused.knn_exact_plain(
            t, torch.as_tensor(queries), torch.as_tensor(qmask), k, radius,
            extras=None if extras is None else torch.as_tensor(extras),
        )
        assert set(tr) == set(jr)
        ok = np.asarray(jr["ok"])
        assert ok[:60, :2].all() and ok.sum() > 200 and not ok[~qmask].any() and not ok[-2:].any()
        for key in ("ok", "idx", "pts") + (("extras",) if extras is not None else ()):
            np.testing.assert_array_equal(_np(tr[key]), np.asarray(jr[key]), err_msg=key)
        if extras is not None:
            e = 1 if extras.ndim == 1 else extras.shape[1]
            assert tr["extras"].dtype == torch.float32 and tuple(tr["extras"].shape) == (len(queries), k, e)
        np.testing.assert_allclose(_np(tr["dist"]), np.asarray(jr["dist"]), rtol=1e-6)
        assert float(tr["unresolved"]) == 0.0

    @pytest.mark.parametrize("extras_kind", [None, "int32_1d", "float32_3"])
    def test_wrapper_takes_plain_on_cpu(self, extras_kind):
        """On CPU tensors window_knn is the plain version, launches nothing,
        and returns the dict's layout: idx int32 [Q, k], dist float32, ok
        bool, pts float32 [Q, k, 3], extras float32 [Q, k, E], unresolved a
        float32 scalar 0."""
        pts, mask = _cloud(n=400, seed=5)
        _, t = _grids(pts, mask, 1.0, (16, 16, 8), ORIGIN)
        q, qm = torch.as_tensor(pts[:50]), torch.ones(50, dtype=torch.bool)
        ex = _extras(extras_kind, len(pts), np.random.default_rng(6))
        ex = None if ex is None else torch.as_tensor(ex)
        before = knn_fused.launches
        a = knn_fused.window_knn(t, q, qm, 5, 1.0, ex)
        b = knn_fused.knn_exact_plain(t, q, qm, 5, 1.0, ex)
        assert knn_fused.launches == before
        assert set(a) == {"idx", "dist", "ok", "pts", "unresolved"} | ({"extras"} if ex is not None else set())
        for key in a:
            assert torch.equal(a[key], b[key]), key
        layout = {"idx": (torch.int32, (50, 5)), "dist": (torch.float32, (50, 5)), "ok": (torch.bool, (50, 5)),
                  "pts": (torch.float32, (50, 5, 3)), "unresolved": (torch.float32, ())}
        if ex is not None:
            layout["extras"] = (torch.float32, (50, 5, 1 if ex.ndim == 1 else ex.shape[1]))
        assert {key: (v.dtype, tuple(v.shape)) for key, v in a.items()} == layout
        assert float(a["unresolved"]) == 0.0 and a["ok"][torch.as_tensor(mask[:50]), 0].all()  # each finds itself
        with pytest.raises(ValueError, match="cell_size"):
            knn_fused.window_knn(t, q, qm, 5, 1.5)

    def test_rejects_bad_extras(self):
        pts, mask = _cloud(n=400, seed=5)
        _, t = _grids(pts, mask, 1.0, (16, 16, 8), ORIGIN)
        q, qm = torch.as_tensor(pts[:50]), torch.ones(50, dtype=torch.bool)
        with pytest.raises(ValueError, match="dtype"):
            knn_fused.window_knn(t, q, qm, 5, 1.0, torch.zeros(400, dtype=torch.int64))
        with pytest.raises(ValueError, match="shape"):
            knn_fused.window_knn(t, q, qm, 5, 1.0, torch.zeros(399, dtype=torch.int32))

    def test_plain_is_order_free(self):
        """The result of a query does not depend on where it stands among
        the others (the kernel's random-order check, on the CPU)."""
        pts, mask = _cloud(n=800, seed=7, dup=30)
        _, t = _grids(pts, mask, 2.0, (16, 16, 8), ORIGIN)
        rng = np.random.default_rng(8)
        q = torch.as_tensor(np.concatenate([pts[:30], rng.uniform(-8, 8, (200, 3)).astype(np.float32)]))
        qm = torch.as_tensor(rng.random(len(q)) < 0.9)
        ring = torch.as_tensor(rng.integers(0, 64, len(pts)).astype(np.int32))
        perm = torch.as_tensor(rng.permutation(len(q)))
        a = knn_fused.knn_exact_plain(t, q, qm, 8, 2.0, ring)
        b = knn_fused.knn_exact_plain(t, q[perm], qm[perm], 8, 2.0, ring)
        for key in ("idx", "dist", "ok", "pts", "extras"):
            assert torch.equal(a[key][perm], b[key]), key


def _onehot_case(dup_key: bool):
    """tests/test_pallas_gather.py::test_matches_direct_indexing's inputs,
    optionally with one key repeated on a second row."""
    rng = np.random.default_rng(0)
    c, f = 256, 16
    keys = np.full(c, -1, np.int32)
    used = rng.choice(10_000, 200, replace=False).astype(np.int32)
    keys[:200] = used
    table = rng.normal(size=(c, f)).astype(np.float32)
    table[200:] = 0.0
    if dup_key:
        keys[200] = used[7]
        table[200] = rng.normal(size=f).astype(np.float32)
    q_present = rng.choice(used, 300)
    q_absent = rng.integers(10_000, 20_000, 60).astype(np.int32)
    q = np.concatenate([q_present, q_absent, np.full(24, -2, np.int32), used[7:8].repeat(8)])
    rng.shuffle(q)
    return keys, table, q.reshape(-1, 8).astype(np.int32)


class TestOnehotGather:
    @pytest.mark.parametrize("dup_key", [False, True], ids=["unique_keys", "duplicate_key"])
    def test_plain_matches_reference(self, dup_key):
        keys, table, vids = _onehot_case(dup_key)
        j = np.asarray(jreduce.gather_stats_onehot(jnp.asarray(keys), jnp.asarray(table), jnp.asarray(vids), interpret=True))
        before = ndt_gather.launches
        t = _np(ndt_gather.gather_stats_onehot(torch.as_tensor(keys), torch.as_tensor(table), torch.as_tensor(vids)))
        assert ndt_gather.launches == before
        assert t.shape == (vids.shape[0], 8, 16)
        # one row per id, or the sum of two rows (a + b rounds the same in
        # any order): exact
        np.testing.assert_array_equal(t, j)
        hit = vids == keys[7]
        expect = table[7] + table[200] if dup_key else table[7]
        np.testing.assert_array_equal(t[hit], np.broadcast_to(expect, (hit.sum(), 16)))
        assert not t[vids == -2].any()

    @pytest.mark.parametrize("stencil", ["direct7", "radius27"])
    def test_ndt_derivatives_onehot_match_reference(self, stencil, monkeypatch):
        """The port's gather="onehot" derivatives vs the JAX package's on
        the same map (tests/test_pallas_gather.py's case), its Pallas gather
        routed through interpret mode. Tolerances: float32 sums in another
        order (tests/test_torch_ndt.py's derivative parity); each Hessian
        entry sums ~1e3 terms of both signs, so its atol is also 1e-5 of the
        largest entry (1.2e5 here: an entry of 2.8e4 differs by 0.22)."""
        orig = jreduce.gather_stats_onehot
        monkeypatch.setattr(
            jreduce, "gather_stats_onehot",
            lambda keys, table, vids, tile=16, interpret=False: orig(keys, table, vids, tile=tile, interpret=True),
        )
        from tests.test_torch_ndt import make_scene, port_map_of

        pts = make_scene(20, 50, seed=1)
        cfg_j = jndt.NDTConfig(grid_dims=(32, 32, 16), point_chunk=512, max_compact_voxels=1024,
                               gather="onehot", stencil=stencil)
        cfg_t = convert.config_from_fields(tndt.NDTConfig, dataclasses.asdict(cfg_j))
        jm = jndt.build_ndt_map(JCloud.from_points(pts), dataclasses.replace(cfg_j, gather="two_level"),
                                origin=jnp.asarray([-16.0, -16.0, -8.0]))
        tm = port_map_of(jm)
        src, mask = pts[:400], np.ones(400, bool)
        pose = np.asarray([0.05, -0.03, 0.02, 0.01, -0.02, 0.03], np.float32)
        sj, gj, hj = jndt.ndt_derivatives(jm, jnp.asarray(src), jnp.asarray(mask), jnp.asarray(pose), cfg_j, True)
        st, gt, ht = tndt.ndt_derivatives(tm, torch.as_tensor(src), torch.as_tensor(mask), pose, cfg_t, True)
        assert abs(float(sj)) > 1.0
        np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)
        np.testing.assert_allclose(_np(gt), np.asarray(gj), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(_np(ht), np.asarray(hj), rtol=1e-4, atol=max(1e-3, 1e-5 * np.abs(hj).max()))
