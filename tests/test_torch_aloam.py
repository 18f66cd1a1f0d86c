"""Parity of the port's A-LOAM front end with the JAX package: feature
extraction, frame-to-frame odometry, scan-to-map mapping and the pipeline.

Sweeps come from the reference's spinning-scan simulator (numpy, seeded) and
go through both packages; the JAX side runs on the CPU, its Pallas k-NN
kernel in interpret mode where `knn="fused"`. On CPU tensors the port's
`knn="fused"` path takes kernel K2's plain version, `"auto"` and `"xla"` the
bucket-grid `knn_query`. Odometry and mapping start from one JAX pipeline
state carried across by `convert.py`, so each stage is compared apart from
the stages before it.

Tolerances: feature extraction is exact (same sorts, same float32 ops;
points to 1e-6). Pose parity is 5e-3 m / rad, the tolerance the JAX
package's own staged-against-fused test allows for correspondence flips
(tests/test_aloam.py:159-163): the normal equations sum float32 terms in
another order, and a flipped correspondence moves the pose by millimetres.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.io import SyntheticWorld, make_trajectory, simulate_spinning_scan
from lidar_slam_tpu.ops import linalg3 as jlinalg3
from lidar_slam_tpu.pipeline import aloam as ja
from lidar_slam_tpu.pipeline.aloam import mapping as jmapping
from lidar_slam_tpu.pipeline.aloam import odometry as jodometry

from lidar_slam_tpu_torch import convert
from lidar_slam_tpu_torch.ops import PointCloud as TCloud
from lidar_slam_tpu_torch.ops.cuda import knn_fused
from lidar_slam_tpu_torch.ops.linalg3 import solve3
from lidar_slam_tpu_torch.pipeline import aloam as ta

FE_J = ja.FeatureExtractionConfig(
    n_scans=64, min_range=2.5, capacity=16384, max_sharp=256, max_less_sharp=2048, max_flat=512, max_less_flat=4096
)
# knn_window covers the largest target table, so the JAX kernel's window is
# the whole table and its result is exact, like the port's
ODO_J = ja.AloamOdometryConfig(chunk=1024, knn="xla", knn_window=4096)
MAP_J = ja.AloamMappingConfig(
    corner_map_capacity=4096, surf_map_capacity=8192, grid_dims=(64, 64, 16), chunk=1024,
    stack_corner_capacity=2048, stack_surf_capacity=4096, knn="xla", knn_window=8192,
)
FE_T = convert.config_from_fields(ta.FeatureExtractionConfig, dataclasses.asdict(FE_J))
ODO_T = convert.config_from_fields(ta.AloamOdometryConfig, dataclasses.asdict(ODO_J))
MAP_T = convert.config_from_fields(ta.AloamMappingConfig, dataclasses.asdict(MAP_J))
POSE_TOL = 5e-3


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _port_cloud(c):
    return TCloud(points=_t(c.points), mask=_t(c.mask))


@pytest.fixture(scope="module")
def sweeps():
    world = SyntheticWorld.corridor(length=60.0, width=18.0, density=300.0, seed=2)
    traj = make_trajectory(4, speed=0.8)
    return traj, [
        simulate_spinning_scan(world, traj[i], t=i * 0.1, n_scans=64, n_azimuth=256, seed=i) for i in range(4)
    ]


@pytest.fixture(scope="module")
def primed(sweeps):
    """The JAX pipeline after two sweeps, the third sweep's JAX features,
    and the port's copy of that state (convert.aloam_state_from_numpy)."""
    _, frames = sweeps
    pipe = ja.AloamPipeline(FE_J, ODO_J, MAP_J)
    for pts, mask in frames[:2]:
        pipe.update(pts, mask)
    js = pipe.state

    def cloud(c):
        return np.asarray(c.points), np.asarray(c.mask)

    ts = convert.aloam_state_from_numpy(
        cloud(js.prev_less_sharp), np.asarray(js.prev_less_sharp_ring), cloud(js.prev_less_flat),
        np.asarray(js.prev_less_flat_ring), np.asarray(js.T_rel), np.asarray(js.T_world),
        np.asarray(js.T_map_odom), cloud(js.corner_map), cloud(js.surf_map), np.asarray(js.has_prev),
        np.asarray(js.map_init), device="cpu",
    )
    jf = ja.extract_features(jnp.asarray(frames[2][0]), jnp.asarray(frames[2][1]), FE_J)
    return js, ts, jf


class TestFeatureExtraction:
    def test_matches_reference(self, sweeps):
        _, frames = sweeps
        pts, mask = frames[1]
        jf = ja.extract_features(jnp.asarray(pts), jnp.asarray(mask), FE_J)
        tf = ta.extract_features(torch.as_tensor(pts), torch.as_tensor(mask), FE_T)
        for name in ("sharp", "less_sharp", "flat", "less_flat", "full"):
            a, b = getattr(tf, name), getattr(jf, name)
            np.testing.assert_array_equal(_np(a.mask), np.asarray(b.mask), err_msg=name)
            np.testing.assert_allclose(_np(a.points), np.asarray(b.points), rtol=0, atol=1e-6, err_msg=name)
        for name in ("sharp", "less_sharp", "flat", "less_flat"):
            np.testing.assert_array_equal(_np(getattr(tf, name + "_ring")), np.asarray(getattr(jf, name + "_ring")))
            np.testing.assert_array_equal(_np(getattr(tf, name + "_time")), np.asarray(getattr(jf, name + "_time")))
        # a real selection: every class is populated, none overflows
        assert 0 < int(tf.flat.mask.sum()) < FE_T.max_flat and int(tf.less_flat.mask.sum()) > 1000
        assert 0 < int(tf.sharp.mask.sum()) <= int(tf.less_sharp.mask.sum())

    def test_solve3_and_permute(self):
        rng = np.random.default_rng(0)
        A = rng.normal(size=(64, 3, 3)).astype(np.float32)
        A[0] = 0.0  # singular: returns 0
        b = rng.normal(size=(64, 3)).astype(np.float32)
        np.testing.assert_allclose(
            _np(solve3(torch.as_tensor(A), torch.as_tensor(b))),
            np.asarray(jlinalg3.solve3(jnp.asarray(A), jnp.asarray(b))), rtol=1e-5, atol=1e-6,
        )
        c = TCloud(points=torch.as_tensor(A[:, 0]), mask=torch.arange(64) % 3 > 0, weights=torch.as_tensor(b[:, 0]))
        order = torch.as_tensor(rng.permutation(64))
        p = c.permute(order)
        for k in ("points", "mask", "weights"):
            assert torch.equal(getattr(p, k), getattr(c, k)[order])


class TestStages:
    @pytest.mark.parametrize("knn", ["xla", "fused"])
    def test_odometry_step_matches_reference(self, primed, knn):
        js, ts, jf = primed
        cfg_j = dataclasses.replace(ODO_J, knn=knn)
        cfg_t = dataclasses.replace(ODO_T, knn=knn)
        Tj = np.asarray(jodometry.odometry_step(
            js.prev_less_sharp, js.prev_less_sharp_ring, js.prev_less_flat, js.prev_less_flat_ring,
            jf.sharp, jf.flat, js.T_rel, cfg_j,
        ))
        before = knn_fused.launches
        Tt = _np(ta.odometry_step(
            ts.prev_less_sharp, ts.prev_less_sharp_ring, ts.prev_less_flat, ts.prev_less_flat_ring,
            _port_cloud(jf.sharp), _port_cloud(jf.flat), ts.T_rel, cfg_t,
        ))
        assert knn_fused.launches == before  # CPU: the plain version
        assert np.linalg.norm(Tj[:3, 3]) > 0.5  # the sweep moved
        np.testing.assert_allclose(Tt, Tj, atol=POSE_TOL)

    @pytest.mark.parametrize("knn", ["xla", "fused"])
    def test_mapping_step_matches_reference(self, primed, knn):
        js, ts, jf = primed
        cfg_j = dataclasses.replace(MAP_J, knn=knn)
        cfg_t = dataclasses.replace(MAP_T, knn=knn)
        jc, jsurf = jmapping.downsample_stacks(jf.less_sharp, jf.less_flat, cfg_j)
        tc, tsurf = ta.downsample_stacks(_port_cloud(jf.less_sharp), _port_cloud(jf.less_flat), cfg_t)
        np.testing.assert_array_equal(_np(tsurf.mask), np.asarray(jsurf.mask))
        guess = np.array(js.T_map_odom @ js.T_world)
        guess[:3, 3] += np.float32([0.8, 0.05, 0.0])  # one sweep ahead, as odometry would predict
        Tj = np.asarray(jmapping.mapping_step(js.corner_map, js.surf_map, jc, jsurf, jnp.asarray(guess), cfg_j))
        Tt = _np(ta.mapping_step(ts.corner_map, ts.surf_map, tc, tsurf, torch.as_tensor(guess), cfg_t))
        np.testing.assert_allclose(Tt, Tj, atol=POSE_TOL)

        jm = jmapping.map_update(js.corner_map, js.surf_map, jc, jsurf, jnp.asarray(Tj), cfg_j)
        tm = ta.map_update(ts.corner_map, ts.surf_map, tc, tsurf, _t(Tj), cfg_t)
        for a, b in zip(tm, jm):
            np.testing.assert_array_equal(_np(a.mask), np.asarray(b.mask))
            np.testing.assert_allclose(_np(a.points), np.asarray(b.points), rtol=0, atol=1e-4)


class TestPipeline:
    def test_matches_reference(self, sweeps):
        traj, frames = sweeps
        jp = ja.AloamPipeline(FE_J, ODO_J, MAP_J)
        tp = ta.AloamPipeline(FE_T, dataclasses.replace(ODO_T, knn="auto"), dataclasses.replace(MAP_T, knn="auto"),
                              device="cpu")
        for p in (jp, tp):
            p.set_init_pose(traj[0])
        for i, (pts, mask) in enumerate(frames):
            pj, _ = jp.update(pts, mask)
            pt, _ = tp.update(pts, mask)
            np.testing.assert_allclose(pt, pj, atol=POSE_TOL, err_msg=f"sweep {i}")
        assert np.linalg.norm(pt[:3, 3] - traj[-1][:3, 3]) < 0.1

    def test_batch_equals_stepwise(self, sweeps):
        """update_batch chains the same steps as repeated update() calls."""
        _, frames = sweeps
        cfgs = (FE_T, ODO_T, MAP_T)
        step = ta.AloamPipeline(*cfgs, device="cpu")
        stepwise = np.stack([step.update(p, m)[0] for p, m in frames[:3]])
        batch = ta.AloamPipeline(*cfgs, device="cpu").update_batch(frames[:3])
        np.testing.assert_array_equal(batch, stepwise)

    def test_staged_wrappers_match_pipeline(self, sweeps):
        """AloamOdometry + AloamMapping (one pose copy per stage) == the
        pipeline step, pose for pose, as tests/test_aloam.py holds the JAX
        package's staged and fused forms."""
        _, frames = sweeps
        odo = ta.AloamOdometry(ODO_T)
        mapping = ta.AloamMapping(MAP_T, device="cpu")
        pipe = ta.AloamPipeline(FE_T, ODO_T, MAP_T, device="cpu")
        for i, (pts, mask) in enumerate(frames):
            f = ta.extract_features(torch.as_tensor(pts), torch.as_tensor(mask), FE_T)
            staged = mapping.update(f, odo.update(f))
            np.testing.assert_allclose(pipe.update(pts, mask)[0], staged, atol=POSE_TOL, err_msg=f"sweep {i}")

    def test_configs_carry_over(self):
        for j, t in ((FE_J, FE_T), (ODO_J, ODO_T), (MAP_J, MAP_T)):
            assert dataclasses.asdict(j) == dataclasses.asdict(t)
        for j, cls in ((ja.FeatureExtractionConfig, ta.FeatureExtractionConfig),
                       (ja.AloamOdometryConfig, ta.AloamOdometryConfig),
                       (ja.AloamMappingConfig, ta.AloamMappingConfig)):
            assert cls() == convert.config_from_fields(cls, dataclasses.asdict(j()))
