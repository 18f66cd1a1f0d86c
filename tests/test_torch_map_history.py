"""The port's incremental NDT map at depth, against the JAX package's.

The front end's map (`_incremental_map_update` in each package's
pipeline/front_end.py) keeps running float32 sums: each keyframe adds its
points and evicts the keyframe that leaves the window in one signed
scatter, the grid recentres once the vehicle has moved past the slack,
and the fine and coarse maps are conditioned from the sums. Here one
numpy-seeded drive of KEYFRAMES keyframes through a WINDOW-keyframe window
(a corridor of ground, two walls and boxes, each keyframe's points in its
own frame) goes through both packages' updates, each package evicting the
world points its own update computed, and every EVERY-th keyframe is
compared:

- the sums: grid corner and counts exactly; psum, ppsum and wsum within
  SUMS_TOL of each other, and each within F64_TOL of a float64 rebuild of
  the window's keyframes (corner-relative moments from the float32 inputs
  in float64), over the voxels whose counts agree with it (a point that
  lies within float32 rounding of a cell face may fall in the next cell
  in float64);
- the fine and coarse maps: keys and counts exactly, means within
  MEAN_TOL, inverse covariances within tests/test_parallel.py's rtol and
  atol plus the float32 term of ROADMAP C.3 for tight voxels; both
  packages' fine inverse covariances against the float64 conditioning of
  the rebuild at ICOV_F64_RTOL.

The drive crosses the recentring slack many times (checked).
"""

import dataclasses
import functools
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.models.registration import ndt as jndt
from lidar_slam_tpu.pipeline import front_end as jfe

from lidar_slam_tpu_torch.models.registration import ndt as tndt
from lidar_slam_tpu_torch.pipeline import front_end as tfe

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # front_end_witness.py: the float64 rebuild and conditioning

import front_end_witness as W  # noqa: E402

KEYFRAMES, WINDOW, EVERY = 120, 10, 10
POINTS = 1536  # keyframe capacity
GRID = dict(resolution=1.0, grid_dims=(64, 64, 16), max_compact_voxels=8192)
STEP = 0.8  # m of travel a keyframe along the corridor
SUMS_TOL = 1e-5  # port against JAX, absolute (the sums of one voxel stay below ~2e2)
# each package against the float64 rebuild, absolute: a voxel's sums reach ~2e2 and each keyframe's add and
# evict round them at 2^-24 of that, 2 x 120 x 2e2 x 6e-8 = 2.9e-3 at worst (measured: 2.2e-4 at keyframe 119)
F64_TOL = 1e-3
MEAN_TOL = 1e-4  # m
RTOL, ATOL = 2e-3, 2e-2  # tests/test_parallel.py's, on inverse covariances
# the fine map's inverse covariances against the float64 conditioning, relative to the row's largest: float32
# covariances of thin voxels (2 cm of noise on 1 m cells) conditioned by the closed-form eigh3 (measured: 2.9e-3
# at keyframe 109 in both packages)
ICOV_F64_RTOL = 1e-2
CHECKPOINTS = list(range(EVERY - 1, KEYFRAMES, EVERY))


def corridor_keyframe(rng, pose):
    """POINTS world points of a corridor 14 m wide near `pose` (ground at
    z = 0, walls at y = +-7, and boxes every 9 m), 2 cm noise, in the
    keyframe's own frame, with a mask and static weights."""
    x0 = pose[0, 3]
    n = POINTS
    kind = rng.choice(3, n, p=[0.5, 0.35, 0.15])
    x = x0 + rng.uniform(-12.0, 12.0, n)
    y = rng.uniform(-7.0, 7.0, n)
    z = np.zeros(n)
    wall = kind == 1
    y[wall] = np.where(rng.uniform(size=wall.sum()) < 0.5, -7.0, 7.0)
    z[wall] = rng.uniform(0.0, 3.0, wall.sum())
    box = kind == 2
    cx = np.round(x[box] / 9.0) * 9.0
    x[box] = cx + rng.uniform(-0.6, 0.6, box.sum())
    y[box] = 3.0 + rng.uniform(-0.4, 0.4, box.sum())
    z[box] = rng.uniform(0.0, 1.2, box.sum())
    world = np.stack([x, y, z], 1) + rng.normal(0.0, 0.02, (n, 3))
    T = np.linalg.inv(pose.astype(np.float64))
    pts = (world @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    mask = rng.uniform(size=n) < 0.92
    weights = np.where(rng.uniform(size=n) < 0.1, rng.uniform(0.0, 1.0, n), 1.0).astype(np.float32)
    return np.where(mask[:, None], pts, 0.0).astype(np.float32), mask, weights


def drive():
    """The keyframes: poses along the corridor with a slow weave and yaw,
    each with its points, mask, weights and grid corner."""
    rng = np.random.default_rng(1405)
    cfg = tndt.NDTConfig(**GRID)
    out = []
    for j in range(KEYFRAMES):
        yaw = 0.05 * np.sin(j / 7.0)
        pose = np.eye(4, dtype=np.float32)
        pose[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        pose[:3, 3] = [-40.0 + STEP * j, 0.6 * np.sin(j / 11.0), 1.8]
        pts, mask, weights = corridor_keyframe(rng, pose)
        origin = tfe.FrontEnd._lattice_origin(pose[:3, 3], cfg, snap_mult=2.0)
        jorigin = jfe.FrontEnd._lattice_origin(pose[:3, 3], jndt.NDTConfig(**GRID), snap_mult=2.0)
        assert np.array_equal(origin, jorigin)
        out.append(dict(points=pts, mask=mask, weights=weights, pose=pose, origin=origin, evicts=j >= WINDOW))
    return out


@functools.lru_cache(maxsize=None)
def history():
    """Both packages' maps over the drive: {keyframe: snapshot} at each
    checkpoint, and the number of recentres."""
    kfs = drive()
    t_fine = dataclasses.replace(tndt.NDTConfig(**GRID), dense_stats=False)
    t_coarse = tfe.coarse_tracking_cfg(tndt.NDTConfig(**GRID))
    j_fine = dataclasses.replace(jndt.NDTConfig(**GRID), dense_stats=False)
    j_coarse = jfe.coarse_tracking_cfg(jndt.NDTConfig(**GRID))
    ts = tndt.empty_ndt_sums(kfs[0]["origin"], t_fine, device="cpu")
    js = jndt.empty_ndt_sums(kfs[0]["origin"], j_fine)
    jcs = jndt.empty_ndt_sums(kfs[0]["origin"], j_coarse)
    t_world, j_world = {}, {}
    zeros_t, zeros_j = torch.zeros((POINTS, 3)), jnp.zeros((POINTS, 3), jnp.float32)
    snaps, recentres, corner = {}, 0, kfs[0]["origin"]
    with torch.inference_mode():
        n_threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for j, kf in enumerate(kfs):
                old = kfs[j - WINDOW] if kf["evicts"] else None
                slot = j % WINDOW
                old_mask = old["mask"] if old else np.zeros(POINTS, bool)
                old_w = old["weights"] if old else np.ones(POINTS, np.float32)
                ts, t_world[slot], tfm, tcm = tfe._incremental_map_update(
                    ts, t_world.get(slot, zeros_t), torch.as_tensor(old_mask), torch.as_tensor(old_w),
                    torch.as_tensor(kf["points"]), torch.as_tensor(kf["mask"]), torch.as_tensor(kf["weights"]),
                    kf["pose"], kf["origin"], t_fine, t_coarse)
                o = jnp.asarray(kf["origin"])
                js, jcs, j_world[slot], jfm, jcm = jfe._incremental_map_update(
                    js, jcs, j_world.get(slot, zeros_j), jnp.asarray(old_mask), jnp.asarray(old_w),
                    jnp.asarray(kf["points"]), jnp.asarray(kf["mask"]), jnp.asarray(kf["weights"]),
                    jnp.asarray(kf["pose"]), o, o, j_fine, j_coarse)
                if not np.array_equal(ts.origin.numpy(), corner):
                    recentres, corner = recentres + 1, ts.origin.numpy()
                if j in CHECKPOINTS:
                    snaps[j] = dict(
                        t_origin=ts.origin.numpy(), j_origin=np.asarray(js.origin),
                        t_sums=np.concatenate([ts.count[:, None].numpy(), ts.psum.numpy(), ts.ppsum.numpy(),
                                               ts.wsum[:, None].numpy()], 1),
                        j_sums=W.sums_of(js),
                        f64=W.float64_window(kfs[:j + 1], WINDOW, ts.origin.numpy(), t_fine.grid_dims,
                                             t_fine.resolution),
                        maps={"fine": ((tfm.keys.numpy(), tfm.packed.numpy()),
                                       (np.asarray(jfm.keys), np.asarray(jfm.packed))),
                              "coarse": ((tcm.keys.numpy(), tcm.packed.numpy()),
                                         (np.asarray(jcm.keys), np.asarray(jcm.packed)))})
        finally:
            torch.set_num_threads(n_threads)
    return snaps, recentres


def test_drive_crosses_recentres():
    """The window slides past the recentring slack more than twice, and
    every checkpoint's window holds WINDOW keyframes of evictions behind it."""
    snaps, recentres = history()
    assert recentres >= 2 and sorted(snaps) == CHECKPOINTS
    assert KEYFRAMES >= 120 and CHECKPOINTS[1] >= WINDOW


@pytest.mark.parametrize("at", CHECKPOINTS)
def test_sums_at_depth(at):
    """The port's running sums after keyframe `at`: the JAX package's grid
    corner and counts exactly, its psum / ppsum / wsum within SUMS_TOL;
    both within F64_TOL of the float64 rebuild of the window, which they
    match in counts but where float64 moves a point across a cell face."""
    s = history()[0][at]
    assert np.array_equal(s["t_origin"], s["j_origin"])
    t, j, f = s["t_sums"], s["j_sums"], s["f64"]
    np.testing.assert_array_equal(t[:, 0], j[:, 0])
    np.testing.assert_allclose(t[:, 1:], j[:, 1:], rtol=0, atol=SUMS_TOL)
    agree = t[:, 0] == f[:, 0]
    assert (~agree).sum() <= 4, np.flatnonzero(~agree)
    assert (t[:, 0] > 0).sum() > 300  # the window fills the grid's ground, walls and boxes
    for sums in (t, j):
        np.testing.assert_allclose(sums[agree, 1:], f[agree, 1:], rtol=0, atol=F64_TOL)


def _icov_bound(ref, res):
    big = np.abs(ref).max(axis=1, keepdims=True)
    return ATOL + RTOL * np.abs(ref) + 2.0 ** -23 * 3.0 * res * res * big * big


@pytest.mark.parametrize("at", CHECKPOINTS)
@pytest.mark.parametrize("level", ["fine", "coarse"])
def test_maps_at_depth(at, level):
    """The conditioned maps after keyframe `at`: the JAX maps' keys and
    counts exactly, means within MEAN_TOL, inverse covariances within
    rtol / atol and the float32 term; the fine map's valid inverse
    covariances within ICOV_F64_RTOL of the float64 conditioning of the
    rebuilt window (over the voxels whose counts agree with it)."""
    s = history()[0][at]
    (tk, tp), (jk, jp) = s["maps"][level]
    np.testing.assert_array_equal(tk, jk)
    used = jk >= 0
    assert used.sum() > (100 if level == "fine" else 40)
    tp, jp = tp[used].astype(np.float64), jp[used].astype(np.float64)
    np.testing.assert_array_equal(tp[:, 10:12], jp[:, 10:12])  # valid flags and counts
    np.testing.assert_allclose(tp[:, 0:3], jp[:, 0:3], rtol=0, atol=MEAN_TOL)
    res = GRID["resolution"] * (1.0 if level == "fine" else 2.0)
    assert np.all(np.abs(tp[:, 4:10] - jp[:, 4:10]) <= _icov_bound(jp[:, 4:10], res))
    if level == "fine":
        cfg = jfe.FrontEndConfig(ndt=jndt.NDTConfig(**GRID))
        f = s["f64"]
        ids, icov = W.float64_icov(f, cfg)
        keep = f[ids, 0] == s["t_sums"][ids, 0]
        for name, (keys, packed) in zip(("port", "JAX"), s["maps"]["fine"]):
            rows = W.icov_rows(keys, packed)
            common, ia, ib = np.intersect1d(rows[0], ids[keep], return_indices=True)
            assert len(common) > 100
            ref = icov[keep][ib]
            err = np.abs(rows[1][ia] - ref).max(axis=1) / np.abs(ref).max(axis=1)
            assert err.max() <= ICOV_F64_RTOL, (name, common[np.argmax(err)], err.max())
