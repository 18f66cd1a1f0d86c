"""Kernel K3's presorted entry and the NDT map's key order, against the JAX
package.

K3 (`ops/cuda/ndt_gather.py`) looks ids up in keys that ascend in unsigned
order: an NDT map's keys are built so (NDTMap's invariant: strictly rising
voxel ids, then a tail of -1), so a map's gather needs no sort. These tests
hold the port's maps and the JAX package's maps to that order, the
converter to checking it, and the presorted entry on CPU tensors (its plain
version) to the JAX Pallas gather in interpret mode, exactly: each id
matches at most one key of a map, so each output row is one table row or
zeros on both sides.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.models.registration import ndt as jndt
from lidar_slam_tpu.ops import PointCloud as JCloud
from lidar_slam_tpu.ops.pallas import ndt_reduce as jreduce

from lidar_slam_tpu_torch import convert
from lidar_slam_tpu_torch.models.registration import ndt as tndt
from lidar_slam_tpu_torch.ops import PointCloud as TCloud
from lidar_slam_tpu_torch.ops.cuda import ndt_fused, ndt_gather

from test_torch_ndt import CFG_J, CFG_T, ORIGIN, make_scene, port_map_of

# max_compact_voxels: room for every occupied voxel (a -1 tail), and too
# little (a full table: the cap's rows all used, only the sentinel row -1)
CAPS = {"tail": 1024, "full": 48}


def _maps(cap):
    pts = make_scene(20, 50, seed=1)
    cfg_j = dataclasses.replace(CFG_J, max_compact_voxels=cap)
    cfg_t = dataclasses.replace(CFG_T, max_compact_voxels=cap)
    jm = jndt.build_ndt_map(JCloud.from_points(pts), cfg_j, origin=jnp.asarray(ORIGIN))
    tm = tndt.build_ndt_map(TCloud.from_points(pts), cfg_t, origin=ORIGIN)
    return jm, tm, cfg_j


def _assert_map_order(keys):
    """Strictly rising ids, then -1 only: ascending as uint32."""
    keys = np.asarray(keys)
    used = int((keys >= 0).sum())
    assert used > 0 and np.all(keys[used:] == -1) and np.all(np.diff(keys[:used]) > 0)
    u = keys.view(np.uint32)
    assert np.all(np.diff(u.astype(np.int64)) >= 0)
    return used


def _loop_submap_maps():
    """The loop-closure verification's target map, as each package builds
    it: two keyframe scans in the map frame, voxel-downsampled as one
    submap, then an NDT map without dense stats (port:
    pipeline/loop_closing.py::_submap_ndt)."""
    from lidar_slam_tpu.io import SyntheticWorld, make_hairpin_trajectory, simulate_scan
    from lidar_slam_tpu.models.registration import NDTConfig as JNDTConfig
    from lidar_slam_tpu.ops import voxel_downsample as j_voxel_downsample
    from lidar_slam_tpu.pipeline import loop_closing as jlc

    from lidar_slam_tpu_torch.models.registration import NDTConfig as TNDTConfig
    from lidar_slam_tpu_torch.pipeline import loop_closing as tlc

    world = SyntheticWorld.corridor(length=40.0, width=14.0, density=25.0, seed=9)
    gt = make_hairpin_trajectory(n_out=4, n_turn=0, n_back=0, speed=1.0)
    parts = []
    for i in (1, 2):
        pts, mask, _ = simulate_scan(world, gt[i], max_range=30.0, n_points=4096, seed=i)
        parts.append(pts[mask] @ gt[i][:3, :3].T + gt[i][:3, 3])
    sub = np.zeros((16384, 3), np.float32)
    n = sum(len(p) for p in parts)
    sub[:n] = np.concatenate(parts)
    msk = np.arange(16384) < n
    ndt = dict(resolution=1.0, grid_dims=(48, 48, 16), max_compact_voxels=2048)
    cfg_j = jlc.LoopClosingConfig(ndt=JNDTConfig(**ndt), submap_capacity=4096)
    cfg_t = tlc.LoopClosingConfig(ndt=TNDTConfig(**ndt), submap_capacity=4096)
    submap = j_voxel_downsample(JCloud(points=jnp.asarray(sub), mask=jnp.asarray(msk)), cfg_j.map_filter_leaf,
                                out_capacity=cfg_j.submap_capacity)
    jm = jndt.build_ndt_map(submap, dataclasses.replace(cfg_j.ndt, dense_stats=False))
    _, tm = tlc._submap_ndt(torch.as_tensor(sub), torch.as_tensor(msk), cfg_t)
    return jm, tm


@functools.lru_cache(maxsize=None)
def _rebuilt_local_maps():
    """The front end's rebuilt local map (incremental_map=False), as each
    package builds it from one window of keyframes: {"fine": (JAX map,
    port map), "coarse": ...}."""
    from lidar_slam_tpu.io import SyntheticWorld, make_trajectory, simulate_scan
    from lidar_slam_tpu.models.registration import NDTConfig as JNDTConfig
    from lidar_slam_tpu.pipeline import front_end as jfe

    from lidar_slam_tpu_torch.models.registration import NDTConfig as TNDTConfig
    from lidar_slam_tpu_torch.pipeline import front_end as tfe

    world = SyntheticWorld.corridor(length=40.0, width=14.0, density=20.0, seed=4)
    gt = make_trajectory(7, speed=1.0)
    kw = dict(keyframe_capacity=4096, local_frame_num=4, local_map_filter_min_frames=3, incremental_map=False)
    ndt = dict(resolution=1.0, grid_dims=(64, 64, 16), max_compact_voxels=2048)
    cfg_j = jfe.FrontEndConfig(ndt=JNDTConfig(**ndt), **kw)
    cfg_t = tfe.FrontEndConfig(ndt=TNDTConfig(**ndt), **kw)
    kf_p, kf_m = np.zeros((4, 4096, 3), np.float32), np.zeros((4, 4096), bool)
    poses = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    for s in range(3):
        pts, mask, _ = simulate_scan(world, gt[2 * s], max_range=30.0, n_points=4096, seed=s)
        kf_p[s], kf_m[s], poses[s] = np.where(mask[:, None], pts, 0.0), mask, gt[2 * s]
    valid, w = np.arange(4) < 3, np.ones((4, 4096), np.float32)
    _, jf, jc = jfe._build_local_map(*(jnp.asarray(a) for a in (kf_p, kf_m, w, poses, valid)), jnp.int32(3),
                                     jnp.asarray(gt[4][:3, 3]), cfg_j)
    _, tf, tc = tfe._build_local_map(torch.as_tensor(kf_p), torch.as_tensor(kf_m), torch.as_tensor(w), poses,
                                     valid, 3, gt[4][:3, 3], cfg_t)
    # the same keys; the port's coarse corner is the JAX one on the 2 m lattice
    return {"fine": (jf, tf), "coarse": (jc, tc)}


@functools.lru_cache(maxsize=None)
def _matching_local_maps():
    """Matching's box-cropped local maps (fine and coarse, no dense stats),
    as each package's Matching builds them around one position."""
    from lidar_slam_tpu.io import SyntheticWorld
    from lidar_slam_tpu.models.registration import NDTConfig as JNDTConfig
    from lidar_slam_tpu.pipeline import matching as jmatch

    from lidar_slam_tpu_torch.models.registration import NDTConfig as TNDTConfig
    from lidar_slam_tpu_torch.pipeline import matching as tmatch

    gmap = SyntheticWorld.corridor(length=60.0, width=14.0, density=20.0, seed=5).points
    kw = dict(box_size=50.0, local_map_capacity=1 << 14)
    ndt = dict(resolution=1.0, grid_dims=(64, 64, 16), max_compact_voxels=2048)
    mj = jmatch.Matching(jmatch.MatchingConfig(ndt=JNDTConfig(**ndt), **kw), gmap)
    mt = tmatch.Matching(tmatch.MatchingConfig(ndt=TNDTConfig(**ndt), **kw), gmap, device="cpu")
    for m in (mj, mt):
        m.reset_local_map(np.float32([20.0, 1.0, 1.8]))
    return {"fine": (mj.ndt_map, mt.ndt_map), "coarse": (mj.coarse_ndt_map, mt.coarse_ndt_map)}


NEW_MAPS = {"rebuilt_local_map": _rebuilt_local_maps, "matching_local_map": _matching_local_maps}


@functools.lru_cache(maxsize=None)
def _sharded_maps():
    """The sharded builders' maps at world 2 (the port on two gloo ranks on
    the CPU, one launch; JAX on two virtual devices): {"sharded_ndt_map":
    (JAX map, port map), "sharded_local_map": ...}."""
    from lidar_slam_tpu import parallel as jpar

    from lidar_slam_tpu_torch.parallel.launch import call_each, launch

    pts = make_scene(30, 60, seed=9)
    rng = np.random.default_rng(4)
    kf = (make_scene(32, 64, seed=4).reshape(4, 512, 3), rng.uniform(size=(4, 512)) < 0.9,
          rng.uniform(0.2, 1.0, (4, 512)).astype(np.float32), np.tile(np.eye(4, dtype=np.float32), (4, 1, 1)),
          np.arange(4) != 2)
    kf[3][:, :3, 3] = rng.uniform(-0.5, 0.5, (4, 3))
    par = "lidar_slam_tpu_torch.parallel.sharded_ndt"
    tm = launch(call_each, 2, args=([
        (f"{par}:sharded_build_ndt_map", (TCloud.from_points(pts), ORIGIN, CFG_T), {}),
        (f"{par}:sharded_build_local_map", (*(torch.as_tensor(a) for a in kf), ORIGIN, CFG_T), {}),
    ],), device="cpu", timeout=300.0)
    mesh = jpar.make_mesh(2)
    jm = (jpar.sharded_build_ndt_map(JCloud.from_points(pts), jnp.asarray(ORIGIN), CFG_J, mesh),
          jpar.sharded_build_local_map(*(jnp.asarray(a) for a in kf), jnp.asarray(ORIGIN), CFG_J, mesh))
    return {"sharded_ndt_map": (jm[0], tm[0]), "sharded_local_map": (jm[1], tm[1])}


@pytest.mark.parametrize(
    "case",
    [*CAPS, "loop_submap", *(f"{name}_{level}" for name in NEW_MAPS for level in ("fine", "coarse")),
     "sharded_ndt_map", "sharded_local_map"],
)
def test_map_keys_ascend_unsigned(case):
    """The port's finalize_ndt_sums keys, the JAX package's from both of its
    constructors (finalize_ndt_sums and _pack_rows, the sharded build's)
    and the converted map's: the same keys, in NDTMap's order. The loop
    closure's submap map (downsampled submap, no dense stats), the front
    end's rebuilt local map and Matching's box-cropped map, fine and coarse:
    the port's keys in that order and equal to the JAX package's. The
    sharded builders' maps at world 2: in that order and equal to the JAX
    sharded build's."""
    if case.startswith("sharded_"):
        jm, tm = _sharded_maps()[case]
        assert 0 < _assert_map_order(tm.keys.numpy()) < 2048
        np.testing.assert_array_equal(tm.keys.numpy(), np.asarray(jm.keys))
        return
    if case == "loop_submap":
        jm, tm = _loop_submap_maps()
        assert 0 < _assert_map_order(tm.keys.numpy()) < 2048
        np.testing.assert_array_equal(tm.keys.numpy(), np.asarray(jm.keys))
        return
    if case not in CAPS:
        name, level = case.rsplit("_", 1)
        jm, tm = NEW_MAPS[name]()[level]
        assert 100 < _assert_map_order(tm.keys.numpy()) < 2048
        np.testing.assert_array_equal(tm.keys.numpy(), np.asarray(jm.keys))
        return
    jm, tm, cfg_j = _maps(CAPS[case])
    used = _assert_map_order(jm.keys)
    assert (used == CAPS[case]) == (case == "full")
    np.testing.assert_array_equal(tm.keys.numpy(), np.asarray(jm.keys))
    v = int(np.prod(jm.dims))
    packed = jndt._pack_rows(jm.origin, jm.count, jm.mean, jm.icov, jm.staticvalue, jnp.zeros((v, 16)),
                             jm.valid, jm.dims, cfg_j)
    np.testing.assert_array_equal(np.asarray(packed.keys), np.asarray(jm.keys))
    np.testing.assert_array_equal(port_map_of(jm).keys.numpy(), np.asarray(jm.keys))


def _break_order(how, k, used):
    """Break NDTMap's key order in `k` (in place) in one way."""
    if how == "falling":
        k[[0, 1]] = k[[1, 0]]
    elif how == "repeated":
        k[1] = k[0]
    elif how == "id_after_tail":
        k[used + 1] = k[used - 1] + 1
    else:  # a negative id other than -1
        k[0] = -2


@pytest.mark.parametrize("how", ["falling", "repeated", "id_after_tail", "negative_id"])
def test_converter_rejects_keys_out_of_order(how):
    jm, _, _ = _maps(CAPS["tail"])
    leaves = {k: np.asarray(getattr(jm, k)) for k in
              ("origin", "count", "mean", "icov", "staticvalue", "valid", "index", "packed", "keys")}
    leaves["keys"] = leaves["keys"].copy()
    _break_order(how, leaves["keys"], int((leaves["keys"] >= 0).sum()))
    with pytest.raises(ValueError, match="unsigned ascending"):
        convert.ndt_map_from_numpy(**leaves, dims=jm.dims, resolution=jm.resolution, device="cpu")


@pytest.mark.parametrize("case", CAPS)
@pytest.mark.parametrize("stencil", ["direct7", "radius27"])
def test_sorted_entry_matches_reference(case, stencil):
    """The presorted entry on a map's keys and the stencil ids of its points
    (some off the grid: -2), plus ids past the last key and absent ids,
    against the JAX Pallas gather in interpret mode: equal to the bit. On
    CPU tensors it takes the plain version and launches nothing. Both read
    the JAX map's table (carried across by the converter)."""
    jm = _maps(CAPS[case])[0]
    tm = port_map_of(jm)
    rng = np.random.default_rng(3)
    pts = make_scene(20, 50, seed=1)[rng.choice(1000, 300, replace=False)]
    pts[:10] += np.float32([40.0, 0.0, 0.0])  # off the grid
    cell = np.floor((pts - ORIGIN) / tm.resolution).astype(np.int32)
    cand = cell[:, None, :] + ndt_fused.STENCIL_OFFSETS[stencil][None]
    dims = np.asarray(tm.dims)
    inb = np.all((cand >= 0) & (cand < dims), axis=-1)
    vids = np.where(inb, (cand[..., 0] * dims[1] + cand[..., 1]) * dims[2] + cand[..., 2], -2).astype(np.int32)
    keys = np.asarray(jm.keys)
    vids[-1, :3] = [keys[keys >= 0].max() + 1, int(np.prod(dims)) + 5, 2**31 - 1]  # past the last key
    assert (vids == -2).any() and np.isin(vids, keys).any()
    j = np.asarray(jreduce.gather_stats_onehot(jm.keys, jm.packed, jnp.asarray(vids), interpret=True))
    before = ndt_gather.launches
    t = ndt_gather.gather_stats_sorted(tm.keys, tm.packed, torch.as_tensor(vids))
    assert ndt_gather.launches == before
    assert t.shape == (*vids.shape, 16)
    np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(t.numpy(), ndt_gather.gather_stats_plain(tm.keys, tm.packed,
                                                                           torch.as_tensor(vids)).numpy())
    assert not t.numpy()[~np.isin(vids, keys[keys >= 0])].any()


def test_entries_reject_other_devices():
    keys, table, vids = torch.zeros(4, dtype=torch.int32), torch.zeros(4, 16), torch.zeros((2, 3), dtype=torch.int32)
    for entry in (ndt_gather.gather_stats_sorted, ndt_gather.gather_stats_onehot):
        with pytest.raises(ValueError, match="unsupported device"):
            entry(keys.to("meta"), table.to("meta"), vids.to("meta"))


class _KeysOutOfOrder:
    """Stands in for `torch` inside models/registration/ndt.py: the key
    build's searchsorted gives keys broken in one way (`_break_order`
    before the -1 tail is filled in), as a faulty constructor would."""

    def __init__(self, how):
        self.how = how

    def __getattr__(self, name):
        return getattr(torch, name)

    def searchsorted(self, *args, **kwargs):
        k = torch.searchsorted(*args, **kwargs).clone()
        _break_order(self.how, k, int(k.shape[0]))
        return k


def _build(constructor):
    """One map from the port constructor `constructor` (a one-rank mesh
    for the sharded builders, which run there in-process)."""
    from lidar_slam_tpu_torch.parallel import sharded_ndt
    from lidar_slam_tpu_torch.parallel.mesh import Mesh

    pts = make_scene(20, 50, seed=1)
    cloud = TCloud.from_points(pts)
    if constructor == "finalize_ndt_sums":
        sums = tndt.scatter_to_sums(tndt.empty_ndt_sums(ORIGIN, CFG_T), cloud.points, cloud.mask)
        return tndt.finalize_ndt_sums(sums, CFG_T)
    mesh = Mesh(rank=0, size=1, device=torch.device("cpu"), backend="none")
    if constructor == "sharded_build_ndt_map":
        return sharded_ndt.sharded_build_ndt_map(cloud, ORIGIN, CFG_T, mesh)
    kf = torch.as_tensor(pts[:1000].reshape(2, 500, 3))
    return sharded_ndt.sharded_build_local_map(kf, torch.ones((2, 500), dtype=torch.bool), torch.ones((2, 500)),
                                               np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)), np.ones(2, bool),
                                               ORIGIN, CFG_T, mesh)


CONSTRUCTORS = ["finalize_ndt_sums", "sharded_build_ndt_map", "sharded_build_local_map"]


@pytest.mark.parametrize("how", ["falling", "repeated"])
@pytest.mark.parametrize("constructor", CONSTRUCTORS)
def test_constructors_reject_keys_out_of_order(constructor, how, monkeypatch):
    """Every NDTMap constructor of the port (finalize_ndt_sums, and
    _pack_rows under the sharded builders) ends with the device-side order
    check: given a key build that breaks NDTMap's order, the build fails
    (on the CPU at once) instead of handing K3 keys it would misread. The
    same builds with the key build intact pass the check."""
    m = _build(constructor)
    _assert_map_order(m.keys.numpy())
    monkeypatch.setattr(tndt, "torch", _KeysOutOfOrder(how))
    with pytest.raises(RuntimeError, match="unsigned ascending"):
        _build(constructor)


@pytest.mark.parametrize("how", ["falling", "repeated", "id_after_tail", "negative_id"])
def test_plain_gather_rejects_keys_out_of_order(how):
    """The presorted entry's plain version (what CPU tensors take, and what
    the kernel is held to) raises on keys out of NDTMap's order, where the
    kernel would return wrong rows; the general entry's plain version takes
    the same keys in any order and gives the one-hot rows."""
    _, tm, _ = _maps(CAPS["tail"])
    keys = tm.keys.clone()
    _break_order(how, keys, int((keys >= 0).sum()))
    vids = tm.keys[:64].reshape(8, 8)
    for call in (lambda: ndt_gather.gather_stats_plain(keys, tm.packed, vids),
                 lambda: ndt_gather.gather_stats_sorted(keys, tm.packed, vids)):
        with pytest.raises(RuntimeError, match="unsigned ascending"):
            call()
    want = (vids.reshape(-1, 1) == keys[None, :]).to(torch.float32) @ tm.packed
    got = ndt_gather.gather_stats_onehot(keys, tm.packed, vids)
    np.testing.assert_array_equal(got.reshape(-1, 16).numpy(), want.numpy())
