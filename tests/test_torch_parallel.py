"""The port's multi-rank layer (lidar_slam_tpu_torch/parallel/) against the
JAX package's parallel/ and against the port's own unsharded functions:
the point-sharded NDT derivatives and alignment, the sharded map builds,
the edge-sharded PCG and the node-sharded Schur solve, on
tests/test_parallel.py's fixtures, made with numpy from a seed.

The JAX side runs in the pytest process on conftest's virtual CPU devices,
at make_mesh(2) and make_mesh(4). The port's side runs in 2 and 4 gloo
ranks on the CPU (parallel/launch.py): every case of this module runs in
one launch per world size (a module-scoped fixture; the tests read its
results), each rank on one torch thread, each launch with its own timeout.
The ranks import only the port.

Tolerances are the JAX tests' own (tests/test_parallel.py): the sharded
sums add in another order than the unsharded ones (and than JAX's psum),
and the difference compounds over Newton and LM iterations.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu import parallel as jpar
from lidar_slam_tpu.geom import se3_exp as j_se3_exp
from lidar_slam_tpu.models import graph_optimizer as jg
from lidar_slam_tpu.models.registration import ndt as jndt
from lidar_slam_tpu.ops import PointCloud as JCloud

from lidar_slam_tpu_torch import convert
from lidar_slam_tpu_torch.models import graph_optimizer as tg
from lidar_slam_tpu_torch.models.registration import ndt as tndt
from lidar_slam_tpu_torch.ops import PointCloud as TCloud
from lidar_slam_tpu_torch import parallel as tpar
from lidar_slam_tpu_torch.parallel.launch import call_each, launch

from test_graph_optimizer import build_noisy_loop
from test_ndt import make_scene

WORLDS = (2, 4)
LAUNCH_TIMEOUT = 300.0  # s a launch of every case
CFG_J = jndt.NDTConfig(grid_dims=(32, 32, 16), point_chunk=512)
CFG_T = tndt.NDTConfig(grid_dims=(32, 32, 16), point_chunk=512)
ORIGIN = np.asarray([-16.0, -16.0, -8.0], np.float32)
POSE6 = np.asarray([0.1, -0.05, 0.02, 0.01, 0.0, -0.02], np.float32)
XI_TRUE = np.asarray([0.2, -0.1, 0.05, 0.01, -0.01, 0.02], np.float32)
SEP_CAP = 32
SCALING_POINTS = 4096
PAR = "lidar_slam_tpu_torch.parallel"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _graph_fields(builder):
    g = builder.to_graph()
    return {f.name: np.asarray(getattr(g, f.name)) for f in dataclasses.fields(jg.PoseGraph)}


class Inputs:
    """Every case's numpy inputs and the port's objects made from them."""

    def __init__(self):
        pts = make_scene(30, 60, seed=9)
        self.pts = pts
        rng = np.random.default_rng(10)
        self.src = pts[rng.choice(len(pts), 1024, replace=False)]
        T = np.asarray(j_se3_exp(jnp.asarray(XI_TRUE)), np.float32)
        self.T_true = T
        Ti = np.linalg.inv(T).astype(np.float32)
        self.moved = (self.src @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
        self.map_t = tndt.build_ndt_map(TCloud.from_points(pts), CFG_T, origin=ORIGIN)
        self.map_j = jndt.build_ndt_map(JCloud.from_points(pts), CFG_J, origin=jnp.asarray(ORIGIN))
        # the map build: capacity divisible by 2 and 4 for clean point shards
        self.target_t = TCloud.from_points(pts, capacity=4096)
        self.target_j = JCloud.from_points(pts, capacity=4096)
        # 8 keyframes, one slot empty like a part-filled ring buffer
        rng = np.random.default_rng(4)
        k, p = 8, 512
        self.kf = dict(
            pts=rng.uniform(-10, 10, (k, p, 3)).astype(np.float32),
            masks=rng.uniform(size=(k, p)) < 0.9,
            weights=rng.uniform(0.2, 1.0, (k, p)).astype(np.float32),
            poses=np.tile(np.eye(4, dtype=np.float32), (k, 1, 1)),
            valid=np.arange(k) != 6,
        )
        self.kf["poses"][:, :3, 3] = rng.uniform(-3, 3, (k, 3))
        b_pcg, _, _ = build_noisy_loop(n=24, drift=0.02, seed=11, max_nodes=64, max_edges=64, max_priors=64)
        self.pcg = (_graph_fields(b_pcg), b_pcg.n_nodes)
        self.schur = {}
        for gnss in (False, True):
            b, _, _ = build_noisy_loop(n=56, drift=0.02, seed=13, with_gnss=gnss, max_nodes=64, max_edges=128,
                                       max_priors=64)
            self.schur[gnss] = (_graph_fields(b), b.n_nodes)
        self.pcg_cfg = dict(max_iterations=30, solver="pcg")
        self.schur_cfg = dict(max_iterations=30, solver="dense")

    def kf_tensors(self):
        kf = self.kf
        return (torch.as_tensor(kf["pts"]), torch.as_tensor(kf["masks"]), torch.as_tensor(kf["weights"]),
                torch.as_tensor(kf["poses"]), torch.as_tensor(kf["valid"]), ORIGIN)

    def calls(self, world):
        """(name, target, args, kwargs) of every case on `world` ranks."""
        src = TCloud.from_points(self.src, capacity=1024)
        moved = TCloud.from_points(self.moved, capacity=1024)
        graph = convert.pose_graph_from_numpy(self.pcg[0], device="cpu")
        out = [
            ("derivs", f"{PAR}.sharded_ndt:sharded_ndt_derivatives", (self.map_t, src, POSE6, CFG_T), {}),
            ("align", f"{PAR}.sharded_ndt:sharded_ndt_align", (self.map_t, moved, np.eye(4), CFG_T), {}),
            ("build", f"{PAR}.sharded_ndt:sharded_build_ndt_map", (self.target_t, ORIGIN, CFG_T), {}),
            ("build_again", f"{PAR}.sharded_ndt:sharded_build_ndt_map", (self.target_t, ORIGIN, CFG_T), {}),
            ("local", f"{PAR}.sharded_ndt:sharded_build_local_map", (*self.kf_tensors(), CFG_T), {}),
            ("pcg", f"{PAR}.sharded_graph:optimize_pose_graph_sharded",
             (graph, tg.GraphOptimizerConfig(**self.pcg_cfg)), {}),
        ]
        for gnss, (fields, _) in self.schur.items():
            sg = tpar.schur_prepare(convert.pose_graph_from_numpy(fields, device="cpu"), world, sep_cap=SEP_CAP)
            out.append((f"schur_{gnss}", f"{PAR}.sharded_schur:optimize_pose_graph_schur",
                        (sg, tg.GraphOptimizerConfig(**self.schur_cfg)), {}))
        out.append(("dryrun", f"{PAR}.dryrun:dryrun_rank", (), {}))
        out.append(("scaling", f"{PAR}.scaling_bench:scaling_rank", (), dict(n_points=SCALING_POINTS, repeats=1)))
        x = torch.as_tensor(np.random.default_rng(5).normal(size=(8 * world, 3)).astype(np.float32))
        for route in ("all_sum", "sum_scatter", "all_gather"):
            out.append((route, f"{PAR}.collectives:{route}", (x,), {}))
        return out


@pytest.fixture(scope="module")
def inputs():
    return Inputs()


@pytest.fixture(scope="module")
def port(inputs):
    """{world: {case: rank 0's result}}: every case on 2 and on 4 ranks,
    one launch each."""
    out = {}
    for world in WORLDS:
        calls = inputs.calls(world)
        res = launch(call_each, world, args=([c[1:] for c in calls],), device="cpu", timeout=LAUNCH_TIMEOUT)
        out[world] = {c[0]: r for c, r in zip(calls, res)}
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_derivs(got, ref):
    s, g, h = (_np(v) for v in got[:3])
    s1, g1, h1 = (_np(v) for v in ref[:3])
    np.testing.assert_allclose(float(s), float(s1), rtol=1e-4)
    np.testing.assert_allclose(g, g1, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(h, h1, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_derivatives(world, inputs, port):
    """test_parallel.py:41-51's tolerances, against JAX's sharded
    derivatives at the same mesh size and the port's unsharded ones."""
    got = port[world]["derivs"]
    assert float(got[3]) == 0.0
    src_j = JCloud.from_points(inputs.src, capacity=1024)
    ref_j = jpar.sharded_ndt_derivatives(inputs.map_j, src_j, jnp.asarray(POSE6), CFG_J, jpar.make_mesh(world))
    _assert_derivs(got, ref_j)
    src_t = TCloud.from_points(inputs.src, capacity=1024)
    _assert_derivs(got, tndt.ndt_derivatives(inputs.map_t, src_t.points, src_t.mask, POSE6, CFG_T, True))


@pytest.mark.parametrize("world", WORLDS)
def test_align(world, inputs, port):
    """test_parallel.py:53-66: within 1e-2 of JAX's sharded alignment at the
    same mesh size (the cross-layout bound there) and of the port's
    unsharded one, and within 0.1 m of the truth."""
    got = _np(port[world]["align"].pose)
    moved_j = JCloud.from_points(inputs.moved, capacity=1024)
    ref_j = jpar.sharded_ndt_align(inputs.map_j, moved_j, jnp.eye(4), CFG_J, jpar.make_mesh(world))
    np.testing.assert_allclose(got, np.asarray(ref_j.pose), atol=1e-2)
    ref_t = tndt.ndt_align(inputs.map_t, TCloud.from_points(inputs.moved, capacity=1024), np.eye(4), CFG_T)
    np.testing.assert_allclose(got, _np(ref_t.pose), atol=1e-2)
    err = np.linalg.inv(inputs.T_true) @ got
    assert np.abs(err[:3, 3]).max() < 0.1


def _assert_map(m, ref, icov=True):
    """test_parallel.py:69-90's tolerances between two maps."""
    np.testing.assert_array_equal(_np(m.valid), _np(ref.valid))
    np.testing.assert_allclose(_np(m.count), _np(ref.count), atol=1e-5)
    np.testing.assert_allclose(_np(m.mean), _np(ref.mean), atol=1e-4)
    if icov:
        np.testing.assert_allclose(_np(m.icov), _np(ref.icov), rtol=2e-3, atol=2e-2)
        np.testing.assert_array_equal(_np(m.keys), _np(ref.keys))


@pytest.mark.parametrize("world", WORLDS)
def test_build_map(world, inputs, port):
    """Points sharded, voxel slabs reduced: the JAX sharded map at the same
    mesh size and the port's build_ndt_map, at test_parallel.py:69-90's
    tolerances; the same alignment on either map (1e-5); and the same bits
    when built twice."""
    m = port[world]["build"]
    again = port[world]["build_again"]
    for f in ("count", "mean", "icov", "staticvalue", "valid", "index", "packed", "keys"):
        assert torch.equal(getattr(m, f), getattr(again, f)), f
    ref_j = jpar.sharded_build_ndt_map(inputs.target_j, jnp.asarray(ORIGIN), CFG_J, jpar.make_mesh(world))
    _assert_map(m, ref_j)
    ref_t = tndt.build_ndt_map(inputs.target_t, CFG_T, origin=ORIGIN)
    _assert_map(m, ref_t)
    np.testing.assert_array_equal(_np(m.index), _np(ref_t.index))
    rng = np.random.default_rng(3)
    src = TCloud.from_points(inputs.pts[rng.choice(len(inputs.pts), 1024, replace=False)], capacity=1024)
    r8 = tndt.ndt_align(m, src, np.eye(4), CFG_T)
    r1 = tndt.ndt_align(ref_t, src, np.eye(4), CFG_T)
    np.testing.assert_allclose(_np(r8.pose), _np(r1.pose), atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_local_map(world, inputs, port):
    """Keyframes sharded: the JAX sharded local map at the same mesh size,
    and the port's build_ndt_map of the same keyframes concatenated
    (test_parallel.py:92-118's tolerances). The inverse covariances are
    held entry by entry to the port's one-rank map only. The port's eigh3 is
    the JAX closed form, bases and all (ROADMAP C.3: an orthonormal repair
    was built and held back), so a pole-like or tight voxel's icov may
    follow the order of the sums; this fixture's voxels stay within the
    tolerances between the port's two layouts. The JAX sharded map adds the
    ranks' keyframes in another order (contiguous shards, not the port's
    strided ones), so its icov is not compared here:
    parallel_witness.py compares the two entry by entry with the float32
    term for tight voxels."""
    m = port[world]["local"]
    kf = inputs.kf
    ref_j = jpar.sharded_build_local_map(
        jnp.asarray(kf["pts"]), jnp.asarray(kf["masks"]), jnp.asarray(kf["weights"]), jnp.asarray(kf["poses"]),
        jnp.asarray(kf["valid"]), jnp.asarray(ORIGIN), CFG_J, jpar.make_mesh(world),
    )
    world_pts = np.einsum("kij,kpj->kpi", kf["poses"][:, :3, :3], kf["pts"]) + kf["poses"][:, None, :3, 3]
    flat = TCloud(points=torch.as_tensor(world_pts.reshape(-1, 3).astype(np.float32)),
                  mask=torch.as_tensor((kf["masks"] & kf["valid"][:, None]).reshape(-1)),
                  weights=torch.as_tensor(kf["weights"].reshape(-1)))
    ref_t = tndt.build_ndt_map(flat, CFG_T, origin=ORIGIN)
    for ref in (ref_j, ref_t):
        _assert_map(m, ref, icov=ref is ref_t)
        np.testing.assert_allclose(_np(m.staticvalue), _np(ref.staticvalue), atol=1e-4)
    np.testing.assert_array_equal(_np(m.keys), np.asarray(ref_j.keys))


@pytest.mark.parametrize("world", WORLDS)
def test_pcg(world, inputs, port):
    """Edges sharded: the JAX edge-sharded PCG at the same mesh size and the
    port's single-rank PCG within 0.05 m (test_parallel.py:129-141), chi2
    below 20 % of its start."""
    g, stats = port[world]["pcg"]
    fields, n = inputs.pcg
    cfg_j = jg.GraphOptimizerConfig(**inputs.pcg_cfg)
    ref_j, _ = jpar.optimize_pose_graph_sharded(jg.PoseGraph(**{k: jnp.asarray(v) for k, v in fields.items()}),
                                                cfg_j, jpar.make_mesh(world))
    ref_t, _ = tg.optimize_pose_graph(convert.pose_graph_from_numpy(fields, device="cpu"),
                                      tg.GraphOptimizerConfig(**inputs.pcg_cfg))
    for ref in (np.asarray(ref_j.poses), _np(ref_t.poses)):
        np.testing.assert_allclose(_np(g.poses)[:n, :3, 3], ref[:n, :3, 3], atol=0.05)
    assert stats["chi2_after"] < stats["chi2_before"] * 0.2


@pytest.mark.parametrize("gnss", [False, True], ids=["plain", "gnss"])
@pytest.mark.parametrize("world", WORLDS)
def test_schur(world, gnss, inputs, port):
    """Node blocks with the separator system reduced over the ranks: the
    JAX Schur solve at the same mesh size and the port's single-rank dense
    LM within 0.05 m (test_parallel.py:143-173), chi2 below 20 % of its
    start, the loop edge's separators found; the same layout as JAX's."""
    g, stats = port[world][f"schur_{gnss}"]
    fields, n = inputs.schur[gnss]
    cfg = inputs.schur_cfg
    jgraph = jg.PoseGraph(**{k: jnp.asarray(v) for k, v in fields.items()})
    sg_j = jpar.schur_prepare(jgraph, n_devices=world, sep_cap=SEP_CAP)
    sg_t = tpar.schur_prepare(convert.pose_graph_from_numpy(fields, device="cpu"), world, sep_cap=SEP_CAP)
    for f in ("sep_pos", "sep_nodes", "sep_valid"):
        np.testing.assert_array_equal(_np(getattr(sg_t, f)), np.asarray(getattr(sg_j, f)))
    np.testing.assert_array_equal(_np(sg_t.graph.edge_ij), np.asarray(sg_j.graph.edge_ij))
    np.testing.assert_array_equal(_np(sg_t.graph.prior_node), np.asarray(sg_j.graph.prior_node))
    assert int(_np(sg_t.sep_valid).sum()) >= 2
    ref_j, _ = jpar.optimize_pose_graph_schur(sg_j, jg.GraphOptimizerConfig(**cfg), jpar.make_mesh(world))
    ref_t, _ = tg.optimize_pose_graph(convert.pose_graph_from_numpy(fields, device="cpu"),
                                      tg.GraphOptimizerConfig(**cfg))
    for ref in (np.asarray(ref_j.poses), _np(ref_t.poses)):
        np.testing.assert_allclose(_np(g.poses)[:n, :3, 3], ref[:n, :3, 3], atol=0.05)
    assert stats["chi2_after"] < stats["chi2_before"] * 0.2


def test_schur_separator_overflow_raises(inputs):
    fields, _ = inputs.schur[False]
    with pytest.raises(ValueError, match="separators exceed"):
        tpar.schur_prepare(convert.pose_graph_from_numpy(fields, device="cpu"), 8, sep_cap=2)


@pytest.mark.parametrize("world", WORLDS)
def test_collective_routes(world, port):
    """The one route every backend takes (an all_reduce of zero-padded rank
    slots), run here under gloo on the CPU: each rank's values added in
    rank order, to the bit."""
    res = port[world]
    x = np.random.default_rng(5).normal(size=(8 * world, 3)).astype(np.float32)
    expect = x.copy()
    for _ in range(1, world):
        expect = expect + x
    np.testing.assert_array_equal(_np(res["all_sum"]), expect)
    np.testing.assert_array_equal(_np(res["sum_scatter"]), expect[:8])
    np.testing.assert_array_equal(_np(res["all_gather"]), np.tile(x, (world, 1)))


def test_divisibility_errors(inputs):
    """The JAX package's shape rules: voxel count, point capacity, keyframe
    count and the edge / prior capacities must divide the mesh size."""
    mesh3 = tpar.Mesh(rank=0, size=3, device=torch.device("cpu"), backend="none")
    with pytest.raises(ValueError, match="voxel count"):
        tpar.sharded_build_ndt_map(inputs.target_t, ORIGIN, dataclasses.replace(CFG_T, grid_dims=(32, 32, 16)),
                                   dataclasses.replace(mesh3, size=5))
    with pytest.raises(ValueError, match="point capacity"):
        tpar.sharded_ndt_align(inputs.map_t, TCloud.from_points(inputs.src, capacity=1024), np.eye(4), CFG_T,
                               mesh3)
    with pytest.raises(ValueError, match="keyframe count"):
        tpar.sharded_build_local_map(*inputs.kf_tensors(), dataclasses.replace(CFG_T, grid_dims=(24, 32, 16)),
                                     mesh3)
    with pytest.raises(ValueError, match="edge capacity"):
        tpar.optimize_pose_graph_sharded(convert.pose_graph_from_numpy(inputs.pcg[0], device="cpu"),
                                         tg.GraphOptimizerConfig(max_iterations=1), mesh3)


def test_distributed_init_noop_single_host(monkeypatch):
    """test_parallel.py:120-124: no coordinator, no world size -> False,
    and a one-rank mesh still works."""
    monkeypatch.delenv("SLAM_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("SLAM_NUM_PROCESSES", raising=False)
    assert tpar.distributed_init_from_env() is False
    mesh = tpar.make_mesh(1, device="cpu")
    assert (mesh.size, mesh.rank, mesh.distributed) == (1, 0, False)
    assert tpar.process_count() == 1
    with pytest.raises(ValueError):
        tpar.make_mesh(2, device="cpu")


def test_sort_points_by_vid_matches_reference(inputs):
    """The JAX package's sort: points, mask and weights in voxel-id order at
    the initial pose, masked points last, ties in input order."""
    rng = np.random.default_rng(21)
    pts = rng.uniform(-15, 15, (2000, 3)).astype(np.float32)
    pts[:, 2] *= 0.4
    mask = rng.uniform(size=2000) < 0.8
    w = rng.uniform(0.1, 1.0, 2000).astype(np.float32)
    T = np.asarray(j_se3_exp(jnp.asarray([0.4, -0.3, 0.1, 0.02, -0.01, 0.3], jnp.float32)), np.float32)
    ref = jndt.sort_points_by_vid(inputs.map_j, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(w), jnp.asarray(T))
    got = tndt.sort_points_by_vid(inputs.map_t, torch.as_tensor(pts), torch.as_tensor(mask), torch.as_tensor(w), T)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun(world, port):
    """__graft_entry__.py::dryrun_multichip's run at its shapes (every check
    is the rank's own; a failed one fails the launch): maps with voxels, the
    two solves lowering chi2, a finite drive that starts on a keyframe."""
    out = port[world]["dryrun"]
    assert out["map_voxels"] > 0 and out["local_map_voxels"] > 0
    for before, after in (out["pcg_chi2"], out["schur_chi2"]):
        assert after < before
    assert np.isfinite(out["pose"]).all() and np.isfinite(out["drive_poses"]).all()


@pytest.mark.parametrize("world", WORLDS)
def test_scaling_bench(world, port):
    """The scaling bench's sharded evaluation scores the same as one rank's
    (float32 summation order apart: rtol 1e-4, test_parallel.py:49)."""
    from lidar_slam_tpu_torch.parallel.scaling_bench import scaling_rank

    one = scaling_rank(tpar.make_mesh(1, device="cpu"), SCALING_POINTS, 1)
    got = port[world]["scaling"]
    assert got["eval_ms"] > 0 and got["map_build_ms"] > 0
    np.testing.assert_allclose(got["score"], one["score"], rtol=1e-4)


def test_parallel_witness_on_a_local_map(inputs, tmp_path):
    """chip_smoke.py's --parallel-out record of a local map (8 keyframes of
    a blob scene, each in its own frame; the port's two-rank map from a
    launch of 2 gloo ranks and its one-rank build_ndt_map), then
    parallel_witness.py over it: the JAX maps of the same keyframes at one
    and two devices; the port's two-rank map against JAX's two-device map
    with the port's strided shards: keys, counts and means equal, every
    inverse covariance within the bound; both packages' alignments on
    either map within trans_eps of each other, so the verdict is "no
    gap"."""
    import json
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)  # chip_smoke.py and parallel_witness.py
    import chip_smoke
    import parallel_witness

    rng = np.random.default_rng(21)
    scene = make_scene(40, 100, seed=21)
    k, p = 8, 500
    shift = rng.uniform(-2, 2, (k, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    poses[:, :3, 3] = shift
    kf = (torch.as_tensor(scene[:k * p].reshape(k, p, 3) - shift[:, None]), torch.ones((k, p), dtype=torch.bool),
          torch.as_tensor(rng.uniform(0.2, 1.0, (k, p)).astype(np.float32)), poses, np.ones(k, bool))
    two = launch(call_each, 2, args=([(f"{PAR}.sharded_ndt:sharded_build_local_map", (*kf, ORIGIN, CFG_T), {})],),
                 device="cpu", timeout=LAUNCH_TIMEOUT)[0]
    flat = TCloud(points=torch.as_tensor(scene[:k * p]), mask=kf[1].reshape(-1), weights=kf[2].reshape(-1))
    one = tndt.build_ndt_map(flat, CFG_T, origin=ORIGIN)
    T = np.asarray(j_se3_exp(jnp.asarray(XI_TRUE)), np.float32)
    Ti = np.linalg.inv(T).astype(np.float32)
    src = scene[rng.choice(len(scene), 1024, replace=False)]
    frame = TCloud.from_points((src @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32), capacity=1024)
    path, out = tmp_path / "maps.npz", tmp_path / "witness.json"
    guess = T.copy()
    guess[:3, 3] += np.float32([0.05, -0.05, 0.02])
    chip_smoke.save_local_maps(str(path), (*kf, ORIGIN), frame, guess, CFG_T, one, two)
    assert parallel_witness.main([str(path), "--json", str(out)]) == 0
    w = json.loads(out.read_text())
    e = w["entries"]["port two ranks - JAX 2 devices, the port's shards"]
    assert e["keys_equal"] and e["count_gap"] == 0.0 and e["mean_gap"] <= parallel_witness.MEAN_TOL
    assert e["beyond_entries"] == 0 and e["voxels"] > 100
    assert all(r["converged"] for r in w["maps"].values())
    assert w["verdict"] == "no gap"
    assert max(w["gaps"]["JAX, 2 devices - build_ndt_map"]) <= CFG_T.trans_eps


def _witness():
    """parallel_witness.py from the repo root."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import parallel_witness

    return parallel_witness


def _pole(seed):
    """48 returns of a pole 2 cm across in one voxel: a ring of points
    (equal spread in x and y) along z, 0.1 mm of noise."""
    rng = np.random.default_rng(seed)
    n = 48
    ang = np.arange(n) * 2 * np.pi / n * 7 % (2 * np.pi)
    pts = np.stack([1.4 + 0.01 * np.cos(ang), 2.3 + 0.01 * np.sin(ang), 0.02 + 0.96 * rng.uniform(size=n)], 1)
    return (pts + rng.normal(0, 1e-4, pts.shape)).astype(np.float32), rng.permutation(n)


@pytest.mark.parametrize("seed", range(6))
def test_pole_voxel_icov_follows_summation_order(seed):
    """The reference behaviour behind ROADMAP C.3's two-rank gap: a pole's
    voxel, whose two small covariance eigenvalues coincide to float32
    precision, gets an inverse covariance that the closed-form eigh3 builds
    from noise in the pair's plane. The same points summed in another order
    (as another rank layout sums them) move it far beyond tests/
    test_parallel.py's rtol / atol and the float32 term in the JAX package
    and in the port alike, while the count and the mean stay put (and the
    two packages give the same count, mean and valid flag in one order;
    not always the same inverse covariance, since their eigh3 arithmetic
    rounds differently)."""
    pts, perm = _pole(seed)
    cfg_j = jndt.NDTConfig(grid_dims=(8, 8, 8), point_chunk=512)
    cfg_t = tndt.NDTConfig(grid_dims=(8, 8, 8), point_chunk=512)
    origin = np.float32([-4.0, -4.0, -4.0])
    rows = {}
    for name, order in (("given", np.arange(len(pts))), ("permuted", perm), ("reversed", np.arange(len(pts))[::-1])):
        p = pts[order]
        j = jndt.build_ndt_map(JCloud.from_points(p), cfg_j, origin=jnp.asarray(origin))
        t = tndt.build_ndt_map(TCloud.from_points(p), cfg_t, origin=origin)
        assert int(np.asarray(j.keys)[0]) == int(t.keys[0]) >= 0 and int(np.asarray(j.keys)[1]) == -1
        rows[name] = (np.asarray(j.packed)[0].astype(np.float64), t.packed[0].numpy().astype(np.float64))
    for pkg in (0, 1):
        ref = rows["given"][pkg]
        assert ref[10] == 1.0 and ref[11] == len(pts)
        moved = max(np.abs(rows[o][pkg][4:10] - ref[4:10]).max() for o in ("permuted", "reversed"))
        bound = _witness().icov_bound(ref[None, 4:10], 1.0).max()
        assert moved > 20 * bound, (pkg, moved, bound)
        for o in ("permuted", "reversed"):
            np.testing.assert_allclose(rows[o][pkg][0:3], ref[0:3], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(rows["given"][1][[0, 1, 2, 10, 11]], rows["given"][0][[0, 1, 2, 10, 11]])
