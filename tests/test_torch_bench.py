"""The port's benchmark suite (lidar_slam_tpu_torch/bench.py) against bench.py.

On the CPU at small sizes (`shrink`, which the CLI test's `bench --device
cpu` run uses too): the workload equals bench.py's build_workload, the
scan-match drive follows bench.py's make_drive (JAX on the CPU, gather
"two_level" on both sides), the derivative parity gate passes, the metric
lines are bench.py's, the mfu line's count is the count the bound columns
use, and the evaluation chain that keeps its pose on the device gives the
derivatives at each pose.
"""

import ast
import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.models.registration import NDTConfig as JNDTConfig
from lidar_slam_tpu.models.registration import build_ndt_map as jbuild_ndt_map

from lidar_slam_tpu_torch import bench
from lidar_slam_tpu_torch.models.registration import NDTConfig, build_ndt_map, ndt_derivatives
from lidar_slam_tpu_torch.pipeline.front_end import _preprocess

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import bench as jbench  # noqa: E402  (bench.py at the repository root)

POSE_TOL = 5e-3  # m / rad, tests/test_torch_ndt.py::test_align_parity's
MAP_TOL = 1e-6  # m, the map cloud
CPU = torch.device("cpu")


def _small_configs():
    from lidar_slam_tpu_torch.pipeline.aloam import AloamMappingConfig, AloamOdometryConfig, FeatureExtractionConfig
    from lidar_slam_tpu_torch.pipeline.matching import MatchingConfig

    def aloam_configs():
        fe = FeatureExtractionConfig(n_scans=64, min_range=2.5, capacity=8192, max_sharp=1024, max_less_sharp=8192,
                                     max_flat=2048, max_less_flat=16384)
        return fe, AloamOdometryConfig(), AloamMappingConfig(corner_map_capacity=8192, surf_map_capacity=16384,
                                                              grid_dims=(64, 64, 16))

    def matching_config():
        ndt = NDTConfig(resolution=1.0, grid_dims=(96, 96, 24), point_chunk=4096, gather="auto")
        return MatchingConfig(ndt=ndt, local_map_capacity=1 << 15, frame_capacity=4096, raw_capacity=32768,
                              height_map_dim=64)

    return dict(aloam_configs=aloam_configs, matching_config=matching_config)


# bench's sizes for a run of every leg on the CPU in about a minute on one thread: fewer rays,
# frames, nodes and descriptors, smaller grids; each guard of bench.py still holds with a margin
SMALL = dict(
    RAW_CAP=32768, FRAME_CAP=16384, N_FRAMES=1, GRID=(128, 128, 32), POSE_GRAPH=(40, 48, 64),
    SOLVER_SWEEP=((32, 20.0),), DENSE_MAX=32, SCHUR_NODES=32, SC_HISTORY=(60, 80, 100),
    ALOAM_AZIMUTH=128, ALOAM_SWEEPS=3, FRONT_END_FRAMES=8, MATCH_AZIMUTH=512, MATCH_FRAMES=4,
    LOOP_SCAN_POINTS=2048, EVAL_CHAIN=3, EVAL_REPS=2,
)
DRIVE_FRAMES = 2  # the workload held against bench.py's: frame 1 starts from the motion model


def shrink(monkeypatch):
    """Set bench's sizes and leg configurations to SMALL's."""
    for name, value in {**SMALL, **_small_configs()}.items():
        monkeypatch.setattr(bench, name, value)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workloads():
    """The port's workload and bench.py's, at SMALL's sizes over DRIVE_FRAMES frames."""
    mp = pytest.MonkeyPatch()
    for mod in (bench, jbench):
        mp.setattr(mod, "RAW_CAP", SMALL["RAW_CAP"])
        mp.setattr(mod, "N_FRAMES", DRIVE_FRAMES)
    mp.setattr(bench, "GRID", SMALL["GRID"])
    try:
        yield bench.build_workload(CPU), jbench.build_workload()
    finally:
        mp.undo()


def test_workload_matches_reference(workloads):
    (t_map, t_pts, t_msk, t_gt, t_guess), (j_map, j_pts, j_msk, j_gt, j_guess) = workloads
    t_valid, j_valid = t_map.mask.numpy(), np.asarray(j_map.mask)
    np.testing.assert_array_equal(t_valid, j_valid)
    np.testing.assert_allclose(t_map.points.numpy()[t_valid], np.asarray(j_map.points)[j_valid], atol=MAP_TOL, rtol=0)
    np.testing.assert_array_equal(t_pts.numpy(), np.asarray(j_pts))
    np.testing.assert_array_equal(t_msk.numpy(), np.asarray(j_msk))
    np.testing.assert_array_equal(t_gt, j_gt)
    np.testing.assert_array_equal(t_guess, np.asarray(j_guess))


def test_scan_match_drive_matches_reference(workloads, monkeypatch):
    """The drive's chained poses against bench.py's make_drive, both on the
    exact two_level reduction, frame by frame."""
    monkeypatch.setattr(bench, "FRAME_CAP", SMALL["FRAME_CAP"])
    monkeypatch.setattr(jbench, "FRAME_CAP", SMALL["FRAME_CAP"])
    (t_map, t_pts, t_msk, gt, t_guess), (j_map, j_pts, j_msk, _, j_guess) = workloads
    kw = dict(resolution=1.0, grid_dims=SMALL["GRID"], point_chunk=8192, max_iter=30, stencil="direct7",
              gather="two_level", max_compact_voxels=65536)
    cfg_t, cfg_j = NDTConfig(**kw), JNDTConfig(**kw)
    poses, iters, unres = bench.make_drive(build_ndt_map(t_map, cfg_t), cfg_t)(t_pts, t_msk, t_guess)
    jmap = jbuild_ndt_map(j_map, cfg_j)
    j_poses, j_iters, _ = (np.asarray(a) for a in jbench.make_drive(jmap, cfg_j)(jmap, j_pts, j_msk, j_guess))
    assert poses.shape == (DRIVE_FRAMES, 4, 4) and (unres == 0).all()
    np.testing.assert_allclose(poses, j_poses, atol=POSE_TOL, rtol=0)
    errs = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert errs.mean() <= 0.10, (errs, iters, j_iters)


THREAD_FRAMES = 4  # the thread-count drive: frame 0 starts ~0.5 m off, 1-3 from the motion model


def test_radius27_drive_does_not_follow_thread_count(monkeypatch):
    """The CPU baseline's radius27 drive (gather two_level, the plain
    reduction in the host loop) at SMALL's sizes over THREAD_FRAMES
    frames: the same poses, to the bit, and the same iterations a frame at
    one torch thread and at eight, the last frame tracked. Its first frames
    run near the iteration cap, where float32 sums that split by thread
    count sent every other frame of the full-size drive to the cap."""
    for name in ("RAW_CAP", "FRAME_CAP", "GRID"):
        monkeypatch.setattr(bench, name, SMALL[name])
    monkeypatch.setattr(bench, "N_FRAMES", THREAD_FRAMES)
    map_cloud, pts, msk, gt, guess = bench.build_workload(CPU)
    cfg = dataclasses.replace(bench.ndt_config(gather="two_level"), stencil="radius27")
    drive = bench.make_drive(build_ndt_map(map_cloud, cfg), cfg)
    runs = {}
    for threads in (1, 8):
        torch.set_num_threads(threads)
        try:
            runs[threads] = drive(pts, msk, guess)
        finally:
            torch.set_num_threads(1)
    (p1, it1, _), (p8, it8, _) = runs[1], runs[8]
    assert it1.tolist() == it8.tolist(), (it1, it8)
    np.testing.assert_array_equal(p1, p8)
    assert np.linalg.norm(p1[-1, :3, 3] - gt[-1, :3, 3]) <= 0.10, (p1[:, :3, 3], it1)


def test_derivative_parity_gate_passes_on_cpu(workloads, monkeypatch):
    monkeypatch.setattr(bench, "FRAME_CAP", SMALL["FRAME_CAP"])
    card = bench.Card(CPU, "cpu")
    for stencil in ("direct7", "radius27"):
        bench.derivative_parity_gate(card, bench.ndt_config(stencil=stencil), workloads[0])
    assert card.failed == []


def _emits(tree, name_at, unit_at):
    """(metric, unit) of every `_emit(...)` call in `tree` whose name and
    unit are string literals at the given positions."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "_emit":
            name, unit = node.args[name_at], node.args[unit_at]
            out.append((ast.literal_eval(name), ast.literal_eval(unit)))
    return out


def test_metric_lines_are_bench_py_s():
    """The names and units the port prints are bench.py's (each once in
    METRICS, with the headline last); every _emit call of the port names
    one of them, and every metric has a call."""
    ref = set(_emits(ast.parse((ROOT / "bench.py").read_text()), 0, 2))
    port = _emits(ast.parse(Path(bench.__file__).read_text()), 1, 3)
    assert len(bench.METRICS) == len(set(bench.METRICS)) == len(ref)
    assert set(bench.METRICS) == ref == set(port)
    assert bench.METRICS[-1] == ("ndt_scan_match_fps", "frames/s")


def _ndt_work_numpy(frame, ndt_map, pose6, cfg):
    """The bound columns' count, written again in numpy float32 for one pose."""
    from lidar_slam_tpu_torch.ops.cuda import ndt_fused, ndt_newton

    pts, mask = frame.points.numpy(), frame.mask.numpy()
    valid = mask & np.isfinite(pts).all(axis=1)
    x = pts[valid]
    R, t, _, _ = (a.numpy() for a in ndt_newton.pose_coefficients(torch.as_tensor(pose6)))
    xp = (x @ R.T + t).astype(np.float32)
    dims = np.asarray(ndt_map.dims)
    origin = ndt_map.origin.numpy()
    cell = np.floor((xp - origin) / np.float32(ndt_map.resolution)).astype(np.int64)
    index, packed = ndt_map.index.numpy(), ndt_map.packed.numpy()
    d2 = np.float32(cfg.gauss_params()[1])
    flops, vids, rows = x.shape[0] * bench.FLOPS_POINT, set(), set()
    for off in ndt_fused.STENCIL_OFFSETS[cfg.stencil]:
        cand = np.clip(cell, -2, dims + 1) + off
        inb = ((cand >= 0) & (cand < dims)).all(axis=1)
        vid = (cand[inb, 0] * dims[1] + cand[inb, 1]) * dims[2] + cand[inb, 2]
        row = index[vid]
        vids.update(vid.tolist())
        rows.update(row.tolist())
        pk = packed[row]
        on = pk[:, 10] > 0.5
        e = xp[inb] - pk[:, :3]
        gate = on & ((e * e).sum(1) <= ndt_map.resolution**2) if cfg.stencil == "radius27" else on
        ix = pk[:, 4:10]
        ci = np.stack([ix[:, [0, 1, 2]], ix[:, [1, 3, 4]], ix[:, [2, 4, 5]]], axis=1)
        q = np.einsum("nij,nj->ni", ci, e)
        with np.errstate(over="ignore", invalid="ignore"):
            exd = d2 * np.exp(np.float32(-0.5) * d2 * (q * e).sum(1))
        accepted = gate & (exd <= 1.0) & (exd >= 0.0) & np.isfinite(exd)
        flops += on.sum() * (bench.FLOPS_VALID + (bench.FLOPS_GATE if cfg.stencil == "radius27" else 0))
        flops += accepted.sum() * bench.FLOPS_ACCEPTED
    n_bytes = mask.size + int(valid.sum()) * 16 + len(vids) * 4 + len(rows) * 48 + (6 + 48) * 4
    return n_bytes, int(flops)


@pytest.mark.parametrize("stencil", ["direct7", "radius27"])
def test_ndt_mfu_count(workloads, monkeypatch, stencil):
    """ndt_mfu's basis is the count chip_smoke.py's bound columns use (one
    function: chip_smoke imports bench's) and equals a numpy count of the
    same rule at the probe's operating point."""
    import chip_smoke

    assert chip_smoke.ndt_work is bench.ndt_work and chip_smoke.bound is bench.bound
    monkeypatch.setattr(bench, "FRAME_CAP", SMALL["FRAME_CAP"])
    cfg = bench.ndt_config(stencil=stencil)
    ndt_map, frame, _, _, _, pose6 = bench._frame0(cfg, workloads[0])
    assert bench.ndt_work(frame, ndt_map, [pose6], cfg) == _ndt_work_numpy(frame, ndt_map, pose6, cfg)


def test_eval_chain_keeps_the_pose_on_the_device(workloads, monkeypatch):
    """eval_probe's chain: K1's wrapper given the pose as a tensor (its plain
    version here, which takes the coefficients from ndt_newton.
    pose_coefficients) sums what it sums for the host pose's coefficients,
    and each evaluation moves the pose by 1e-9 score, on the device."""
    from lidar_slam_tpu_torch.models.registration.ndt import _reduce
    from lidar_slam_tpu_torch.ops.cuda.ndt_fused import ndt_reduce_fused

    monkeypatch.setattr(bench, "FRAME_CAP", SMALL["FRAME_CAP"])
    cfg = bench.ndt_config()
    ndt_map, _, pts, msk, w, pose6 = bench._frame0(cfg, workloads[0])
    d1, d2 = (float(np.float32(v)) for v in cfg.gauss_params())
    pose = torch.from_numpy(pose6)
    sums = ndt_reduce_fused(pts, msk, w, ndt_map.index, ndt_map.packed, ndt_map.origin, None, None, None, None,
                            dims=ndt_map.dims, resolution=ndt_map.resolution, d1=d1, d2=d2, stencil=cfg.stencil,
                            weight_derivatives=cfg.weight_derivatives, pose=pose)
    ref = _reduce(ndt_map, pts, msk, w, pose6, cfg)
    np.testing.assert_allclose(sums.numpy(), ref.numpy(), rtol=1e-5, atol=1e-3)
    nxt = bench.eval_chain(ndt_map, pts, msk, w, pose, cfg, 1)
    torch.testing.assert_close(nxt, torch.add(pose, sums[0], alpha=1e-9), rtol=0, atol=0)
    with pytest.raises(ValueError, match="pose"):  # a pose of the wrong shape
        bench.eval_chain(ndt_map, pts, msk, w, pose[:3], cfg, 1)
