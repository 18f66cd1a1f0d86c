"""Parity of the port's command-line entry point with the JAX package's.

Both packages' `main` run in-process on the CPU (JAX on its CPU backend with
no persistent compilation cache, the port with `--device cpu`) over
`--synthetic 8` with configs/synthetic_small.yaml, and the port's run is
held to the JAX run file by file. The synthetic trajectory moves exactly
1 m a frame, so the small config's 2.0 m keyframe gates sit on a knife edge
that millimetre differences in the odometry (inside the front end's
tolerance) tip to another frame; the runs here set both gates (front end
and back end) to 2.5 m, which leaves every decision a clear margin.

Tolerances: the odometry, the stored keyframe poses and the optimized
keyframes within FRONT_END_TOL (test_torch_front_end.py's FrontEnd bound);
the filtered map's point count within MAP_COUNT_TOL; a resumed run within
RESUME_ATE of the uninterrupted one (tests/test_cli.py's bound). Files one
package writes (the keyframe store, progress.json, the maps) are resumed
from and localized in by the other, with the result it gives on its own.
Torch is pinned to one CPU thread while the file runs.
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

import lidar_slam_tpu.cli as jcli
from lidar_slam_tpu.io.trajectory import ate_rmse, read_kitti_trajectory

import lidar_slam_tpu_torch.cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 8
KILL_AFTER = 5  # frames done when the frame source fails
FRONT_END_TOL = 2e-2  # m, test_torch_front_end.py
MAP_COUNT_TOL = 0.01  # relative
RESUME_ATE = 0.05  # m, tests/test_cli.py:137


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch's small CPU ops run faster on one thread than on a pool that
    parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _failing_source(source):
    """A frame source that fails after KILL_AFTER frames, as a drive cut off
    mid-run."""

    def frames(args):
        for i, frame in enumerate(source(args)):
            if i == KILL_AFTER:
                raise OSError("frame source lost")
            yield frame

    return frames


def _main(cli, argv, fail=False):
    """Run one package's CLI in-process; returns (exit code, stdout)."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIDAR_SLAM_NO_CACHE", "1")  # no XLA cache under ~/.cache
        if fail:
            mp.setattr(cli, "_frame_source", _failing_source(cli._frame_source))
        with contextlib.redirect_stdout(out):
            if fail:
                with pytest.raises(OSError, match="frame source lost"):
                    cli.main(argv)
                return None, out.getvalue()
            rc = cli.main(argv)
    return rc, out.getvalue()


def _argv(cli, *args):
    return [*args, *(["--device", "cpu"] if cli is tcli else [])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every CLI run of the file, once: per package, the uninterrupted
    mapping, a run whose frame source fails after KILL_AFTER frames, that
    run resumed by itself and by the other package, and matching in its own
    map and in the other package's."""
    root = tmp_path_factory.mktemp("cli")
    cfg = root / "cfg.yaml"
    text = open(os.path.join(REPO, "configs", "synthetic_small.yaml")).read()
    for section in ("front_end:\n", "back_end:\n"):
        text = text.replace(section, section + "  key_frame_distance: 2.5\n")
    cfg.write_text(text)
    r = {}
    for tag, cli in (("j", jcli), ("t", tcli)):
        def mapping(out, *extra, fail=False, cli=cli):
            return _main(cli, _argv(cli, "mapping", "--synthetic", str(N_FRAMES), "--config", str(cfg),
                                    "--out", str(out), *extra), fail=fail)

        r[tag] = mapping(root / tag)
        r[tag + "_killed"] = mapping(root / f"{tag}_killed", fail=True)
        r[tag + "_mesh"] = mapping(root / f"{tag}_mesh", "--mesh-devices", "2")
    for tag, cli in (("j", jcli), ("t", tcli)):
        for src in ("j", "t"):
            out = root / f"{src}_resumed_by_{tag}"
            shutil.copytree(root / f"{src}_killed", out)
            r[out.name] = _main(cli, _argv(cli, "mapping", "--synthetic", str(N_FRAMES), "--config", str(cfg),
                                           "--out", str(out), "--resume"))
            r[f"{src}_map_by_{tag}"] = _main(cli, _argv(cli, "matching", "--synthetic", "4", "--config", str(cfg),
                                                        "--map", str(root / src)))
    out = root / "t_killed_resumed_on_mesh"
    shutil.copytree(root / "t_killed", out)
    r[out.name] = _main(tcli, _argv(tcli, "mapping", "--synthetic", str(N_FRAMES), "--config", str(cfg),
                                    "--out", str(out), "--resume", "--mesh-devices", "2"))
    r["root"] = root
    return r


def _odom(root, name, file="laser_odom.txt"):
    return read_kitti_trajectory(os.path.join(root, name, "trajectory", file))


def _keyframes(root, name):
    kf_dir = os.path.join(root, name, "key_frames")
    n = len([f for f in os.listdir(kf_dir) if f.endswith(".npz")])
    out = []
    for k in range(n):
        with np.load(os.path.join(kf_dir, f"key_frame_{k}.npz"), allow_pickle=True) as z:
            out.append((float(z["time"]), z["pose"]))
    return out


def _line(stdout, prefix):
    lines = [ln for ln in stdout.splitlines() if ln.startswith(prefix)]
    assert lines, stdout[-2000:]
    return lines[-1]


def _metres(stdout, prefix):
    return float(_line(stdout, prefix).split(":")[1].split("m")[0])


def test_mapping_matches_reference(runs):
    root = runs["root"]
    (rc_j, out_j), (rc_t, out_t) = runs["j"], runs["t"]
    assert rc_j == rc_t == 0
    for prefix in ("mapping done:", "run health:", "ATE vs ground truth:"):
        _line(out_t, prefix)
    assert abs(_metres(out_t, "ATE vs ground truth:") - _metres(out_j, "ATE vs ground truth:")) <= FRONT_END_TOL
    odo_j, odo_t = _odom(root, "j"), _odom(root, "t")
    assert odo_t.shape == odo_j.shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(odo_t, odo_j, atol=FRONT_END_TOL)
    np.testing.assert_array_equal(_odom(root, "t", "ground_truth.txt"), _odom(root, "j", "ground_truth.txt"))
    kf_j, kf_t = _keyframes(root, "j"), _keyframes(root, "t")
    assert [t for t, _ in kf_t] == [t for t, _ in kf_j] and len(kf_t) >= 3
    np.testing.assert_allclose(np.stack([p for _, p in kf_t]), np.stack([p for _, p in kf_j]), atol=FRONT_END_TOL)
    np.testing.assert_allclose(_odom(root, "t", "optimized.txt"), _odom(root, "j", "optimized.txt"),
                               atol=FRONT_END_TOL)
    maps = {}
    for tag in ("j", "t"):
        with np.load(os.path.join(root, tag, "map", "filtered_map.npz")) as z:
            maps[tag] = len(z["points"])
    assert abs(maps["t"] - maps["j"]) <= MAP_COUNT_TOL * maps["j"], maps
    assert sorted(os.listdir(os.path.join(root, "t", "map"))) == sorted(os.listdir(os.path.join(root, "j", "map")))
    assert sorted(os.listdir(os.path.join(root, "t", "trajectory"))) == sorted(
        os.listdir(os.path.join(root, "j", "trajectory")))


def test_mesh_mapping_matches_reference(runs):
    """`mapping --mesh-devices 2`: the port's two gloo ranks on the CPU
    (rank 0 writes every file) against the JAX package's run on two
    devices and against the port's single-rank run: the same keyframes,
    the odometry and the optimized keyframes within FRONT_END_TOL. The
    port's killed run resumed on two ranks (every rank restores its front
    end from the store): within RESUME_ATE of the uninterrupted run."""
    root = runs["root"]
    assert runs["j_mesh"][0] == runs["t_mesh"][0] == 0
    odo = _odom(root, "t_mesh")
    assert odo.shape == (N_FRAMES, 4, 4)
    for ref in ("j_mesh", "t"):
        np.testing.assert_allclose(odo, _odom(root, ref), atol=FRONT_END_TOL)
        np.testing.assert_allclose(_odom(root, "t_mesh", "optimized.txt"), _odom(root, ref, "optimized.txt"),
                                   atol=FRONT_END_TOL)
        assert [t for t, _ in _keyframes(root, "t_mesh")] == [t for t, _ in _keyframes(root, ref)]
    assert runs["t_killed_resumed_on_mesh"][0] == 0
    resumed = _odom(root, "t_killed_resumed_on_mesh")
    assert len(resumed) == N_FRAMES
    np.testing.assert_array_equal(resumed[:KILL_AFTER], _odom(root, "t")[:KILL_AFTER])
    assert ate_rmse(resumed, _odom(root, "t"), align=False) < RESUME_ATE


@pytest.mark.parametrize("src", ["j", "t"])
def test_resume_matches_reference(runs, src):
    """A run cut off after KILL_AFTER frames (its store, progress.json and
    live trajectory), resumed by each package: `resumed:` printed, every
    frame in the stitched trajectory, within RESUME_ATE of the uninterrupted
    run, and the two packages' resumed frames within FRONT_END_TOL of each
    other."""
    root = runs["root"]
    _, out_killed = runs[f"{src}_killed"]
    assert "mapping done" not in out_killed
    resumed = {}
    for tag in ("j", "t"):
        rc, out = runs[f"{src}_resumed_by_{tag}"]
        assert rc == 0
        assert f"resumed: " in out and f"{KILL_AFTER} frames already done" in out, out[-2000:]
        resumed[tag] = _odom(root, f"{src}_resumed_by_{tag}")
        assert len(resumed[tag]) == N_FRAMES
        np.testing.assert_array_equal(resumed[tag][:KILL_AFTER], _odom(root, src)[:KILL_AFTER])
    assert ate_rmse(resumed["t"], _odom(root, "t"), align=False) < RESUME_ATE
    np.testing.assert_allclose(resumed["t"][KILL_AFTER:], resumed["j"][KILL_AFTER:], atol=FRONT_END_TOL)


@pytest.mark.parametrize("src", ["j", "t"])
def test_matching_in_either_map(runs, src):
    """`matching --map` over each package's map: the port localizes in the
    JAX package's map and the JAX package in the port's, with the error each
    gives in that map."""
    errs = {}
    for tag in ("j", "t"):
        rc, out = runs[f"{src}_map_by_{tag}"]
        assert rc == 0
        errs[tag] = _metres(out, "localization mean error:")
    assert errs["t"] < 1.0
    assert abs(errs["t"] - errs["j"]) <= FRONT_END_TOL, errs


def test_prefetch_order_and_errors():
    assert list(tcli._prefetch(iter(range(100)), depth=3)) == list(range(100))

    def gen():
        yield 1
        raise ValueError("boom")

    it = tcli._prefetch(gen(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)


def _bench_refusal_and_small_run(monkeypatch, capsys):
    """`bench` without a card refuses at once, naming the missing card;
    `bench --device cpu` at test_torch_bench.py's small sizes prints each of
    bench.py's metric lines once, headline last over the port's CPU path,
    every line with its device, and exits 0."""
    from test_torch_bench import shrink

    from lidar_slam_tpu_torch import bench

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            tcli.main(["bench"])
        assert e.value.code == 2 and "CUDA is not available" in capsys.readouterr().err
    shrink(monkeypatch)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the CPU baseline's subprocess: one thread, as this file
    assert tcli.main(["bench", "--device", "cpu"]) == 0
    out = capsys.readouterr()
    lines = [json.loads(ln) for ln in out.out.splitlines() if ln.startswith("{")]
    assert [(r["metric"], r["unit"]) for r in lines] == list(bench.METRICS)
    assert all(r["device"] == "cpu" for r in lines)
    assert lines[-1]["baseline"] == "cpu" and lines[-2]["metric"] == "ndt_cpu_fps"
    assert lines[-1]["vs_baseline"] == pytest.approx(lines[-1]["value"] / lines[-2]["value"])
    assert '"ok": true' in out.err and '"ok": false' not in out.err  # each leg's launch counts


def test_inspect_and_refusals(tmp_path, capsys, monkeypatch):
    from lidar_slam_tpu_torch.io.kitti_writer import write_kitti_raw_drive
    from lidar_slam_tpu_torch.io.synthetic import SyntheticWorld, make_trajectory, simulate_scan

    world = SyntheticWorld.corridor(length=40, seed=1)
    gt = make_trajectory(3)
    frames = [{"points": simulate_scan(world, g, n_points=512, seed=i)[0], "pose": g} for i, g in enumerate(gt)]
    drive = write_kitti_raw_drive(str(tmp_path), frames)
    assert tcli.main(["inspect", "--kitti-raw", drive, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("frame ") == 3 and "inspect: OK" in out
    _bench_refusal_and_small_run(monkeypatch, capsys)
    # more cards asked for than there are: exit 2, naming both counts
    n = max(2, torch.cuda.device_count() + 1)
    assert tcli.main(["mapping", "--synthetic", "3", "--mesh-devices", str(n)]) == 2
    assert f"needs {n} CUDA cards, found {torch.cuda.device_count()}" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:  # one named card for two ranks
        tcli.main(["mapping", "--synthetic", "3", "--mesh-devices", "2", "--device", "cuda:0"])
    assert e.value.code == 2 and "names one card" in capsys.readouterr().err
    assert tcli.main(["mapping", "--synthetic", "3", "--mesh-devices", "2", "--device", "cpu",
                      "--out", str(tmp_path / "mesh")]) == 0
    assert len(read_kitti_trajectory(str(tmp_path / "mesh" / "trajectory" / "laser_odom.txt"))) == 3
    with pytest.raises(SystemExit):
        tcli.main(["matching"])  # no frame source
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):  # no --device cpu and no card: fails at once
            tcli.main(["inspect", "--kitti-raw", drive])
        assert "CUDA is not available" in capsys.readouterr().err
