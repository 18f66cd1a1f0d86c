"""The A-LOAM front end's settings reach the port from the CLI's YAML.

The `aloam` section (pipeline.aloam.AloamConfig: a sub-section for each of
the three configuration classes, under their own keys) reaches them; a
key, or the whole section, left out keeps the CLI's earlier A-LOAM
settings; the YAML's
`front_end_method` chooses the front end and `--front-end` overrides it.
The padded sweep's rows come from the configuration, never from
`--synthetic`: a sweep of 131 072 returns reaches feature extraction whole,
and one with more returns than the rows is refused with a message, never
cut. Torch is pinned to one CPU thread while the file runs.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch import cli
from lidar_slam_tpu_torch.config import load_config
from lidar_slam_tpu_torch.pipeline import aloam as ta
from lidar_slam_tpu_torch.pipeline.aloam import pipeline as tpipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECTION = """\
front_end_method: aloam
aloam:
  features:
    n_scans: 16
    min_range: 5.0
    capacity: 4096
    max_sharp: 128
    max_less_sharp: 1024
    max_flat: 256
    max_less_flat: 4096
  odometry:
    outer_iters: 2
    gn_iters: 4
  mapping:
    line_res: 0.3
    plane_res: 0.6
    stack_corner_capacity: 1024
    stack_surf_capacity: 2048
    corner_map_capacity: 8192
    surf_map_capacity: 16384
    outer_iters: 3
    gn_iters: 5
"""


def yaml(tmp_path, section: str = SECTION):
    """configs/synthetic_small.yaml (the CPU tests' small back half) with
    `section` added."""
    with open(os.path.join(ROOT, "configs", "synthetic_small.yaml")) as f:
        text = f.read()
    path = tmp_path / "config.yaml"
    path.write_text(text + section)
    return path


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sweep(n: int, seed: int = 0) -> np.ndarray:
    """n returns of a 16-ring sensor on a 20 m x 12 m room's floor and
    walls (x, y within the room, elevations on the VLP-16 formula's beams)."""
    rng = np.random.default_rng(seed)
    ring = rng.integers(0, 16, n)
    az = rng.uniform(-np.pi, np.pi, n)
    el = np.radians(-15.0 + 2.0 * ring)
    r = rng.uniform(6.0, 9.0, n)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], -1).astype(np.float32)


def recorded(monkeypatch, frames):
    """Run `cli.main` with the frame source replaced by `frames`, the
    A-LOAM front end recorded and the mapping run's final pose-graph solve
    skipped (it serves nothing checked here): returns (made, seen) where
    `made` holds the AloamPipeline the CLI made and `seen` the valid rows
    of each sweep that reached feature extraction."""
    from lidar_slam_tpu_torch.pipeline import back_end

    made, seen = {}, []
    base_fe, base_extract = cli._AloamFrontEnd, tpipeline.extract_features

    def front_end(*a, **k):
        made["fe"] = base_fe(*a, **k)
        made["args"] = (a, k)
        return made["fe"]

    def extract(points, mask, cfg):
        seen.append(int(mask.sum()))
        return base_extract(points, mask, cfg)

    monkeypatch.setattr(cli, "_AloamFrontEnd", front_end)
    monkeypatch.setattr(tpipeline, "extract_features", extract)
    monkeypatch.setattr(back_end.BackEnd, "force_optimize", lambda self: {})
    monkeypatch.setattr(cli, "_frame_source", lambda args: iter(
        {"points": p, "time": 0.1 * i, "gnss_position": np.zeros(3)} for i, p in enumerate(frames)))
    return made, seen


def test_the_aloam_section_reaches_the_three_configs(tmp_path, monkeypatch):
    """The YAML's `aloam` section, and its front_end_method, through `mapping`."""
    path = yaml(tmp_path)
    made, seen = recorded(monkeypatch, [sweep(3000, 0), sweep(3000, 1)])
    assert cli.main(["mapping", "--synthetic", "2", "--config", str(path), "--out", str(tmp_path / "out"),
                     "--device", "cpu"]) == 0
    fe = made["fe"]
    assert (fe.fe_cfg.n_scans, fe.fe_cfg.min_range, fe.fe_cfg.capacity) == (16, 5.0, 4096)
    assert (fe.fe_cfg.max_sharp, fe.fe_cfg.max_less_sharp, fe.fe_cfg.max_flat, fe.fe_cfg.max_less_flat) == (
        128, 1024, 256, 4096)
    assert (fe.odo_cfg.outer_iters, fe.odo_cfg.gn_iters) == (2, 4)
    m = fe.map_cfg
    assert (m.line_res, m.plane_res, m.outer_iters, m.gn_iters) == (0.3, 0.6, 3, 5)
    assert (m.stack_corner_capacity, m.stack_surf_capacity, m.corner_map_capacity, m.surf_map_capacity) == (
        1024, 2048, 8192, 16384)
    assert seen == [3000, 3000]


def test_an_absent_section_keeps_the_earlier_settings(tmp_path):
    """No `aloam` section (the repository's configs, or none): the CLI's
    A-LOAM settings before the section existed, and the NDT front end. A
    sub-section that names some keys keeps those settings for the rest,
    and an unknown key is refused."""
    for path in (None, "configs/kitti_hdl64.yaml", "configs/synthetic_small.yaml"):
        cfg = load_config(path)
        assert cfg.aloam == ta.AloamConfig() and cfg.front_end_method == "ndt"
    a = ta.AloamConfig()
    fe = ta.FeatureExtractionConfig(n_scans=64, min_range=2.5, capacity=131072, max_sharp=1024,
                                    max_less_sharp=8192, max_flat=2048, max_less_flat=16384)
    assert (a.features, a.odometry, a.mapping) == (fe, ta.AloamOdometryConfig(), ta.AloamMappingConfig())
    pipe = cli._AloamFrontEnd(device="cpu")
    assert (pipe.fe_cfg, pipe.odo_cfg, pipe.map_cfg) == (a.features, a.odometry, a.mapping)
    part = load_config(yaml(tmp_path, "aloam:\n  features:\n    n_scans: 16\n  odometry:\n    gn_iters: 4\n"))
    assert part.aloam.features == dataclasses.replace(fe, n_scans=16)
    assert part.aloam.odometry == ta.AloamOdometryConfig(gn_iters=4) and part.aloam.mapping == a.mapping
    with pytest.raises(KeyError, match="mapping_skip_frame"):
        load_config(yaml(tmp_path, "aloam:\n  mapping:\n    mapping_skip_frame: 1\n"))


def test_front_end_flag_overrides_the_yaml(tmp_path, monkeypatch, capsys):
    """`--front-end ndt` runs the NDT front end over a YAML that chooses
    A-LOAM; a front_end_method that names no front end is refused."""
    path = yaml(tmp_path)
    made, seen = recorded(monkeypatch, [sweep(3000)])
    assert cli.main(["mapping", "--synthetic", "1", "--config", str(path), "--front-end", "ndt",
                     "--out", str(tmp_path / "out"), "--device", "cpu"]) == 0
    assert "fe" not in made and seen == []
    bad = tmp_path / "bad.yaml"
    bad.write_text("front_end_method: loam\n")
    with pytest.raises(SystemExit) as e:
        cli.main(["mapping", "--synthetic", "1", "--config", str(bad), "--out", str(tmp_path / "o2"),
                  "--device", "cpu"])
    assert e.value.code == 2 and "front_end_method 'loam'" in capsys.readouterr().err


def test_a_full_width_sweep_reaches_feature_extraction_whole(tmp_path, monkeypatch):
    """`mapping --synthetic 1 --front-end aloam` pads to the configuration's
    131 072 rows (the section's default), so a sweep of 131 072 returns
    reaches feature extraction whole, where the CLI once padded to 65 536
    under --synthetic and cut the rest."""
    made, seen = recorded(monkeypatch, [sweep(131072, 2)])
    assert cli.main(["mapping", "--synthetic", "1", "--front-end", "aloam", "--config", str(yaml(tmp_path, "")),
                     "--out", str(tmp_path / "out"), "--device", "cpu"]) == 0
    assert made["fe"].fe_cfg.capacity == 131072 and seen == [131072]


def test_a_sweep_over_the_rows_is_refused(tmp_path, monkeypatch):
    """A sweep with more returns than the padded rows is refused, with the
    rows and the setting to raise, by the front end and through `mapping`."""
    pipe = ta.AloamPipeline(ta.FeatureExtractionConfig(n_scans=16, capacity=4096), device="cpu")
    assert int(pipe.preload(sweep(4096))[1].sum()) == 4096
    with pytest.raises(ValueError, match=r"4097 returns is over the padded sweep's 4096 rows.*features\.capacity"):
        pipe.preload(sweep(4097))
    path = yaml(tmp_path)
    recorded(monkeypatch, [sweep(3000), sweep(5000)])
    with pytest.raises(ValueError, match="5000 returns is over the padded sweep's 4096 rows"):
        cli.main(["mapping", "--synthetic", "2", "--config", str(path), "--out", str(tmp_path / "out"),
                  "--device", "cpu"])
