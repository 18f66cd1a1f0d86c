"""The `mapping` command with the A-LOAM front end, as a user runs it over
a logged drive.

The configuration's `cli_config` chooses the front end
(`front_end_method: aloam`) and states A-LOAM's settings in its `aloam`
section; the run is `entries/mapping_cli.py`'s, imported: the same
`cli.main(["mapping", ...])` with the drive as its frame source, the same
record of stages, keyframes, loop edges and solves, the same window and
traced tail. On top of it, in the traced tail alone, each `window_knn`
launch (kernel K2, looked up by A-LOAM's odometry and mapping modules under
that name) is wrapped, and the work its roofline needs is counted on the
card from the launch's inputs and result as it returns
(`roofline_knn.work`): the record keeps those counts, `knn_work`, and no
tensor of the program. The record also keeps the program's counters of
the run (`counters`: `aloam_capped`, `aloam_map_evicted_in_window`, ...).

A program whose configuration has no `aloam` section cannot run this
deployment at its settings: the run stops at once with a message, and
never falls back to the NDT front end.
"""

from __future__ import annotations

import contextlib
import dataclasses

from slam_bench import roofline_knn
from slam_bench.entries import mapping_cli
from slam_bench.entries.mapping_cli import window_frames  # noqa: F401  (the harness reads it here)


def require_aloam_section() -> None:
    """Stop (SystemExit, exit code 1) where the program's configuration
    has no `aloam` section."""
    from lidar_slam_tpu_torch import config as program_config

    if "aloam" not in {f.name for f in dataclasses.fields(program_config.SlamConfig)}:
        raise SystemExit("slam_bench: the program's configuration has no `aloam` section, so it cannot run "
                         "the A-LOAM deployment at its settings; this cell stops here")


def run(config: dict, drive, trace: bool, device: str, out_dir: str):
    """mapping_cli.run with the A-LOAM front end, `window_knn`'s work
    counted over the traced tail, and the program's counters."""
    require_aloam_section()
    import torch

    import lidar_slam_tpu_torch.pipeline.aloam.mapping as mapping
    import lidar_slam_tpu_torch.pipeline.aloam.odometry as odometry
    import lidar_slam_tpu_torch.utils.watchdog as watchdog

    st = {"frame": -1, "tail": False}
    tail_from = drive.setup + drive.window
    work = []
    base_health = watchdog.RunHealth
    base_knn = {m: m.window_knn for m in (odometry, mapping)}

    class Health(base_health):
        @contextlib.contextmanager
        def stage(self, name, budget_ms=None):
            if name == "front_end":
                st["frame"] += 1
                st["tail"] = trace and st["frame"] >= tail_from
            with super().stage(name, budget_ms):
                yield

    def counted(base):
        def window_knn(grid, queries, query_mask, k, max_radius, extras=None, lanes=None):
            out = base(grid, queries, query_mask, k, max_radius, extras, lanes)
            if st["tail"]:
                n_extra = 0 if extras is None else (1 if extras.ndim == 1 else extras.shape[1])
                work.append(roofline_knn.work(grid, queries, query_mask, k, n_extra, out["ok"]))
            return out
        return window_knn

    watchdog.RunHealth = Health
    for m, base in base_knn.items():
        m.window_knn = counted(base)
    try:
        rec = mapping_cli.run(config, drive, trace, device, out_dir)
    finally:
        watchdog.RunHealth = base_health
        for m, base in base_knn.items():
            m.window_knn = base
    rec.knn_work = torch.stack(work).cpu().tolist() if work else []
    last = watchdog.last_run()
    rec.counters = {} if last is None else dict(last.counters)
    return rec
