"""One run of one cell of the benchmark.

    python3 -m slam_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell names a configuration
(`configs/<config>.json`: the deployment's settings, the entry that drives
it and the reference that judges it) and a traffic mix
(`traffic/<traffic>.json`: parameters of the one generator). The entry
(`entries/<entry>.py`) runs the program over the drive and records what it
gave out; the harness takes the end-to-end metrics from that record, the
per-layer metrics (`metrics/<metric>.py`) from a traced run (host spans of
its untraced window, device operations of the traced tail after it), and
`correct` from the reference's judgement (`reference/<reference>.py`)
against the configuration's limits and floors. The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

from slam_bench import window

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "lidar_slam_tpu")  # top-level module names, compared whole


def manifest(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load(kind: str, name: str) -> dict:
    """configs/<name>.json or traffic/<name>.json of the benchmark."""
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"slam_bench: no workload {workload!r} in BENCHMARK.json")


def per_layer(bench: dict, workload: str) -> list:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list of cells."""
    return [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class View:
    """What a metric reader reads: the entry's record, the window's frames
    [(frame, hand-over, pose)] and their ids, the host window [w0, w1] and,
    in a traced run, the device's operations and busy seconds over the
    traced tail."""

    rec: object
    frames: list
    ids: set
    w0: float
    w1: float
    events: list = None
    busy_s: float = None
    window_s: float = None


def end_to_end(frames: list, window_s: float, setup_s: float) -> dict:
    """The end-to-end metrics of a window from its frames [(frame,
    hand-over, pose)]: the window's frames over its seconds, and the set-up."""
    return {"frames_per_s": window.rate(len(frames), window_s), "setup_s": setup_s}


def decide(numbers: dict, config: dict) -> tuple:
    """(correct, checks): every number of the configuration's `limits` at
    most its limit and of its `floors` at least its floor. A number the
    judge did not give is missing, and fails."""
    checks = {}
    for kind, bounds in (("at_most", config["limits"]), ("at_least", config.get("floors", {}))):
        for k, lim in bounds.items():
            v = numbers.get(k)
            checks[k] = {"value": None if v is None or not np.isfinite(v) else float(v), "limit": lim,
                         "must_be": kind}
    ok = all(c["value"] is not None and (c["value"] <= c["limit"] if c["must_be"] == "at_most"
                                         else c["value"] >= c["limit"]) for c in checks.values())
    return ok, checks


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str, bench: dict = None,
             config: dict = None, mix: dict = None, t_start: float = None, variants: tuple = ()) -> tuple:
    """One run of `workload` on `device`; returns (result dict, the compared
    numbers with their limits). `config` and `mix` replace the files' (the
    tests run small ones on the CPU). `variants` also judges, over the same
    window frames, the reference's stand-ins for the program (the control
    and planted faults, reference.VARIANTS), each decided by the same rule,
    under the result's "variants" key (the benchmark's runs never do)."""
    import torch

    from slam_bench import trace as tr
    from slam_bench.traffic.generator import make_drive

    t_start = time.perf_counter() if t_start is None else t_start
    bench = manifest(os.path.dirname(HERE)) if bench is None else bench
    w = cell(bench, workload)
    config = load("configs", w["config"]) if config is None else config
    mix = load("traffic", w["traffic"]) if mix is None else mix
    entry = importlib.import_module(f"slam_bench.entries.{config['entry']}")
    reference = importlib.import_module(f"slam_bench.reference.{config['reference']}")

    drive = make_drive(mix, config["sweep"], device, seconds, trace)
    out_dir = tempfile.mkdtemp(prefix="slam_bench-")
    try:
        rec = entry.run(config, drive, trace, device, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    frames = entry.window_frames(rec)
    ids = {f for f, _, _ in frames}
    whole = rec.window1 is not None and len(frames) == drive.window
    window_s = rec.window1 - rec.window0 if whole else float("nan")
    setup_s = rec.window0 - t_start if rec.window0 is not None else float("nan")
    metrics = {} if trace else end_to_end(frames, window_s, setup_s)
    pose_ms = [(t1 - t0) * 1e3 for _, t0, t1 in frames]
    print(f"[slam_bench] {workload}: {len(frames)} of the window's {drive.window} frames ({drive.laps} laps) in "
          f"{window_s:.3f} s, pose ms median {window.percentile(pose_ms, 50) if pose_ms else None} over "
          f"{len(pose_ms)} frames; set-up {setup_s:.3f} s; after the frame loop {rec.end_s} s; store "
          f"{rec.store_bytes} bytes; launches {rec.launches}; loops {len(rec.loops)}, in the window "
          f"{sum(lp['frame'] in ids for lp in rec.loops)}; solves in the window "
          f"{[round(s['end'] - s['start'], 3) for s in rec.solves if s['frame'] in ids]}", file=sys.stderr, flush=True)
    view = View(rec=rec, frames=frames, ids=ids, w0=rec.window0, w1=rec.window1)
    extra = {}
    if trace and rec.trace is not None:
        events = tr.device_events(rec.trace)
        t0, t1 = rec.trace_window
        view.events, view.window_s = events, t1 - t0
        view.busy_s = tr.busy_ns(events) * 1e-9
        ns = lambda t: int(t * 1e9) + rec.clock_offset_ns  # noqa: E731
        spans = [("pose_graph", ns(s["start"]), ns(s["end"])) for s in rec.solves]
        spans += [(name, ns(a), ns(b)) for name, a, b, _ in rec.spans]
        extra["breakdown"] = {"device_ops": tr.top_ops(events),
                              "idle_gaps": tr.idle_gaps(events, (ns(t0), ns(t1)), spans)}
        print(f"[slam_bench] traced tail: {t1 - t0:.3f} s, device busy {view.busy_s:.3f} s, "
              f"{len(rec.newton_calls)} ndt_newton launches", file=sys.stderr, flush=True)
    if trace:
        for m in per_layer(bench, workload):
            value = importlib.import_module(f"slam_bench.metrics.{m['name']}").read(view)
            if value is not None:
                metrics[m["name"]] = value
    # the reference runs once the program's state is gone
    rec.newton_calls, rec.trace = [], None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    numbers = reference.judge(rec, drive, config, device, [f for f, _, _ in frames],
                              variants=("program",) + tuple(variants))
    print(f"[slam_bench] the judge ({time.perf_counter() - t_judge:.1f} s): {json.dumps(numbers['program'])}",
          file=sys.stderr, flush=True)
    correct, checks = decide(numbers["program"], config)
    poses = np.stack([rec.poses[f] for f, _, _ in frames]) if frames else np.zeros((0, 4, 4))
    steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1) if len(poses) > 1 else np.zeros(0)
    failed = int(np.sum(~np.all(np.isfinite(poses.reshape(len(poses), -1)), axis=1))) + int(np.sum(steps > 5.0))
    correct = correct and rec.rc == 0 and whole and failed == 0
    if variants:
        extra["variants"] = {v: {"correct": decide(numbers[v], config)[0], "numbers": numbers[v]} for v in numbers}
    result = {"correct": bool(correct), "attempted": drive.window, "failed": failed + drive.window - len(frames),
              "metrics": {k: {"value": v, "unit": _unit(bench, k)} for k, v in metrics.items()},
              "device": _device(device, rec, view if trace else None), **extra, "checks": checks}
    return result, checks


def _unit(bench: dict, name: str) -> str:
    return next(m["unit"] for m in bench["end_to_end"] + bench["per_layer"] if m["name"] == name)


def _device(device: str, rec, view) -> dict:
    import torch

    dev = torch.device(device)
    out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
           "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": rec.memory_peak_bytes}
    if view is not None:
        out.update(busy_s=view.busy_s, window_s=view.window_s)
    return out


def main(argv=None, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(prog="slam_bench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = os.path.dirname(HERE)
    if not os.path.isdir(os.path.join(root, "lidar_slam_tpu_torch")):
        print("slam_bench: the program (lidar_slam_tpu_torch) is not in this checkout", file=sys.stderr)
        return 2
    bench = manifest(root)
    w = cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"slam_bench: {args.workload} needs {w['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", bench=bench,
                              t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"slam_bench: modules loaded in this process that the benchmark forbids: {found}", file=sys.stderr)
        return 4
    for k, c in checks.items():
        print(f"{k} {c['value']!r} {c['must_be'].replace('_', ' ')} {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
