#!/usr/bin/env python3
"""Kernel K2's times on one GPU, per search and per compiled lane count.

    python3 chip_knn.py [--root DIR] [--out FILE]

Times `window_knn` of the port in the checkout at DIR (default: this
script's own checkout), so that two checkouts, a parent and a change, can be
timed in one run on one card. The searches are chip_smoke.py's A-LOAM
ones (`knn_cases`), at both of its densities: odometry's and mapping's at
sweep 2, and at chip_smoke.DENSE mapping's two against the full maps that
the drive leaves. For each search it records the wrapper's device time
(CUDA events, median of 15 calls, chip_smoke's `device_ms`) and the
kernel's alone (torch.profiler, 10 calls, chip_smoke's `device_events`); where the checkout's
`window_knn` takes `lanes`, every compiled lane count's kernel time as
well. It also records each density's A-LOAM drive (chip_smoke's
`aloam_drive`: ms/sweep, its checks) and K2's launches in it. Prints the
card's name and power limit, then one JSON line (also written to FILE).
"""

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose lidar_slam_tpu_torch is timed")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        print("chip_knn: CUDA is not available; this measurement runs only on a GPU", file=sys.stderr)
        return 2
    import lidar_slam_tpu_torch
    from lidar_slam_tpu_torch.ops.cuda import build, knn_fused

    if Path(lidar_slam_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"chip_knn: imported {lidar_slam_tpu_torch.__file__}, not the package under {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[chip_knn] {root}: {smi}", flush=True)
    build.build("knn_fused")
    variants = getattr(knn_fused, "LANES", ())  # the parent's window_knn has one variant
    dev = lidar_slam_tpu_torch.device("cuda")
    out = {"root": str(root), "card": smi, "searches": [], "drives": []}
    for density in cs.ALOAM_DENSITIES:
        traj, frames = cs.aloam_workload(density)
        pipe = cs.primed_pipeline(dev, traj, frames)
        searches = [(f"{density:g}", cs.knn_cases(pipe.state, *pipe.preload(*frames[2])))]
        cs.reset_launches()
        ms_sweep, pipe = cs.aloam_drive(dev, traj, frames, f"{density:g}")
        out["drives"].append({"density": f"{density:g}", "ms_per_sweep": ms_sweep, "k2_launches": knn_fused.launches})
        if density == cs.DENSE:
            searches.append((f"{density:g} after the drive",
                             cs.knn_cases(pipe.state, *pipe.preload(*frames[-1]), after_drive=True)))
        for label, cases in searches:
            for name, (grid, q, qm, k, radius, extras) in cases.items():
                def call(**kw):
                    return knn_fused.window_knn(grid, q, qm, k, radius, extras, **kw)

                entry = {"density": label, "case": name, "queries": int(qm.sum()), "rows": int(grid.valid.sum()),
                         "largest_cell": int(grid.cell_counts.max()), "ms": cs.device_ms(call, reps=15)}
                times = {key: us / n / 1e3 for key, (n, us) in cs.device_events(call).items()}
                entry["alone_ms"] = sum(t for key, t in times.items() if "knn_kernel" in key)
                entry["other_device_ms"] = sum(t for key, t in times.items() if "knn_kernel" not in key)
                if variants:  # every lane count in one profiler window
                    entry["lanes"] = knn_fused.default_lanes(grid.cell_size)
                    events = cs.device_events(lambda: [call(lanes=g) for g in variants])
                    entry["variants"] = {int(m.group(1)): us / n / 1e3 for key, (n, us) in events.items()
                                         if (m := re.search(r"knn_kernel<\d+, (\d+)>", key))}
                print(f"[chip_knn] {json.dumps(entry)}", flush=True)
                out["searches"].append(entry)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
