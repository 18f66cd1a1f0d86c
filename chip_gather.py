#!/usr/bin/env python3
"""Kernel K3's times on one GPU, per entry, and the onehot drive.

    python3 chip_gather.py [--root DIR] [--out FILE]

Times the K3 gather of the port in the checkout at DIR (default: this
script's own checkout), so that two checkouts, a parent and a change, can be
timed in one run on one card. The inputs are chip_smoke.py's phase 8
(`gather_cases`: the NDT map of the bench corridor and one frame's direct7
and radius27 voxel ids). For each stencil it records the general entry
`gather_stats_onehot` (device time from CUDA events, the median of 30 calls,
chip_smoke's `device_ms`; its kernel alone and the rest of its device work,
the key sort, from torch.profiler, chip_smoke's `device_events`) and, where
the checkout has it, the presorted entry `gather_stats_sorted` on the map's
keys. Each call's rows are checked against the plain version. Then the onehot scan-match drive (chip_smoke's
`onehot_drive`): ms/frame, K3's device time a frame, sort kernels. Prints
the card's name and power limit, then one JSON line (also written to FILE).
"""

import argparse
import importlib.util
import json
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
        print("chip_gather: CUDA is not available; this measurement runs only on a GPU", file=sys.stderr)
        return 2
    import lidar_slam_tpu_torch
    from lidar_slam_tpu_torch.models.registration import NDTConfig
    from lidar_slam_tpu_torch.ops.cuda import build, ndt_gather

    if Path(lidar_slam_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"chip_gather: imported {lidar_slam_tpu_torch.__file__}, not the package under {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[chip_gather] {root}: {smi}", flush=True)
    for ln in build.build("ndt_gather").log.splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"[chip_gather] {ln.strip()}", flush=True)
    dev = lidar_slam_tpu_torch.device("cuda")
    cfg = NDTConfig(resolution=1.0, grid_dims=(256, 256, 64), point_chunk=8192, max_iter=30, stencil="direct7",
                    gather="fused", max_compact_voxels=65536, fused_window=512)
    workload = cs.build_workload(dev)
    ndt_map, cases = cs.gather_cases(workload, cfg)
    keys, table = ndt_map.keys, ndt_map.packed
    sorted_entry = getattr(ndt_gather, "gather_stats_sorted", None)  # absent from the earlier form
    out = {"root": str(root), "card": smi, "stencils": [], "drive": None}

    def timed(call, plain):
        cs.check(torch.equal(call(), plain), "K3 rows differ from the plain version")
        times = {key: us / n / 1e3 for key, (n, us) in cs.device_events(call).items()}
        return {"ms": cs.device_ms(call),
                "alone_ms": sum(t for key, t in times.items() if cs.is_k3_kernel(key)),
                "other_device_ms": sum(t for key, t in times.items() if not cs.is_k3_kernel(key))}

    for stencil, vids in cases.items():
        plain = ndt_gather.gather_stats_plain(keys, table, vids)
        entry = {"stencil": stencil, "ids": vids.numel(), "keys": keys.numel(),
                 "bound_ms": cs.bound(cs.gather_work(keys, vids), 0)[0],
                 "general": timed(lambda: ndt_gather.gather_stats_onehot(keys, table, vids), plain)}
        if sorted_entry is not None:
            entry["sorted"] = timed(lambda: sorted_entry(keys, table, vids), plain)
        print(f"[chip_gather] {json.dumps(entry)}", flush=True)
        out["stencils"].append(entry)
    cs.reset_launches()
    out["drive"] = cs.onehot_drive(workload, cfg)
    out["drive"]["k3_launches"] = ndt_gather.launches
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
