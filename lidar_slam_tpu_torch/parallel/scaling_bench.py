"""Multi-rank scaling of the two sharded reductions (port of
lidar_slam_tpu/parallel/scaling_bench.py): the point-sharded NDT
derivative evaluation and the sharded map build, timed at each world size
and reported as efficiency against one rank. The reduced results agree
across world sizes up to float32 summation order (the spread is printed).
On the CPU, or with ranks sharing one card, the times say nothing about
scaling; on N cards the same entry point gives the real curve.

    python3 -m lidar_slam_tpu_torch.parallel.scaling_bench [n_points] [--device cpu] [--counts 1 2]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.registration import NDTConfig, build_ndt_map
from ..ops.pointcloud import PointCloud
from .launch import launch
from .mesh import Mesh
from .sharded_ndt import sharded_build_ndt_map, sharded_ndt_derivatives


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def scaling_rank(mesh: Mesh, n_points: int, repeats: int) -> Dict:
    """One rank: the mean wall time of a sharded evaluation and of a sharded
    map build (synchronised), and the evaluation's score."""
    dev = mesh.device
    cfg = NDTConfig(resolution=1.0, grid_dims=(128, 128, 32), point_chunk=min(8192, n_points))
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 100, (n_points, 3)).astype(np.float32)
    pts[:, 2] *= 0.06
    target = PointCloud.from_points(pts, device=dev)
    ndt_map = build_ndt_map(target, cfg)
    source = PointCloud.from_points(pts + 0.1, device=dev)
    pose = np.zeros(6, np.float32)
    origin = np.floor(pts.min(axis=0) - 1.0)
    out = sharded_ndt_derivatives(ndt_map, source, pose, cfg, mesh)  # warm-up
    sharded_build_ndt_map(target, origin, cfg, mesh)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = sharded_ndt_derivatives(ndt_map, source, pose, cfg, mesh)
    eval_s = (time.perf_counter() - t0) / repeats  # each evaluation ends in a host copy
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(repeats):
        sharded_build_ndt_map(target, origin, cfg, mesh)
    _sync(dev)
    build_s = (time.perf_counter() - t0) / repeats
    return {"eval_ms": eval_s * 1e3, "map_build_ms": build_s * 1e3, "score": float(out[0])}


def measure_scaling(n_points: int = 65536, repeats: int = 10, device_counts: Optional[List[int]] = None,
                    device=None) -> List[Dict]:
    """One launch per world size (NCCL on the cards, or gloo on `device`);
    efficiency = rate / (one rank's rate x ranks)."""
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= torch.cuda.device_count()]
    results, base = [], None
    for d in device_counts:
        r = launch(scaling_rank, d, args=(n_points, repeats), device=device)
        rate = n_points / (r["eval_ms"] / 1e3)
        base = base or (rate, r["map_build_ms"])
        results.append({
            "devices": d, "eval_ms": r["eval_ms"], "points_per_s": rate,
            "scaling_efficiency": rate / (base[0] * d), "map_build_ms": r["map_build_ms"],
            "map_build_speedup": base[1] / r["map_build_ms"], "score": r["score"],
        })
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Scaling of the sharded NDT reductions over ranks.")
    ap.add_argument("n_points", type=int, nargs="?", default=65536)
    ap.add_argument("--device", default=None, help="run every rank on this device under gloo (e.g. cpu)")
    ap.add_argument("--counts", type=int, nargs="+", default=None, help="world sizes (default: 1, 2, 4, ... cards)")
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args(argv)
    rows = measure_scaling(args.n_points, args.repeats, args.counts, args.device)
    if not rows:
        ap.error("no CUDA card: pass --device cpu and --counts")
    for r in rows:
        print(f"devices={r['devices']:3d}  eval {r['eval_ms']:8.2f} ms  {r['points_per_s']:12.0f} pts/s  "
              f"efficiency {r['scaling_efficiency']:.2f}  map build {r['map_build_ms']:8.2f} ms  "
              f"speedup {r['map_build_speedup']:.2f}x")
    scores = [r["score"] for r in rows]
    print(f"cross-mesh score spread: {max(scores) - min(scores):.3e} (float32 summation order only)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
