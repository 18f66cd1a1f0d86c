#!/usr/bin/env python3
"""The pose graph's PCG on one GPU at the benchmark cell's graph.

    python3 chip_pcg.py [--out FILE]

The graph is `bench.shuttle_graph` at the back end's capacities (2 048
nodes, 4 096 edges, 2 048 priors; 540 valid nodes, 629 edges, 540 GNSS
priors), solved as `mapping` solves it (BackEndConfig().optimizer, PCG).
It prints the card's name and power limit, then:

  1. where a solve's device time goes: torch.profiler over two LM
     iterations of `optimize_pose_graph`, device ms by kernel name;
  2. the plain path's node sums by call site: each `_segment_sum` of an
     LM iteration's `_solve_pcg` and `_gradient`, device ms a call
     (chip_smoke's device_ms), with its index's longest run of one node
     (the padded rows all name node 0), and again with the padded rows
     dropped (`keep` = the row's validity), which leaves the same sums on
     every free node; the same scatter kernels' device ms in one map
     build;
  3. where `ops/cuda/pose_pcg.py` exists: chip_smoke's phase 23 (the
     kernel against `_solve_pcg`, its device ms, bound and launches), a
     whole solve's wall ms an LM iteration, and phase 1 again on the
     kernel's path.

Ends with one JSON line (also written to FILE).
"""

import argparse
import dataclasses
import importlib.util
import json
import sys
import time

import numpy as np

from chip_smoke import device_ms, pose_pcg_phase
from lidar_slam_tpu_torch.bench import device_label


def log(msg):
    print(msg, flush=True)


def cell_graph(dev):
    from lidar_slam_tpu_torch.bench import shuttle_graph
    from lidar_slam_tpu_torch.models import graph_optimizer as G

    b = G.PoseGraphBuilder(2048, 4096, 2048, device=dev)
    shuttle_graph(b, np.random.default_rng(0))
    return b, b.to_graph()


def profile_solve(graph, cfg):
    """Phase 1: two LM iterations of a solve under torch.profiler, device ms
    by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lidar_slam_tpu_torch.models import graph_optimizer as G

    cfg = dataclasses.replace(cfg, max_iterations=2)
    G.optimize_pose_graph(graph, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, st = G.optimize_pose_graph(graph, cfg)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        if e.device_type is not None and "CUDA" in str(e.device_type) and dev_us > 0:
            rows.append((e.key, e.count, dev_us / 1e3))
    rows.sort(key=lambda r: -r[2])
    total = sum(r[2] for r in rows)
    log(f"[solve] {st['iterations']} LM iterations; device busy {total:.1f} ms (sum of kernels)")
    for k, n, ms in rows[:8]:
        log(f"[solve]   {ms:9.2f} ms {100 * ms / max(total, 1e-9):5.1f} % {n:7d} calls  {k[:90]}")
    return {"iterations": st["iterations"], "device_ms": total,
            "top": [{"kernel": k[:120], "calls": n, "ms": ms} for k, n, ms in rows[:8]]}


def map_build_scatters(dev):
    """Phase 2b: the map builds' scatters beside the PCG's: one
    `voxel_downsample` (0.5 m leaf) of a 131 072-row sweep-sized cloud and
    one `build_ndt_map` (1 m voxels, 256 x 256 x 64) of the result under
    torch.profiler, the sort-based scatter kernel's calls and device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lidar_slam_tpu_torch.models.registration import NDTConfig, build_ndt_map
    from lidar_slam_tpu_torch.ops import PointCloud, voxel_downsample

    rng = np.random.default_rng(1)
    r = rng.uniform(2.0, 80.0, 131072)
    a = rng.uniform(-np.pi, np.pi, 131072)
    pts = np.stack([r * np.cos(a), r * np.sin(a), rng.uniform(-2.0, 4.0, 131072)], 1).astype(np.float32)
    cloud = PointCloud.from_points(pts, device=dev)
    cfg = NDTConfig(resolution=1.0, grid_dims=(256, 256, 64))

    def build():
        return build_ndt_map(voxel_downsample(cloud, 0.5, 32768), cfg)

    build()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        build()
        torch.cuda.synchronize()
    calls, ms = 0, 0.0
    for e in prof.key_averages():
        if "indexing_backward_kernel" in e.key and e.device_type is not None and "CUDA" in str(e.device_type):
            calls += e.count
            ms += getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / 1e3
    log(f"[map build] voxel_downsample + build_ndt_map: sort-based scatter kernels {calls} calls, {ms:.4f} ms device")
    return {"calls": calls, "ms": ms}


def scatter_split(b, graph, cfg):
    """Phase 2: one LM iteration's node sums of the plain path, by call site."""
    import torch

    from lidar_slam_tpu_torch.models import graph_optimizer as G
    from lidar_slam_tpu_torch.ops.pointcloud import scatter_sum

    asm = G._assemble(graph, cfg)
    valid = {"i": graph.edge_valid, "j": graph.edge_valid, "pn": graph.prior_valid}
    host = {"i": b._edge_ij[:, 0], "j": b._edge_ij[:, 1], "pn": b._prior_node}
    runs = {k: int(np.bincount(v).max()) for k, v in host.items()}
    n = asm["n"]
    sites = {
        "matvec edges i": ("i", lambda: asm["bi"]),  # a [E, 6] row, as the matvec's yi
        "matvec edges j": ("j", lambda: asm["bj"]),
        "matvec priors": ("pn", lambda: asm["bp"]),
        "diag Hii": ("i", lambda: asm["Hii"]),
        "diag Hjj": ("j", lambda: asm["Hjj"]),
        "diag Hp": ("pn", lambda: asm["Hp"]),
    }
    out = {}
    for name, (key, vals) in sites.items():
        v, idx = vals(), asm[key]
        ones = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
        padded = device_ms(lambda: scatter_sum(v.new_zeros((n, *v.shape[1:])), idx, v, ones))
        dropped = device_ms(lambda: scatter_sum(v.new_zeros((n, *v.shape[1:])), idx, v, valid[key]))
        out[name] = {"run": runs[key], "rows": int(idx.shape[0]), "ms": padded, "ms_padded_rows_dropped": dropped}
        log(f"[split] {name:15s}: {idx.shape[0]} rows, longest run {runs[key]} (node 0): {padded:.4f} ms; "
            f"padded rows dropped: {dropped:.4f} ms")
    lam = torch.full((), cfg.lm_lambda_init, device=graph.poses.device)
    grad = G._gradient(asm)
    solve = device_ms(lambda: G._solve_pcg(asm, lam, grad, cfg), reps=3)
    per_step = solve / cfg.pcg_iters
    matvec = out["matvec edges i"]["ms"] + out["matvec edges j"]["ms"] + out["matvec priors"]["ms"]
    log(f"[split] _solve_pcg: {solve:.2f} ms ({per_step:.4f} ms a step; its ~12 000 launches outrun the queued "
        f"sleep, so this is stream time); the three matvec scatters {matvec:.4f} ms of device time a step")
    out["solve_pcg_ms"] = solve
    return out


def kernel_solve(graph, cfg, mod):
    """Phase 3: chip_smoke's phase 23, then a whole solve's wall ms an LM
    iteration (synchronised) and its launches."""
    import torch

    from lidar_slam_tpu_torch.models import graph_optimizer as G

    out = pose_pcg_phase(graph.poses.device, device_label(graph.poses.device))
    G.optimize_pose_graph(graph, cfg)
    torch.cuda.synchronize()
    mod.launches = 0
    t0 = time.perf_counter()
    _, st = G.optimize_pose_graph(graph, cfg)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    log(f"[kernel] optimize_pose_graph: {st['iterations']} LM iterations, {wall:.1f} ms "
        f"({wall / max(st['iterations'], 1):.3f} ms an iteration), {mod.launches} launches")
    out.update(lm_iterations=st["iterations"], ms_per_lm_iteration=wall / max(st["iterations"], 1),
               launches_timed_solve=mod.launches)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_pcg: CUDA is not available; this check runs only on a GPU", file=sys.stderr)
        return 2
    from lidar_slam_tpu_torch.pipeline.back_end import BackEndConfig

    dev = torch.device("cuda")
    card = device_label(dev)
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    cfg = BackEndConfig().optimizer
    b, graph = cell_graph(dev)
    log(f"[graph] {b.n_nodes} nodes, {b.n_edges} edges, {b.n_priors} priors at capacities "
        f"{b.max_nodes} / {b.max_edges} / {b.max_priors}")
    result = {"device": card, "solve": profile_solve(graph, cfg), "split": scatter_split(b, graph, cfg),
              "map_build": map_build_scatters(dev)}
    if importlib.util.find_spec("lidar_slam_tpu_torch.ops.cuda.pose_pcg") is not None:
        from lidar_slam_tpu_torch.ops.cuda import build, pose_pcg

        info = build.build("pose_pcg")
        log(f"[build] pose_pcg: nvcc {info.seconds:.1f} s")
        for ln in info.log.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"[build]   {ln.strip()}")
        result["kernel"] = kernel_solve(graph, cfg, pose_pcg)
        result["solve_with_kernel"] = profile_solve(graph, cfg)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
