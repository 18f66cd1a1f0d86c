#!/usr/bin/env python3
"""ndt_newton on one GPU: held to the bit against other checkouts' kernels, timed in turns and split by phase.

    python3 chip_newton.py [--against TREE ...] [--phases 3,4,11,15] [--rounds 3] [--out FILE]

TREE is the root of another checkout of the repository, such as a parent
commit's (`git archive PARENT | tar -x -C .scratch/parent`). Its package is
loaded under another name, and its own `ndt_newton` wrapper builds its own
csrc/ndt_newton.cu into its own build/kernels/, so a kernel is driven through
the interface it was written with. Then it runs chip_smoke.py's phases
(default 3, 4, 11 and 15: K1 against its plain version, timed; ndt_newton at
the tracking, loop and matching shapes, with their checks), with every
ndt_newton call of theirs also run through each other checkout's wrapper on
the same inputs: the results must be equal call by call (torch.equal), else
it exits 1. The phases' own timings include those launches and are not used.
At phase 4's frame 0 (direct7, radius27), the loop shape (phase 11) and the
matching shapes (phase 15, fine and coarse) it times every build in turns,
the others first and this checkout last, then in reverse (the parent, the
change, the change, the parent), `--rounds` times: device ms an alignment
from CUDA events (chip_smoke's device_ms, median of 20 calls a turn), with
each build's median, least and greatest turn; and every build whose wrapper
takes stamps gives its split by phase (chip_smoke's newton_split). Prints
the card's name and power limit, each build's grid and ptxas report, and one
JSON line (also written to FILE).
"""

import argparse
import dataclasses
import importlib
import importlib.util
import inspect
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
PACKAGE = "lidar_slam_tpu_torch"


@dataclasses.dataclass
class Build:
    name: str
    module: object  # the checkout's ops/cuda/ndt_newton module
    log: str  # nvcc's output for its ndt_newton build

    @property
    def stamps(self):
        return "stamps" in inspect.signature(self.module.ndt_newton).parameters

    def grid(self, n_off):
        return self.module.grid(n_off) if hasattr(self.module, "grid") else None


def load_tree(root: Path, alias: str):
    """The ops/cuda/ndt_newton and ops/cuda/build modules of the package in
    the checkout at `root`, imported as the package `alias` (its own modules
    import one another relatively, so none of this checkout's is used)."""
    pkg = root.resolve() / PACKAGE
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.ops.cuda.ndt_newton"), importlib.import_module(f"{alias}.ops.cuda.build")


def ptxas_lines(log):
    return [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", nargs="+", default=[],
                    help="roots of other checkouts whose ndt_newton to hold to the bit and time")
    ap.add_argument("--phases", default="3,4,11,15", help="chip_smoke.py phases to run (of 3, 4, 11, 15)")
    ap.add_argument("--rounds", type=int, default=3, help="rounds of turns (each: the builds, then in reverse)")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        print("chip_newton: CUDA is not available; this measurement runs only on a GPU", file=sys.stderr)
        return 2
    import lidar_slam_tpu_torch
    from lidar_slam_tpu_torch.ops.cuda import build
    from lidar_slam_tpu_torch.ops.cuda import ndt_newton as N

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cs.log(f"[chip_newton] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = lidar_slam_tpu_torch.device("cuda")

    # the other checkouts first, this one last
    trees = [(Path(t).name, *load_tree(Path(t), f"against_{i}")) for i, t in enumerate(args.against)]
    jobs = [(name, bmod, "ndt_newton") for name, _, bmod in trees] + [("checkout", build, "ndt_newton")]
    jobs += [(stem, build, stem) for stem in ("ndt_fused", "knn_fused", "ndt_gather")]  # the phases' other kernels
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        infos = dict(zip([j[0] for j in jobs], pool.map(lambda j: j[1].build(j[2]), jobs)))
    cs.log(f"[build] {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s (parallel)")
    builds = [Build(name, mod, infos[name].log) for name, mod, _ in trees] + [Build("checkout", N, infos["checkout"].log)]
    out = {"card": smi, "builds": [], "shapes": [], "bits": {}}
    for b in builds:
        grids = {n_off: b.grid(n_off) for n_off in (7, 27)}
        out["builds"].append({"name": b.name, "grid": grids, "ptxas": ptxas_lines(b.log)})
        cs.log(f"[build] {b.name}: grid {grids}")
        for ln in ptxas_lines(b.log):
            cs.log(f"[build]   {ln}")

    # every ndt_newton call of the phases, through every other checkout's wrapper
    records = []
    own = N.ndt_newton

    def through_all(*a, **k):
        res = own(*a, **k)
        if k.pop("stamps", None) is None and a[0].device.type == "cuda":
            records.append((res, [b.module.ndt_newton(*a, **k) for b in builds[:-1]]))
        return res

    N.ndt_newton = through_all
    cfg = cs.scan_match_config()
    calls = {}
    if phases & {3, 4}:
        workload = cs.build_workload(dev)
    if 3 in phases:
        for stencil in ("direct7", "radius27"):
            _, ms, plain_ms, *_ = cs.kernel_parity(workload, cfg, stencil)
            out[f"k1_ms_{stencil}"] = ms
            out[f"k1_plain_ms_{stencil}"] = plain_ms
    if 4 in phases:
        for stencil in ("direct7", "radius27"):
            res = cs.newton_parity(workload, cfg, stencil)
            calls[f"{stencil} frame 0"] = res["call"]
    if 11 in phases:
        loop = cs.loop_drive(dev, str(HERE / "build" / "chip_newton" / "loop"), smi)
        calls["loop"] = loop["call"]
    if 15 in phases:
        matching = cs.matching_phase(dev, smi)
        calls["matching fine"], calls["matching coarse"] = matching["call"], matching["coarse_call"]
    N.ndt_newton = own
    shutil.rmtree(HERE / "build" / "chip_newton", ignore_errors=True)

    bad = {b.name: 0 for b in builds[:-1]}
    for res, other in records:
        for b, o in zip(builds, other):
            if not torch.equal(res, o):
                if bad[b.name] < 3:
                    d = (res - o).abs().max().item()
                    cs.log(f"[bits] {b.name} differs from the checkout's build: max |diff| {d:.3e}, iterations "
                           f"{res[N.ITERATIONS].item()} / {o[N.ITERATIONS].item()}")
                bad[b.name] += 1
    out["bits"] = {"alignments": len(records), "unequal": bad}
    cs.log(f"[bits] {len(records)} alignments of phases {sorted(phases)} through {len(builds)} builds: unequal "
           f"{bad} ({smi})")

    order = (builds + builds[::-1]) * args.rounds
    for shape, (a, kw) in calls.items():
        iterations = int(own(*a, **kw)[N.ITERATIONS].item())
        turns = {b.name: [] for b in builds}
        for b in order:
            turns[b.name].append(cs.device_ms(lambda b=b: b.module.ndt_newton(*a, **kw), reps=20))
        entry = {"shape": shape, "points": int(a[1].sum().item()), "iterations": iterations, "ms": turns,
                 "ms_median": {k: float(np.median(v)) for k, v in turns.items()}, "split_us": {}}
        for b in builds:
            if b.stamps:
                entry["split_us"][b.name] = cs.newton_split(
                    lambda stamps, b=b: b.module.ndt_newton(*a, **kw, stamps=stamps), kw["max_iter"], dev)
        out["shapes"].append(entry)
        text = ", ".join(f"{k} {np.median(v):.4f} [{min(v):.4f}-{max(v):.4f}]" for k, v in turns.items())
        cs.log(f"[time] {shape}: {entry['points']} points, {iterations} iterations; ms an alignment, median "
               f"[least-greatest] of {2 * args.rounds} turns: {text} ({smi})")
        for name, sp in entry["split_us"].items():
            cs.log(f"[split] {shape} {name}, us an evaluation ({sp['evaluations']} evaluations, tick "
                   f"{sp['tick_ns']} ns): {cs.split_text(sp)}")
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    cs.log(smi)
    return 1 if any(bad.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
