#!/usr/bin/env python3
"""How often a torch.profiler window misses a kernel launched inside it:
the K2 and K3 one-kernel card tests' windows, counted on one GPU.

    python3 chip_profiler_window.py [--windows 200] [--out FILE]

tests/test_torch_cuda.py::test_knn_wrapper_is_one_kernel_and_no_sync and
::test_sorted_gather_is_one_kernel_and_no_sync each open a torch.profiler
window (CUPTI activity only), call the wrapper 3 times, synchronize and
close it, and want 3 launches of the kernel and nothing else. This script
opens `--windows` such windows on each test's own inputs, in turns over
VARIANTS:

- "as the tests": the tests' window before this change;
- "wait": a WAIT_S host wait after the synchronize, inside the window;
- "flushed": the window closed only after the device has run a marker
  kernel queued behind the calls and the host has read its result.

For each variant it counts the windows whose device events are not 3 of
the kernel, and prints each such window's events against the window's
start (Kineto's trace start) and the host time at which it was closed.
Then it takes the tests' present check `--windows` times: a CUDA graph
that captures the 3 calls (test_torch_cuda._captured_nodes), and counts
the graphs that are not 3 launches of the kernel and nothing else.
Prints the card's name and power limit, then one JSON line (also written
to FILE).
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
VARIANTS = ("as the tests", "wait", "flushed")
WAIT_S = 0.005


def window(calls, kernel, variant):
    """One profiler window over 3 calls: (the kernel's device events
    [(name, start ns, end ns) from the trace start], other device events
    among them, the host time the window closed, ns from the trace start)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            calls()
        torch.cuda.synchronize()
        if variant == "wait":
            time.sleep(WAIT_S)
        elif variant == "flushed":
            torch.ones(1, device="cuda").add_(1).item()
        closed = time.time_ns()
    r = prof.profiler.kineto_results
    t0 = r.trace_start_ns()
    events = [(e.name(), e.start_ns() - t0, e.end_ns() - t0) for e in r.events() if e.device_type().name == "CUDA"]
    ours = [e for e in events if kernel in e[0]]
    # device work of the calls themselves: what starts before the last of the kernel's launches ends (the
    # "flushed" marker runs after them)
    last = max((e[2] for e in ours), default=0)
    others = [e for e in events if kernel not in e[0] and e[1] < last]
    return ours, others, closed - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=200, help="windows a variant and a kernel")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_profiler_window: CUDA is not available; this measurement runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "tests"))
    import test_torch_cuda as T  # the card tests' own inputs

    from lidar_slam_tpu_torch.ops.cuda import knn_fused, ndt_gather
    from lidar_slam_tpu_torch.ops.hashgrid import build_bucket_grid

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[profiler window] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    cloud, q, qm, ring = T._knn_inputs(dev)
    grid = build_bucket_grid(cloud, 5.0, (32, 32, 8))
    m, src, _, _ = T._inputs(dev)
    vids = T._map_vids(m, src, "radius27")
    cases = {"knn_kernel": lambda: knn_fused.window_knn(grid, q, qm, 8, 5.0, ring),
             "ndt_gather": lambda: ndt_gather.gather_stats_sorted(m.keys, m.packed, vids)}
    out = {"card": smi, "torch": torch.__version__, "windows": args.windows, "wait_s": WAIT_S, "results": {}}
    for kernel, calls in cases.items():
        calls()
        torch.cuda.synchronize()
        counts = {v: {"short": 0, "extra": 0, "other": 0} for v in VARIANTS}
        for i in range(args.windows * len(VARIANTS)):
            variant = VARIANTS[i % len(VARIANTS)]
            ours, others, closed = window(calls, kernel, variant)
            c = counts[variant]
            c["short"] += len(ours) < 3
            c["extra"] += len(ours) > 3
            c["other"] += bool(others)
            if len(ours) != 3 or others:
                print(f"[profiler window] {kernel} window {i} ({variant}): {len(ours)} of 3, others {others}; "
                      f"events (ns from the trace start) {ours}; closed at {closed}", flush=True)
        out["results"][kernel] = counts
        print(f"[profiler window] {kernel}: {counts} in {args.windows} windows a variant", flush=True)
        # the card tests' check since: the nodes of a CUDA graph that captures the 3 calls
        graphs = [T._captured_nodes(calls) for _ in range(args.windows)]
        wrong = [g for g in graphs if not T._one_kernel_a_call(g, kernel)]
        out["results"][kernel]["graph"] = {"captures": len(graphs), "not 3 kernels": len(wrong)}
        print(f"[profiler window] {kernel}: {len(wrong)} of {len(graphs)} captured graphs not 3 launches of the "
              f"kernel and nothing else; one graph's nodes {[(t, lab[:120]) for t, lab in graphs[0]]}", flush=True)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
