"""The readings that the limits of `correct` are set from, on the card:

    python3 -m slam_bench.control --workload ndt_mapping.shuttle --seeds 1,2 --seconds 51

For each seed, one run of the cell at its own size, then the judge over the
window's frames for the program (the lower readings) and, over the same
frames, for each stand-in that the reference puts in the program's place
(reference VARIANTS: the control in bfloat16 and the planted faults; the
upper readings), each decided by the harness's own rule. One line
`CONTROL {...}` a seed on standard output. The benchmark's own runs never
run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from slam_bench import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="slam_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--variants", default="control,unchanged,sparse")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("slam_bench.control: needs a CUDA card", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        result, checks = harness.run_cell(args.workload, seed, args.seconds, False, "cuda",
                                          variants=tuple(args.variants.split(",")))
        print("CONTROL " + json.dumps({"seed": seed, "correct": result["correct"], "variants": result["variants"],
                                       "checks": checks, "metrics": result["metrics"],
                                       "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
