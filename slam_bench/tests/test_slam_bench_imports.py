"""The import rule: a run of each entry loads no module whose top-level name
is jax, jaxlib, flax or lidar_slam_tpu (compared whole: the program's own
name begins with the JAX package's), and the reference loads nothing of the
program."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ENTRY_RUN = """
import json, sys, torch
torch.set_num_threads(4)
from slam_bench import harness
from slam_bench.tests import small
cfg, mix = small.config(), small.mix()
mix["route"].update(leg_m=12.0)
res, _ = harness.run_cell("ndt_mapping.shuttle", 5, 1.0, False, "cpu", config=cfg, mix=mix)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
import slam_bench.reference.ndt_mapping
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_entry_run_loads_no_jax():
    names = top_level(ENTRY_RUN)
    assert "lidar_slam_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "lidar_slam_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = top_level(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "lidar_slam_tpu", "lidar_slam_tpu_torch"}
