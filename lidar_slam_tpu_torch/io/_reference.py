"""Load a numpy-only module of the JAX package by file path.

`lidar_slam_tpu/io/synthetic.py` and `io/trajectory.py` import nothing but
numpy, but importing them as `lidar_slam_tpu.io.*` runs the package
`__init__`s, which import jax. Loading the file directly skips those, so
the port (and the GPU machine, which has no jax) shares the reference's
data generator and metrics without copying them.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_REF_IO = Path(__file__).resolve().parents[2] / "lidar_slam_tpu" / "io"


def load_reference_module(stem: str):
    name = f"lidar_slam_tpu_torch.io._ref_{stem}"
    if name in sys.modules:
        return sys.modules[name]
    path = _REF_IO / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load reference module {path}")
    module = importlib.util.module_from_spec(spec)
    # dataclasses resolve their module through sys.modules while the class
    # body executes, so the module must be registered before it runs
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module
