"""Build the package's CUDA sources with nvcc at first use and load them.

Each `csrc/<stem>.cu` has a plain C interface and is compiled into a shared
library loaded with ctypes (no torch headers, so a build takes seconds).
Libraries go under `build/kernels/` at the repository root, in a directory
keyed by a hash of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills per kernel, kept in build.log
)


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # nvcc wall time; 0.0 when the library was already built
    log: str  # nvcc output (ptxas register and spill report)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def build(stem: str) -> BuildInfo:
    """Compile csrc/<stem>.cu into lib<stem>.so unless an identical build exists."""
    src = CSRC / f"{stem}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"{stem}-{digest}"
    lib = out_dir / f"lib{stem}.so"
    log_path = out_dir / "build.log"
    if lib.exists():
        return BuildInfo(lib, 0.0, log_path.read_text() if log_path.exists() else "")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{stem}.so.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True, timeout=900,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src} (exit {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees the old state or the whole library
    return BuildInfo(lib, seconds, log)


def check_tensor(name, a, dtype, dev, shape=None):
    """Raise unless `a` is a contiguous `dtype` tensor on `dev` (of `shape`):
    what a kernel's pointer argument needs."""
    if a.device != dev:
        raise ValueError(f"{name} is on {a.device}, expected {dev}")
    if a.dtype != dtype:
        raise ValueError(f"{name} has dtype {a.dtype}, expected {dtype}")
    if not a.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(a.shape)}, expected {tuple(shape)}")


_LIBS: dict = {}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library for csrc/<stem>.cu, building it first if needed."""
    lib = _LIBS.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build(stem).path))
        _LIBS[stem] = lib
    return lib
