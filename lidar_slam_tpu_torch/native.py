"""ctypes bindings for the native host runtime, runtime/lidar_runtime.cpp
(the port's own copy of lidar_slam_tpu/native.py).

The C++ layer is the host-side counterpart of the reference's ROS/PCL
ingestion runtime: .bin reading, a fused mask + voxel downsample and a
threaded in-order prefetcher of padded frames. The port builds the library
from the source in the repository with g++ at first use, into
build/native/lidar_runtime-<hash>/ at the repository root (git-ignored;
the hash covers the source and the flags, so an edited source is rebuilt
and a stale library never loaded). native_available() is False when it
cannot be built. Nothing on the card's path depends on it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parents[1]
SOURCE = _REPO / "runtime" / "lidar_runtime.cpp"
BUILD_ROOT = _REPO / "build" / "native"
# runtime/CMakeLists.txt's flags but -march=native: the library must load on
# any host that shares the build directory
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LIB = None


def build() -> Path:
    """Compile runtime/lidar_runtime.cpp unless an identical build exists;
    the library's path. Raises RuntimeError without a compiler or on a
    failed compile."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build the native runtime")
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"lidar_runtime-{digest}"
    lib = out_dir / "liblidar_runtime.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"liblidar_runtime.so.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed for {SOURCE} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees no library or the whole one
    return lib


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    lib.lr_voxel_downsample.restype = ctypes.c_int64
    lib.lr_voxel_downsample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
    ]
    lib.lr_read_velodyne_bin.restype = ctypes.c_int64
    lib.lr_read_velodyne_bin.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.lr_prefetcher_create.restype = ctypes.c_void_p
    lib.lr_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.lr_prefetcher_next.restype = ctypes.c_int64
    lib.lr_prefetcher_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)]
    lib.lr_prefetcher_destroy.restype = None
    lib.lr_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def native_available() -> bool:
    """Whether the native runtime builds and loads here."""
    try:
        _load()
        return True
    except (RuntimeError, OSError):
        return False


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def voxel_downsample_native(
    points: np.ndarray,
    leaf: float,
    capacity: int,
    min_range: float = 0.0,
    max_range: float = 1e9,
    weights: bool = False,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Fused finite/range mask + voxel centroid downsample on the host.

    points: [N, >=3] float32 (column 3 is the weight channel if weights=True).
    Returns (out_points [capacity, 3] f32, mask [capacity] bool, n_valid).
    """
    lib = _load()
    pts = np.ascontiguousarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] < 3:
        raise ValueError(f"points must be [N, >=3], got {pts.shape}")
    stride = pts.shape[1]
    out = np.zeros((capacity, 3), np.float32)
    msk = np.zeros(capacity, np.uint8)
    n = lib.lr_voxel_downsample(
        _fp(pts), pts.shape[0], stride, 3 if weights and stride > 3 else -1,
        leaf, min_range, max_range, _fp(out), None,
        msk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), capacity,
    )
    return out, msk.astype(bool), int(n)


def read_velodyne_bin_native(path: str, max_points: int = 200000) -> np.ndarray:
    """A KITTI velodyne .bin scan as [N, 4] float32 (x, y, z, reflectance)."""
    lib = _load()
    buf = np.empty((max_points, 4), np.float32)
    n = lib.lr_read_velodyne_bin(path.encode(), _fp(buf), max_points)
    if n < 0:
        raise IOError(f"cannot read {path}")
    return buf[:n].copy()


class NativePrefetcher:
    """Threaded in-order scan prefetcher: next() yields (points, mask,
    n_valid) per path, then None."""

    def __init__(
        self,
        paths: List[str],
        leaf: float,
        capacity: int,
        min_range: float = 0.0,
        max_range: float = 120.0,
        n_threads: int = 4,
        lookahead: int = 8,
    ):
        lib = _load()
        self._lib = lib
        self.capacity = capacity
        self._paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])  # kept alive
        self._h = lib.lr_prefetcher_create(
            self._paths, len(paths), leaf, min_range, max_range, capacity, n_threads, lookahead
        )
        self.n = len(paths)
        self._emitted = 0

    def next(self) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
        if self._emitted >= self.n or not self._h:
            return None
        pts = np.empty((self.capacity, 3), np.float32)
        msk = np.empty(self.capacity, np.uint8)
        nv = self._lib.lr_prefetcher_next(self._h, _fp(pts), msk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if nv < 0:
            return None
        self._emitted += 1
        return pts, msk.astype(bool), int(nv)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.lr_prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
