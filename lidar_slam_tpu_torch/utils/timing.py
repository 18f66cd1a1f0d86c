"""Timing and profiling instrumentation (port of
lidar_slam_tpu/utils/timing.py).

Replaces the reference's three TicToc copies and ad-hoc chrono printfs
(include/.../tools/tic_toc.hpp, A-LOAM tic_toc.h, loop_closing/tictoc.h;
front_end.cpp:224-231) with one utility that understands asynchronous
CUDA work (`block_on` synchronises the devices of the given tensors before
the clock stops) and exposes `torch.profiler` traces.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict

import torch


def _synchronize(block_on) -> None:
    """Wait for the CUDA devices of every tensor in `block_on` (a tensor, or
    lists, tuples and dicts of them)."""
    stack, devices = [block_on], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for dev in devices:
        torch.cuda.synchronize(dev)


class TicToc:
    """Reference-compatible stopwatch; `toc()` returns milliseconds."""

    def __init__(self):
        self.tic()

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self, block_on=None) -> float:
        if block_on is not None:
            _synchronize(block_on)
        return (time.perf_counter() - self._t0) * 1000.0


class StageTimer:
    """Accumulating per-stage wall-clock statistics for pipeline loops."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_ms": 1000.0 * self.totals[k] / max(self.counts[k], 1),
            }
            for k in self.totals
        }

    def report(self) -> str:
        lines = []
        for k, v in sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{k:30s} {v['mean_ms']:8.2f} ms/call x{v['count']}")
        return "\n".join(lines)


def trace_annotation(name: str):
    """Named region visible in torch.profiler traces."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Profile the block with torch.profiler (the CPU, and the CUDA devices
    where there are any) and write a Chrome trace (chrome://tracing,
    Perfetto) into `log_dir` as trace_*.json. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="trace_", suffix=".json", dir=log_dir)
    os.close(fd)
    prof.export_chrome_trace(path)
