"""The arithmetic of a measured window, shared by the harness and the
metric readers: rates over all of the window, tails over all its frames,
and host spans summed over its frames."""

from __future__ import annotations

import numpy as np


def rate(count: int, seconds: float) -> float:
    """Work completed in the window over the window's length."""
    return count / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile of all values, linearly interpolated between
    the two nearest ranks (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def stage_seconds(spans, name: str, frames) -> float:
    """Seconds of the stage `name` in the frames `frames` (a set)."""
    return sum(b - a for s, a, b, f in spans if s == name and f in frames)


def solve_seconds(solves, frames, by=None) -> float:
    """Seconds of the pose-graph solves started in the frames `frames`,
    those started by `by` alone where it is given."""
    return sum(s["end"] - s["start"] for s in solves if s["frame"] in frames and (by is None or s.get("by") == by))
