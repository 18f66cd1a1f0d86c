"""Run-health watchdog for long mapping/localization sessions (SURVEY §5.3),
and the run's one tracer.

The reference has NO failure detection: its ROS nodes poll empty buffers
forever when an upstream stage dies, and its only runtime health signal is
the A-LOAM >100 ms budget warning (scanRegistration.cpp:454-455,
laserOdometry.cpp:595-597). This watchdog supersedes that with an explicit
health surface for the in-process pipeline:

- per-stage deadline warnings (the 100 ms budget, configurable per stage);
- a divergence alarm — pose jumps beyond a per-frame translation bound are
  how NDT/ICP failures actually present;
- anomaly counters (deadline misses, divergences, fused-kernel fallbacks)
  and a heartbeat timestamp a supervisor thread/process can poll;
- a run summary for the end-of-session report.

The port's own copy of lidar_slam_tpu/utils/watchdog.py, extended into the
run's tracer. A stage is the budgeted top-level span; `span` opens any
other, and `count` adds to the innermost span open on the calling thread
and to the run's totals. The module's `span` and `count` reach the run that
`RunHealth.begin` made active from any layer, with no handle passed down;
with no active run they do nothing. The last run stays reachable through
`last_run()` after it ends, until the next one begins.

Spans are host time on `time.perf_counter_ns`. A run takes one anchor
pair (perf_counter_ns, time_ns) when it begins; torch.profiler's event
times are epoch ns (time_ns's clock), so `epoch_ns` puts a span on a
device trace's clock. The heartbeat and `stalled` stay on wall time.

A span's time is host wall. On the card that covers the span's device work
up to its last host read (an NDT alignment ends in one copy of its result;
a pose-graph solve reads the host once an iteration); work a span only
issues is counted by the next span that waits on the card. A span opened
with `device=` a CUDA device also records a pair of CUDA events; pairs are
resolved with `query()` when a later top-level span closes, so the card's
time between them costs no synchronisation (the run's `end` waits for the
last pairs, after the frame loop). Nothing here touches device data or
reads the host.
"""

from __future__ import annotations

import collections
import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

# spans kept in the ring; a benchmark run (lap 1, the window and the traced
# tail, ~1 400 frames) keeps ~13 000
RING_SPANS = 1 << 17


@dataclass
class StageHealth:
    budget_ms: float
    calls: int = 0
    misses: int = 0
    total_ms: float = 0.0
    worst_ms: float = 0.0


@dataclass
class SpanTotals:
    """One span name's totals over the whole run, host ns; `device_ns` and
    `device_calls` over its resolved device-timed calls."""

    calls: int = 0
    total_ns: int = 0
    worst_ns: int = 0
    device_ns: int = 0
    device_calls: int = 0


class Span:
    """One timed interval of a run: `name`, host `start` and `end`
    (perf_counter ns), the CLI frame index it belongs to (`frame`: given,
    or its parent's; None outside the frame loop), the span open on its
    thread when it began (`parent`), the thread's ident, the counts added
    while it was the thread's innermost span (`counts`, None for none) and,
    when device-timed, the card's ns between its CUDA events (`device_ns`,
    None until resolved). A context manager: entering opens it."""

    __slots__ = ("name", "start", "end", "frame", "parent", "thread", "counts", "device_ns", "_run", "_events")

    def __init__(self, run: "RunHealth", name: str, frame: Optional[int], events):
        self.name, self.frame, self._run, self._events = name, frame, run, events
        self.start = self.end = None
        self.parent = self.counts = self.device_ns = self.thread = None

    def __enter__(self) -> "Span":
        stack = self._run._stack()
        self.thread = threading.get_ident()
        if stack:
            self.parent = stack[-1]
            if self.frame is None:
                self.frame = self.parent.frame
        stack.append(self)
        if self._events is not None:
            self._events[0].record(self._events[2])
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record(self._events[2])
        self._run._close(self)
        return False

    @property
    def ms(self) -> float:
        return (self.end - self.start) * 1e-6


@dataclass
class RunHealth:
    """Health surface and tracer for one pipeline run."""

    stage_budget_ms: float = 100.0  # the reference's real-time warn budget
    max_step_translation: float = 5.0  # per-frame pose jump alarm [m]
    stall_timeout_s: float = 60.0
    log: Optional[callable] = None  # warning sink (default: print to stderr)

    stages: Dict[str, StageHealth] = field(default_factory=dict)
    divergences: int = 0
    frames: int = 0
    last_heartbeat: float = field(default_factory=time.time)
    span_totals: Dict[str, SpanTotals] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)
    anchor: Optional[tuple] = None  # (perf_counter_ns, time_ns) of one instant, taken by begin()
    _last_position: Optional[np.ndarray] = None
    _ring: collections.deque = field(default_factory=lambda: collections.deque(maxlen=RING_SPANS), repr=False,
                                     compare=False)
    _local: threading.local = field(default_factory=threading.local, repr=False, compare=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)
    _pending: list = field(default_factory=list, repr=False, compare=False)

    def _warn(self, msg: str) -> None:
        if self.log is not None:
            self.log(msg)
        else:
            import sys

            print(f"[watchdog] {msg}", file=sys.stderr, flush=True)

    # -- the run ------------------------------------------------------------
    def begin(self) -> "RunHealth":
        """Make this the active run (the one the module's `span` and
        `count` reach) and the last run, and take the clock anchor."""
        global _active, _last
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        p1 = time.perf_counter_ns()
        self.anchor = ((p0 + p1) // 2, wall)
        _active = _last = self
        return self

    def end(self) -> None:
        """Resolve the device-timed spans still pending (waiting for their
        last events: the frame loop is over) and stop being the active run;
        `last_run()` keeps returning this run until another begins."""
        global _active
        self._resolve(wait=True)
        if _active is self:
            _active = None

    @contextmanager
    def active(self):
        """begin() ... end(), also when the body raises."""
        self.begin()
        try:
            yield self
        finally:
            self.end()

    def epoch_ns(self, t_ns: int) -> int:
        """A perf_counter ns time of this run on the epoch clock (time_ns,
        torch.profiler's event clock)."""
        return t_ns - self.anchor[0] + self.anchor[1]

    # -- spans and counters ---------------------------------------------------
    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, frame: Optional[int] = None, device=None) -> Span:
        """A span to open with `with`. `device`: a torch.device; a CUDA one
        also times the span on the card's timeline (CUDA events on its
        current stream)."""
        events = None
        if getattr(device, "type", None) == "cuda":
            import torch

            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True),
                      torch.cuda.current_stream(device))
        return Span(self, name, frame, events)

    def _close(self, sp: Span) -> None:
        self._stack().pop()  # spans close in the order `with` nests them
        ns = sp.end - sp.start
        with self._lock:
            self._ring.append(sp)
            tot = self.span_totals.get(sp.name)
            if tot is None:
                tot = self.span_totals[sp.name] = SpanTotals()
            tot.calls += 1
            tot.total_ns += ns
            tot.worst_ns = max(tot.worst_ns, ns)
            if sp._events is not None:
                self._pending.append(sp)
        if sp.parent is None and self._pending:
            self._resolve(wait=False)

    def _resolve(self, wait: bool) -> None:
        """Put the card's time on each pending device-timed span whose end
        event has run (`wait`: wait for each)."""
        with self._lock:
            pending, self._pending = self._pending, []
        left = []
        for sp in pending:
            a, b, _ = sp._events
            if wait:
                b.synchronize()
            elif not b.query():
                left.append(sp)
                continue
            sp.device_ns = int(a.elapsed_time(b) * 1e6)
            sp._events = None
            with self._lock:
                tot = self.span_totals[sp.name]
                tot.device_ns += sp.device_ns
                tot.device_calls += 1
        if left:
            with self._lock:
                self._pending[:0] = left

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to the counter `name` of the thread's innermost open span
        and of the run."""
        stack = self._stack()
        with self._lock:
            if stack:
                top = stack[-1]
                if top.counts is None:
                    top.counts = {}
                top.counts[name] = top.counts.get(name, 0) + n
            self.counters[name] = self.counters.get(name, 0) + n

    def spans(self) -> list:
        """The spans in the ring, oldest first (closing order)."""
        with self._lock:
            return list(self._ring)

    # -- health -------------------------------------------------------------
    @contextmanager
    def stage(self, name: str, budget_ms: Optional[float] = None):
        """Time one pipeline stage; warn when it blows its budget — the
        in-process form of the reference's 'scan registration process over 100ms'.
        A stage whose body raises is recorded too."""
        st = self.stages.setdefault(
            name, StageHealth(budget_ms=budget_ms or self.stage_budget_ms)
        )
        sp = self.span(name)
        try:
            with sp:
                yield
        finally:
            ms = sp.ms
            st.calls += 1
            st.total_ms += ms
            st.worst_ms = max(st.worst_ms, ms)
            if ms > st.budget_ms:
                st.misses += 1
                self._warn(f"{name} took {ms:.1f} ms (budget {st.budget_ms:.0f} ms)")

    def frame(self, pose) -> bool:
        """Record a tracked frame; returns False when the pose step trips the
        divergence alarm (caller decides whether to gate/reset)."""
        self.frames += 1
        self.last_heartbeat = time.time()
        p = np.asarray(pose, np.float32)[:3, 3]
        ok = True
        if self._last_position is not None:
            step = float(np.linalg.norm(p - self._last_position))
            if step > self.max_step_translation or not np.isfinite(step):
                self.divergences += 1
                ok = False
                self._warn(
                    f"pose jumped {step:.2f} m in one frame "
                    f"(> {self.max_step_translation:.1f} m) — tracking divergence?"
                )
        self._last_position = p
        return ok

    def stalled(self, now: Optional[float] = None) -> bool:
        """True when no frame has been recorded within stall_timeout_s —
        pollable from a supervisor thread (the reference's dead-node case)."""
        return ((now or time.time()) - self.last_heartbeat) > self.stall_timeout_s

    def summary(self) -> dict:
        spans = {}
        with self._lock:
            for k, v in self.span_totals.items():
                spans[k] = {"calls": v.calls, "mean_ms": round(v.total_ns * 1e-6 / max(v.calls, 1), 3),
                            "worst_ms": round(v.worst_ns * 1e-6, 3)}
                if v.device_calls:
                    spans[k]["device_mean_ms"] = round(v.device_ns * 1e-6 / v.device_calls, 3)
            counters = dict(self.counters)
        return {
            "frames": self.frames,
            "divergences": self.divergences,
            "stages": {
                k: {
                    "calls": v.calls,
                    "mean_ms": round(v.total_ms / max(v.calls, 1), 2),
                    "worst_ms": round(v.worst_ms, 2),
                    "budget_ms": v.budget_ms,
                    "misses": v.misses,
                }
                for k, v in self.stages.items()
            },
            "spans": spans,
            "counters": counters,
        }


_active: Optional[RunHealth] = None  # the run the module's span and count reach
_last: Optional[RunHealth] = None  # the run begun last, kept after it ends
_NO_SPAN = nullcontext()


def span(name: str, frame: Optional[int] = None, device=None):
    """A span of the active run (RunHealth.span), or a context that does
    nothing when no run is active."""
    run = _active
    return _NO_SPAN if run is None else run.span(name, frame, device)


def count(name: str, n: int = 1) -> None:
    """RunHealth.count on the active run; nothing when no run is active."""
    run = _active
    if run is not None:
        run.count(name, n)


def active_run() -> Optional[RunHealth]:
    return _active


def last_run() -> Optional[RunHealth]:
    """The run begun last, active or ended; None before any."""
    return _last
