"""What the profiler's trace of a window says: the device's operations, the
time the device was busy, and the idle gaps with what the host was doing.

The trace is torch.profiler's raw result over the window (CUDA activity
only: kernels, copies and fills). Its event times are wall-clock ns; the
harness's spans are perf_counter seconds, joined by the offset taken when
the window opened.
"""

from __future__ import annotations


def device_events(trace) -> list:
    """(name, start ns, end ns) of every operation that ran on the device."""
    from torch.autograd import DeviceType

    out = []
    for e in trace.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    out.sort(key=lambda x: x[1])
    return out


def union(events) -> list:
    """The busy intervals [(start, end)] of events sorted by start."""
    merged = []
    for _, a, b in events:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_ns(events) -> int:
    return sum(b - a for a, b in union(events))


def top_ops(events, n: int = 10) -> list:
    """The device operations that took the most time, [[name, seconds]]."""
    by = {}
    for name, a, b in events:
        by[name] = by.get(name, 0) + (b - a)
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events, window_ns: tuple, host_spans: list, n: int = 10) -> list:
    """The longest idle gaps of the device in the window, each named by the
    host span that covers its middle ("other" for none): [[name, seconds]].
    `host_spans` are (name, start ns, end ns) on the trace's clock."""
    t0, t1 = window_ns
    gaps, last = [], t0
    for a, b in union(events):
        if a > last:
            gaps.append((last, min(a, t1)))
        last = max(last, b)
    if last < t1:
        gaps.append((last, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:n]:
        mid = (a + b) // 2
        name = next((s for s, x, y in host_spans if x <= mid <= y), "other")
        out.append([name, (b - a) / 1e9])
    return out
