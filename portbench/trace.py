"""The traced span of a run: torch.profiler's raw events, kept as plain
tuples in memory (no Chrome trace is written), and the arithmetic that the
per-layer readers and the result's `breakdown` share.

One `Span` covers a bounded stretch inside the measured window (a few
units of work after the first). Its device events are every kernel, copy
and set on the card; its host events are the ops of the thread that
launched the most of them. The arithmetic of busy time, idle gaps and
copies hidden under kernels is copied from the port's smoke script's
`device_profile` and `stream_overlaps`, which read the same raw events.

A trace taken late in a long process has been seen to lose kernel records,
so every run traces in a fresh process, and `Span.kernel_count` lets a
reader check the profiled kernels against the program's launch counters.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

#: The annotation that bounds the traced span on the profiler's own clock.
SPAN_NAME = "portbench.span"


@dataclass
class Span:
    """What one traced stretch of the window recorded."""

    device: list = field(default_factory=list)  # (name, stream id, start ns, end ns)
    host: list = field(default_factory=list)  # (name, start ns, end ns), main thread only
    start_ns: int = 0
    end_ns: int = 0
    units: int = 0  # units of work (chunks, pairs) inside the span
    counters: dict = field(default_factory=dict)  # program counters: their change over the span
    extra: dict = field(default_factory=dict)  # what the cell's driver module knows of the span's work
    wall_s: float = 0.0

    @property
    def window_ns(self) -> int:
        return max(self.end_ns - self.start_ns, 0)

    def kernels(self):
        """Device events that are kernels (not copies or sets)."""
        return [e for e in self.device if not _is_copy(e[0]) and not e[0].startswith("Memset")]

    def kernel_count(self, patterns=None) -> int:
        return len(self.matching(patterns)) if patterns else len(self.kernels())

    def matching(self, patterns):
        """Kernels whose name holds one of `patterns`."""
        return [e for e in self.kernels() if any(p in e[0] for p in patterns)]


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy")


@contextlib.contextmanager
def capture(span: Span):
    """Profile the body (CPU and CUDA activities) into `span`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    sync()
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        with record_function(SPAN_NAME):
            yield span
            sync()
    span.wall_s = time.perf_counter() - t0
    host_by_tid = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.name() == SPAN_NAME:
            continue  # the annotation's mirror on the device's timeline, not device work
        if e.device_type() == DeviceType.CUDA:
            span.device.append((e.name(), e.device_resource_id(), e.start_ns(), e.end_ns()))
        elif e.name() == SPAN_NAME:
            span.start_ns, span.end_ns = e.start_ns(), e.end_ns()
        else:
            host_by_tid.setdefault(e.start_thread_id(), []).append((e.name(), e.start_ns(), e.end_ns()))
    # the launching thread: the one that made the most runtime calls
    if host_by_tid:
        main = max(host_by_tid, key=lambda t: sum(n.startswith("cuda") for n, _, _ in host_by_tid[t]))
        span.host = host_by_tid[main]
    if not span.end_ns and span.device:
        span.start_ns = min(e[2] for e in span.device)
        span.end_ns = max(e[3] for e in span.device)


def union(intervals, lo: int, hi: int):
    """The union of `intervals` ((start, end) pairs) clipped to [lo, hi), as
    sorted disjoint pairs."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_ns(span: Span) -> int:
    """Nanoseconds of the span in which some operation ran on the device."""
    return sum(b - a for a, b in union([(e[2], e[3]) for e in span.device], span.start_ns, span.end_ns))


def idle_share(span: Span):
    """1 - busy / span, or None where the span saw no device work."""
    busy = busy_ns(span)
    if not busy or not span.window_ns:
        return None
    return 1.0 - busy / span.window_ns


def covered(c0: int, c1: int, spans) -> int:
    """The length of [c0, c1) covered by the union of `spans`."""
    return sum(b - a for a, b in union(spans, c0, c1))


def copy_hidden(span: Span):
    """(copy ns, copy ns under a kernel) of the copies on side streams, the
    streams on which no kernel runs; copies on a kernel's stream wait for
    its kernels by their nature and are left out."""
    kernel_streams = {}
    for name, sid, a, b in span.kernels():
        kernel_streams.setdefault(sid, []).append((a, b))
    total = under = 0
    for name, sid, a, b in span.device:
        if not _is_copy(name) or sid in kernel_streams:
            continue
        total += b - a
        under += covered(a, b, [k for s, ks in kernel_streams.items() if s != sid for k in ks])
    return total, under


def idle_gaps(span: Span):
    """The device's idle gaps inside the span, each named by the innermost
    host op that ran over its midpoint: {name: ns}."""
    busy = union([(e[2], e[3]) for e in span.device], span.start_ns, span.end_ns)
    gaps, prev = [], span.start_ns
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if span.end_ns > prev:
        gaps.append((prev, span.end_ns))
    events = sorted(span.host, key=lambda e: (e[1], -e[2]))
    stack, i, out = [], 0, {}
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) // 2
        while i < len(events) and events[i][1] <= mid:
            stack.append(events[i])
            i += 1
        # host ops of one thread nest: the innermost open one is on top
        # once those that ended before the midpoint are dropped
        live = [e for e in stack if e[2] >= mid]
        stack = live
        name = stack[-1][0] if stack else "(no host op)"
        out[name] = out.get(name, 0) + (g1 - g0)
    return out


def device_ops(span: Span):
    """{device op name: ns} over the span."""
    out = {}
    for name, _, a, b in span.device:
        out[name] = out.get(name, 0) + (b - a)
    return out


def _top(d: dict, n: int = 10, width: int = 120):
    return [[k[:width], v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(span: Span) -> dict:
    """The result line's `breakdown`: the device ops that took the most
    time and the longest idle gaps by host op, seconds each, ten of each."""
    return {"device_ops": _top(device_ops(span)), "idle_gaps": _top(idle_gaps(span))}
