"""Spans from the benchmark's own wrappers, and the reading of a profiler
trace: the device's busy intervals, its idle share over a window, its time
by kernel name, and the idle gaps labelled by the span the host was in.

The idle arithmetic and the by-kernel sums are the yardstick's copy of
`covomix_tpu_torch/util/profiling.py` (`idle_share`,
`device_time_by_kernel`)."""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Callable, Optional

import torch

WINDOW = "perfbench.window"


@dataclasses.dataclass
class Span:
    name: str
    start: float        # host clock, s
    end: float
    depth: int
    call: int           # index of the entry call it lies in (-1: outside)


class Spans:
    """Records named spans around calls into the program's layers. With
    `sync`, each span starts and ends with a device synchronize, so its
    length is the layer's work; each span is also a profiler range."""

    def __init__(self, sync: Callable[[], None]):
        self.sync, self.spans, self.depth, self.call = sync, [], 0, -1

    @contextlib.contextmanager
    def span(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        self.depth += 1
        try:
            with torch.profiler.record_function(name):
                yield
                self.sync()
        finally:
            self.depth -= 1
            self.spans.append(Span(name, t0, time.perf_counter(), self.depth, self.call))

    def wrap(self, fn, name: str):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped


def self_times(spans, name: str) -> list:
    """Per call, the span `name`'s length minus what the spans directly
    inside it cover."""
    out = []
    for s in spans:
        if s.name != name:
            continue
        inner = sum(c.end - c.start for c in spans
                    if c.depth == s.depth + 1 and c.start >= s.start and c.end <= s.end)
        out.append(s.end - s.start - inner)
    return out


def idle_share(intervals, window) -> float:
    """1 - |union of `intervals` [(start, end)] clipped to `window`| / the
    window's length."""
    lo, hi = window
    busy, cur_lo, cur_hi = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_hi is None or s > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = s, e
        else:
            cur_hi = max(cur_hi, e)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    return 1.0 - busy / (hi - lo)


def _merged(intervals, window):
    lo, hi = window
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class TraceView:
    """What the readers take from a finished trace (times in ns)."""
    window: tuple
    device: list                  # (start, end, name) of each device operation
    host_ranges: list             # (start, end, name) of the benchmark's spans

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def idle(self) -> float:
        return idle_share([(s, e) for s, e, _ in self.device], self.window)

    @property
    def busy_s(self) -> float:
        return (1.0 - self.idle) * self.window_s

    def kernel_time_s(self, match: Callable[[str], bool]) -> tuple:
        """(launches, device seconds) of the operations whose name matches."""
        n, t = 0, 0
        lo, hi = self.window
        for s, e, name in self.device:
            if match(name) and s >= lo and e <= hi:
                n += 1
                t += e - s
        return n, t / 1e9

    def by_kernel(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations taking most time."""
        out = {}
        for s, e, name in self.device:
            out[name] = out.get(name, 0) + (e - s)
        return [[k[:200], v / 1e9] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[span, seconds]]: the device's idle time in the window, summed by
        the innermost benchmark span the host was in at each gap's middle."""
        busy = _merged([(s, e) for s, e, _ in self.device], self.window)
        edges = [self.window[0]] + [x for iv in busy for x in iv] + [self.window[1]]
        sums = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            inside = [r for r in self.host_ranges if r[0] <= mid <= r[1] and r[2] != WINDOW]
            label = max(inside, key=lambda r: r[0])[2] if inside else "outside_spans"
            sums[label] = sums.get(label, 0) + (b - a)
        return [[k, v / 1e9] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def read_trace(prof, window_name: str = WINDOW) -> Optional[TraceView]:
    """The TraceView of a finished torch.profiler run over the range named
    `window_name`; None where the trace holds no device operation."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU:
            if not e.is_user_annotation():
                device.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.is_user_annotation():
            host.append((e.start_ns(), e.end_ns(), e.name()))
    windows = [(s, e) for s, e, n in host if n == window_name]
    if not device or not windows:
        return None
    return TraceView(min(windows), device, host)
