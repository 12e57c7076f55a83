"""Timing on the card and the reading of a profiler trace.

``median_ms`` is a copy of ``chip_smoke.py``'s helper. ``Trace`` reads ``torch.profiler``'s Chrome trace into plain
intervals: what ran on the device (kernels, copies, sets), the host's
torch ops and the benchmark's own spans, on one clock. ``union``,
``covered`` and ``gaps`` are the interval arithmetic that the busy and
idle shares need: a union, not a sum, so that two operations at once
count once.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import statistics
import tempfile
import threading
import time

# activity types on the device that are work, not annotations
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def median_ms(fn, iters: int = 100, repeats: int = 7) -> float:
    """Median over ``repeats`` CUDA-event timings of ``iters`` calls
    back to back: the time per call on the card's clock, which is the
    host's time wherever the host is the slower of the two."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


# -- interval arithmetic ------------------------------------------------------

def union(intervals) -> list[tuple[float, float]]:
    """Merge ``(start, end)`` intervals into disjoint sorted ones."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(merged, lo: float, hi: float, starts=None) -> float:
    """Length of ``[lo, hi]`` that the disjoint sorted ``merged``
    intervals cover (``starts``: their starts, to reuse)."""
    if hi <= lo or not merged:
        return 0.0
    if starts is None:
        starts = [a for a, _ in merged]
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    total = 0.0
    for a, b in merged[i:]:
        if a >= hi:
            break
        total += max(0.0, min(b, hi) - max(a, lo))
    return total


def gaps(merged, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of ``[lo, hi]`` that ``merged`` leaves uncovered."""
    out, at = [], lo
    for a, b in merged:
        if b <= lo:
            continue
        if a >= hi:
            break
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out


# -- the profiler's trace ------------------------------------------------------

@dataclasses.dataclass
class Interval:
    name: str
    start: float            # seconds from the trace's first event
    end: float
    thread: object = 0      # the host thread, or the device stream
    kind: str = ""          # the profiler's activity (``cat``)

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Trace:
    """What one profiled window held: ``device`` work, the benchmark's
    ``spans`` (``torch.profiler.record_function``) and the host's
    ``ops``, each sorted by start."""
    device: list[Interval]
    spans: list[Interval]
    ops: list[Interval]
    clock_gap_s: float | None = None    # see ``clock_gap``

    def spans_named(self, name: str) -> list[Interval]:
        return [s for s in self.spans if s.name == name]

    def device_union(self):
        return union((d.start, d.end) for d in self.device)

    @classmethod
    def from_chrome(cls, events, span_names) -> "Trace":
        """From the ``traceEvents`` of ``torch.profiler``'s Chrome trace
        (``ts`` and ``dur`` in microseconds, ``cat`` the activity)."""
        device, spans, ops = [], [], []
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
        base = min((float(e["ts"]) for e in xs), default=0.0)
        for e in xs:
            kind, name = e.get("cat", ""), e.get("name", "")
            start = (float(e["ts"]) - base) * 1e-6
            iv = Interval(name, start, start + float(e.get("dur", 0)) * 1e-6,
                          e.get("tid", 0), kind)
            if kind in DEVICE_WORK:
                device.append(iv)
            elif kind == "user_annotation" and name in span_names:
                spans.append(iv)
            elif kind == "cpu_op":
                ops.append(iv)
        for lst in (device, spans, ops):
            lst.sort(key=lambda i: i.start)
        return cls(device, spans, ops)


def clock_gap(marks, own, shift: float) -> float | None:
    """The widest distance between a span's mark in the trace and its
    host-timed copy moved by ``shift``, over the names whose every span
    both recorded (the k-th mark against the k-th copy)."""
    gaps = []
    for name in {m.name for m in marks}:
        a = [m for m in marks if m.name == name]
        b = [o for o in own if o.name == name]
        if len(a) == len(b):
            gaps += [abs(x.start - y.start - shift) for x, y in zip(a, b)]
    return max(gaps, default=None)


class Tracer:
    """The benchmark's spans and, when on, ``torch.profiler`` over the
    window. Off, :meth:`span` costs nothing. On, each span is timed on
    the host's clock in whatever thread it opens and also marked for the
    profiler, which records the marks of the thread that started it
    only. Those marks are on the device's clock and are kept; spans of a
    name that the trace has no mark of (those of another thread) are
    the host-timed ones, moved onto the trace's clock by the window's
    span, which both recorded. The two clocks drift apart over a window
    by some milliseconds (``Trace.clock_gap_s``), more than a short span
    lasts, so a host-timed span is never preferred to a mark."""

    def __init__(self, on: bool):
        self.on = on
        self._prof = None
        self.names: set[str] = set()
        self._own: list[Interval] = []

    @contextlib.contextmanager
    def span(self, name: str):
        if self._prof is None:
            yield
            return
        import torch
        self.names.add(name)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self._own.append(Interval(name, t0, time.perf_counter(),
                                      threading.get_native_id()))

    def start(self) -> None:
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        self._own = []
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self, window: str) -> Trace | None:
        """End the profile; ``window`` names the span that both clocks
        recorded, on the profiler's thread."""
        if self._prof is None:
            return None
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        # the trace goes through a file in TMPDIR, deleted once read
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        tr = Trace.from_chrome(events, self.names)
        marked = tr.spans_named(window)
        own = [s for s in self._own if s.name == window]
        if not marked or not own:
            raise RuntimeError(f"the window's span {window!r} is missing "
                               f"from the trace")
        shift = marked[0].start - own[0].start
        tr.clock_gap_s = clock_gap(tr.spans, self._own, shift)
        have = {s.name for s in tr.spans}
        tr.spans = sorted(tr.spans + [
            Interval(s.name, s.start + shift, s.end + shift, s.thread)
            for s in self._own if s.name not in have], key=lambda i: i.start)
        return tr
