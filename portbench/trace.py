"""Reduction of a torch.profiler trace to the device's busy time, the kernel
time by name, and the idle gaps named by the benchmark's host span open when
the device went idle.

Host spans are `torch.profiler.record_function` ranges named
"portbench.<span>", opened by the benchmark around its calls into the
program. Device intervals are the trace's CUDA activities (kernels, copies,
sets), the GPU mirrors of the host spans left out.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

SPAN = "portbench."


class Spans:
    """Host spans as record_function ranges, open only while profiling."""

    def __init__(self):
        self.active = False
        self._open: Dict[str, object] = {}

    def begin(self, name: str):
        if self.active and name not in self._open:
            import torch

            rf = torch.profiler.record_function(SPAN + name)
            rf.__enter__()
            self._open[name] = rf

    def end(self, name: str):
        rf = self._open.pop(name, None)
        if rf is not None:
            rf.__exit__(None, None, None)


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every event of a finished profile."""
    out = []
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    if raw is not None:
        for e in raw:
            start = e.start_ns()
            end = e.end_ns() if hasattr(e, "end_ns") else start + e.duration_ns()
            out.append((e.name(), "CUDA" in str(e.device_type()), start, end))
        return out
    for e in prof.events():  # FunctionEvent: microseconds
        dev = "CUDA" in str(getattr(e, "device_type", ""))
        out.append((e.name, dev, int(e.time_range.start * 1000), int(e.time_range.end * 1000)))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_profile(prof, window_span: str, top: int = 10) -> Optional[Dict]:
    """Busy seconds, window seconds, kernel seconds by name and the longest
    idle gaps inside the host span `window_span`; None if the trace has no
    device activity there."""
    events = _events(prof)
    host = [(n[len(SPAN):], a, b) for n, dev, a, b in events if not dev and n.startswith(SPAN)]
    windows = [(a, b) for n, a, b in host if n == window_span]
    if not windows:
        return None
    w0, w1 = windows[0]
    device = [(n, max(a, w0), min(b, w1)) for n, dev, a, b in events
              if dev and not n.startswith(SPAN) and b > w0 and a < w1]
    if not device:
        return None
    busy = _union([(a, b) for _, a, b in device if b > a])
    busy_ns = sum(b - a for a, b in busy)
    by_name: Dict[str, int] = {}
    for n, a, b in device:
        by_name[n] = by_name.get(n, 0) + (b - a)
    gaps, prev = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    inner = [(n, a, b) for n, a, b in host if n != window_span and a >= w0 and b <= w1]

    def name_of(t: int) -> str:
        open_spans = [(b - a, n) for n, a, b in inner if a <= t < b]
        if open_spans:
            return min(open_spans)[1]
        before = [n for n, a, b in inner if b <= t]
        return "front_end" if not before else "readback" if before[-1] == "chain" else "between"

    gaps.sort(key=lambda g: g[0] - g[1])
    return dict(
        busy_s=busy_ns * 1e-9, window_s=(w1 - w0) * 1e-9,
        kernels=by_name,
        device_ops=[[n, ns * 1e-9] for n, ns in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[name_of(a), (b - a) * 1e-9] for a, b in gaps[:top]],
    )


def matched_seconds(kernels: Dict[str, int], patterns: List[str]) -> float:
    """Seconds of the kernels whose names match any of `patterns` (regular expressions)."""
    rx = [re.compile(p) for p in patterns]
    return sum(ns for name, ns in kernels.items() if any(r.search(name) for r in rx)) * 1e-9


def profile(fn: Callable[[], None], spans: Spans, device_type: str):
    """Run fn under torch.profiler (CPU and, on a card, CUDA activities) with
    the host spans on; returns the finished profile."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device_type == "cuda" else [])
    spans.active = True
    try:
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            if device_type == "cuda":
                torch.cuda.synchronize()
    finally:
        spans.active = False
    return prof
