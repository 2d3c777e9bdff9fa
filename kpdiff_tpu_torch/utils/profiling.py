"""Tracing and timing helpers (kpdiff_tpu/utils/profiling.py).

  * `PhaseTimer`: named spans, accumulated and queryable (the sample CLI's
    sample_time bookkeeping). A span given a CUDA tensor (or a list, tuple
    or dict holding one) as `sync` is timed on that device with CUDA events,
    recorded on the current stream, so that it counts the device work the
    span queued; any other span on the host clock. `report()` says which
    clock each name used.
  * `device_trace`: torch.profiler over CPU and CUDA activities, written as
    a Chrome trace to a directory (one file per trace).

The JAX package's `block` (a completion barrier for its remote TPU
backend) has no counterpart: a CUDA event's `synchronize()` waits for the
device here.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

import torch


def _cuda_device(obj) -> Optional[torch.device]:
    """The CUDA device of a tensor or of the first CUDA tensor in a (nested)
    list, tuple or dict of them; None when there is none."""
    if torch.is_tensor(obj):
        return obj.device if obj.device.type == "cuda" else None
    items = obj.values() if isinstance(obj, dict) else obj if isinstance(obj, (list, tuple)) else ()
    return next((d for d in map(_cuda_device, items) if d is not None), None)


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.clocks: Dict[str, str] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        dev = _cuda_device(sync)
        if dev is None:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._add(name, time.perf_counter() - t0, "host")
            return
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        stream = torch.cuda.current_stream(dev)
        start.record(stream)
        try:
            yield
        finally:
            end.record(stream)
            end.synchronize()
            self._add(name, start.elapsed_time(end) / 1e3, "cuda_events")

    def _add(self, name, seconds, clock):
        self.totals[name] += seconds
        self.counts[name] += 1
        self.clocks[name] = clock

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k], "mean_s": self.totals[k] / self.counts[k],
                    "clock": self.clocks[k]} for k in self.totals}

    def __str__(self):
        return " | ".join(f"{k}: {v['total_s']:.2f}s/{v['count']}" for k, v in self.report().items())


@contextlib.contextmanager
def device_trace(log_dir: str, cuda: Optional[bool] = None):
    """torch.profiler over the block, its Chrome trace written under
    `log_dir` (open it in chrome://tracing or Perfetto). CUDA activity is
    traced when `cuda` is True, or by default when CUDA is available."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{id(prof):x}.json"))
