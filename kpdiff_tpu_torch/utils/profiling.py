"""The port's tracer: host spans and counters at its layer boundaries, device
timers inside captured CUDA graphs, and the Chrome-trace exporter
(kpdiff_tpu/utils/profiling.py is the JAX package's timer).

Host spans. `with span("serve.decode"):` adds the span's duration and its
self time (the duration less what its child spans on the same thread
cover) to per-name totals on `time.perf_counter_ns`, always. Spans open at
layer boundaries only: a few per request or optimizer step, one around a
chain's whole replay loop. `span(name, request=True)` starts a new request
(or step) id that its child spans share. `count(name, n)` adds to an
integer counter.

Tracing is on while a torch profiler records in this process
(`torch.autograd.profiler._is_profiler_enabled`) or after `enable()`.
While it is on, a span also keeps a record (name, start and end ns,
parent's name, request id, thread) in a bounded buffer (`records()`), and
opens a profiler range "kpdiff.<name>", so that the program's spans lie in
the same Kineto trace as the device's kernels, on the same clock. The range
is an operator-scope range (`_RecordFunctionFast`), not a user annotation:
a user annotation gets a mirror on the GPU timeline, which a trace reducer
would take for device work.

Device timers. A graph runner (models/chain_graph.py, and the train and
held-out loss runners built on it) arms each CUDA-graph capture it makes:
`armed` gives the capture a buffer in device memory, and the runner brackets
the captured step with a begin and an end stamp. `device_mark(slot,
*tensors)` in code that such a capture records says "the device work from
here on belongs to `slot`": it queues one stamp, a one-thread kernel
(csrc/egnn_edge.cu, `kpdiff_device_stamp`) that adds the %globaltimer
time since the graph's previous stamp to the slot that was open, on every
replay. The slots (SLOTS) are edge sets, not modules: ll, kl (kl and lk),
kk, the encoder, the OT loss, the optimizer, and rest. With autograd
recording, the tensors given pass through an identity whose backward also
stamps: backward runs in exactly the reverse order of the forward's graph
(the engine takes nodes by falling sequence number), so that stamp closes
the segment's backward and credits it to the same slot. Outside an armed
capture (eager steps, the CPU) a mark is one check. Nothing is read until
`snapshot()` copies the buffers to the host, once. Each buffer also counts
its graph's replays (the begin stamp), so a slot's total over the replays
its stamps saw gives device ns per step; the runner's own `replays` per
live graph stays where it is. A capture also counts its graph's kernel
nodes once, from the graph itself (`cudaGraphGetNodes`), the stamps left out.

`snapshot()` returns span totals, counters, device timers by runner kind
and the counters the port keeps elsewhere (the edge kernel's launches,
those of its list mode and captured calls, the GVP message kernel's
launches and captured calls, the live runners' captures and replays). `device_trace` writes torch.profiler's Chrome trace, spans
included.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
import weakref
from pathlib import Path
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

SLOTS = ("rest", "ll", "kl", "kk", "encoder", "ot", "optimizer")
_SLOT = {name: i for i, name in enumerate(SLOTS)}
BEGIN = -1  # the stamp that opens a replay: no slot credited, the replay counted
RECORDS = 1 << 16  # span records kept while tracing (the oldest dropped first)
PREFIX = "kpdiff."
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


class Span:
    """One host span (see the module docstring); `span()` makes it."""

    __slots__ = ("name", "request", "t0", "ns", "_child_ns", "_parent", "_range", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, request: bool):
        self._tracer, self.name, self.request = tracer, name, request
        self.ns = 0

    def __enter__(self) -> "Span":
        tr = self._tracer
        stack = tr._stack()
        self._parent = stack[-1] if stack else None
        if self.request is True:
            self.request = next(tr._ids)
        else:
            self.request = self._parent.request if self._parent is not None else None
        self._child_ns = 0
        self._range = None
        if tr.tracing() and _RANGE is not None:
            self._range = _RANGE(PREFIX + self.name)
            self._range.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.stop()

    def stop(self, total_as: Optional[str] = None):
        """End the span; its totals go to `total_as` when given (a step kept
        out of the totals a metric reads), its record keeps its name."""
        t1 = time.perf_counter_ns()
        tr = self._tracer
        self.ns = t1 - self.t0
        stack = tr._stack()
        if self in stack:  # and any child left open by an exception
            del stack[stack.index(self):]
        if self._parent is not None:
            self._parent._child_ns += self.ns
        with tr._lock:
            tot = tr._totals.get(total_as or self.name)
            if tot is None:
                tot = tr._totals[total_as or self.name] = [0, 0, 0]
            tot[0] += 1
            tot[1] += self.ns
            tot[2] += self.ns - self._child_ns
        if self._range is not None:
            self._range.__exit__(None, None, None)
            tr._records.append((self.name, self.t0, t1, None if self._parent is None else self._parent.name,
                                self.request, threading.get_ident()))

    @property
    def seconds(self) -> float:
        return self.ns * 1e-9


class GraphTimers:
    """The device timers of one armed capture: a buffer of int64 [previous
    stamp's time, replays, ns per slot], the graph's kernel nodes (stamps
    left out) and stamps."""

    def __init__(self, kind: str, device: torch.device):
        self.kind = kind
        self.buf = torch.zeros(2 + len(SLOTS), dtype=torch.int64, device=device)
        self.kernels = 0
        self.stamps = 0

    def read(self) -> Dict:
        """This graph's totals (one copy to the host, a synchronisation)."""
        return _timer_rows(self.kind, [self], [self.buf.cpu().tolist()])


class _Armed:
    """A capture that stamps: its timers, its stream, the open slot."""

    def __init__(self, timers: GraphTimers, stamp, stream):
        self.timers, self._stamp, self.stream = timers, stamp, stream
        self.current = "rest"

    def stamp(self, slot: int):
        self._stamp(self.timers.buf, slot, self.stream)
        self.timers.stamps += 1

    def begin(self):
        """The replay's first stamp (inside the capture)."""
        self.stamp(BEGIN)
        self.current = "rest"

    def end(self):
        """The replay's last stamp: the open slot takes the time since the previous one."""
        self.stamp(_SLOT[self.current])

    def enter(self, slot: str) -> str:
        """Open `slot`; returns the slot it closed."""
        prev = self.current
        self.stamp(_SLOT[prev])
        self.current = slot
        return prev


class _Boundary(torch.autograd.Function):
    """Identity whose backward stamps, crediting the backward since the
    previous stamp to the slot that the forward opened here, and reopening
    the slot the forward closed here. An output that reaches no loss (the
    last layer's keypoint sums) keeps a None gradient: materialised zeros
    would send a backward through all the work behind it."""

    @staticmethod
    def forward(ctx, armed, closed, *tensors):
        ctx.armed, ctx.closed = armed, closed
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        armed = ctx.armed
        if _ARMED is armed:
            armed.enter(ctx.closed)
        return (None, None) + grads


_ARMED: Optional[_Armed] = None


def device_mark(slot: str, *tensors):
    """The device work queued from here on belongs to `slot` (see the module
    docstring). Returns `tensors` as a tuple: with autograd recording, those
    that require grad come back through the identity whose backward stamps,
    and the caller uses them in the segment's place."""
    armed = _ARMED
    if armed is None or slot == armed.current:
        return tensors
    closed = armed.enter(slot)
    if not torch.is_grad_enabled():
        return tensors
    grads = [i for i, t in enumerate(tensors) if torch.is_tensor(t) and t.requires_grad]
    if not grads:
        return tensors
    out = list(tensors)
    for i, t in zip(grads, _Boundary.apply(armed, closed, *(tensors[i] for i in grads))):
        out[i] = t
    return tuple(out)


def cuda_stamp(buf: torch.Tensor, slot: int, stream):
    """The CUDA stamp (csrc/egnn_edge.cu) on `stream`."""
    from kpdiff_tpu_torch.ops.cuda import egnn_edge

    egnn_edge.device_stamp(buf, slot, stream)


class Tracer:
    """Span totals, counters, span records and device timers of one process
    (the module's functions use `TRACER`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._totals: Dict[str, List[int]] = {}
        self._counters: Dict[str, int] = {}
        self._records = collections.deque(maxlen=RECORDS)
        self._timers: List[GraphTimers] = []
        self._runners = weakref.WeakSet()
        self.enabled = False

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def tracing(self) -> bool:
        return self.enabled or bool(_autograd_profiler._is_profiler_enabled)

    def span(self, name: str, request: bool = False) -> Span:
        return Span(self, name, request)

    def count(self, name: str, n: int = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def records(self) -> list:
        """Span records (name, start_ns, end_ns, parent, request, thread) kept while tracing."""
        with self._lock:
            return list(self._records)

    def register(self, runner):
        """A graph runner whose captures and replays the snapshot reads."""
        self._runners.add(runner)

    @contextlib.contextmanager
    def armed(self, kind: str, device, stream=None, stamp=None):
        """Arm the capture made inside the block on `stream`: the stamps of
        `device_mark` go to a new GraphTimers of `kind`. `stamp(buf, slot,
        stream)` queues one (default: the CUDA stamp; a test passes a
        recorder)."""
        global _ARMED
        timers = GraphTimers(kind, torch.device(device))
        with self._lock:
            self._timers.append(timers)
        _ARMED = _Armed(timers, stamp or cuda_stamp, stream)
        try:
            yield _ARMED
        finally:
            _ARMED = None

    def snapshot(self) -> Dict:
        """Span totals, counters, device timers by runner kind, and the
        counters kept elsewhere; one copy of the timer buffers to the host."""
        from kpdiff_tpu_torch.ops.cuda import egnn_edge, gvp_message

        with self._lock:
            spans = {k: {"n": v[0], "ns": v[1], "self_ns": v[2]} for k, v in self._totals.items()}
            counters = dict(self._counters)
            timers = list(self._timers)
        kinds: Dict[str, List[GraphTimers]] = {}
        for t in timers:
            kinds.setdefault(t.kind, []).append(t)
        rows = {}  # one copy per device
        for dev in {t.buf.device for t in timers}:
            on_dev = [t for t in timers if t.buf.device == dev]
            rows.update(zip(map(id, on_dev), torch.stack([t.buf for t in on_dev]).tolist()))
        out_timers = {kind: _timer_rows(kind, group, [rows[id(t)] for t in group]) for kind, group in kinds.items()}
        counters["egnn_edge.launches"] = egnn_edge.launches
        counters["egnn_edge.captured"] = egnn_edge.captured
        counters["egnn_edge.list_launches"] = egnn_edge.list_launches
        counters["gvp_message.launches"] = gvp_message.launches
        counters["gvp_message.captured"] = gvp_message.captured
        for runner in list(self._runners):
            name = runner.name
            counters[f"{name}.captures_recorded"] = counters.get(f"{name}.captures_recorded", 0) + len(runner.captures)
            counters[f"{name}.live_replays"] = counters.get(f"{name}.live_replays", 0) + sum(
                e.replays for e in runner._entries.values())
        return {"spans": spans, "counters": counters, "timers": out_timers}


def _timer_rows(kind: str, group: List[GraphTimers], rows: List[List[int]]) -> Dict:
    """Totals of a runner kind's timers: graphs, replays the stamps saw, ns
    per slot, kernel nodes a replay weighted by replays."""
    replays = sum(r[1] for r in rows)
    slots = {name: sum(r[2 + i] for r in rows) for i, name in enumerate(SLOTS)}
    return {"graphs": len(group), "replays": replays, "slots_ns": slots,
            "kernels_x_replays": sum(t.kernels * r[1] for t, r in zip(group, rows))}


TRACER = Tracer()


def span(name: str, request: bool = False) -> Span:
    """A host span of the port's tracer (module docstring)."""
    return TRACER.span(name, request)


def count(name: str, n: int = 1):
    TRACER.count(name, n)


def snapshot() -> Dict:
    return TRACER.snapshot()


def records() -> list:
    return TRACER.records()


def tracing() -> bool:
    return TRACER.tracing()


def enable(on: bool = True):
    """Keep span records and profiler ranges without a profiler too."""
    TRACER.enabled = bool(on)


def armed(kind: str, device, stream=None, stamp=None):
    return TRACER.armed(kind, device, stream, stamp)


@contextlib.contextmanager
def device_trace(log_dir: str, cuda: Optional[bool] = None):
    """torch.profiler over the block, its Chrome trace (with the program's
    "kpdiff." ranges) written under `log_dir` (open it in chrome://tracing
    or Perfetto). CUDA activity is traced when `cuda` is True, or by default
    when CUDA is available. Yields the profile."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{id(prof):x}.json"))
