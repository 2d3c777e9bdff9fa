"""The program's own tracer (kpdiff_tpu_torch/utils/profiling.py), as the
per-layer metrics whose source is a program span or counter read it: its
snapshot (span totals, counters, the device timers inside the captured
graphs by runner kind), or None where the program has no such tracer (a
commit before it) or it has recorded nothing of the kind asked for."""
from __future__ import annotations

from typing import Dict, Optional


def snapshot() -> Optional[Dict]:
    try:
        from kpdiff_tpu_torch.utils import profiling

        return profiling.snapshot()
    except (ImportError, AttributeError):
        return None


def timers(kind: str) -> Optional[Dict]:
    """The device timers of the runner kind ("chain", "train"), None unless
    one of its graphs replayed with them."""
    snap = snapshot()
    t = None if snap is None else snap.get("timers", {}).get(kind)
    return t if t and t.get("replays") else None


def slot_ms(kind: str, *slots: str) -> Optional[float]:
    """Device ms per replay of `kind`'s graphs spent in `slots`, over every
    replay their timers saw."""
    t = timers(kind)
    return None if t is None else sum(t["slots_ns"][s] for s in slots) / t["replays"] * 1e-6
