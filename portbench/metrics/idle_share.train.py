"""Idle share of the device over the profiled steps, %: 1 - the union of the
device activity intervals over the profiled stretch's wall (the profiler's
cost per kernel included)."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
