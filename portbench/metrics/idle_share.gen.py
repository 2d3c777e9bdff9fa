"""Idle share of the device over a pocket, %: 1 - (the union of the device
activity intervals of a pocket profiled under torch.profiler after the
window) / (that pocket's wall under the profiler). The profiler's own cost
per replayed kernel reads as idle here; against the wall of an unprofiled
pocket the busy time under the profiler came out larger than the wall."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
