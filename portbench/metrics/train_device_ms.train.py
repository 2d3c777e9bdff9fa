"""Device ms per optimizer step: the union of the device activity intervals
of the steps profiled under torch.profiler after the window, over those steps."""


def read(ctx):
    prof = ctx["profile"]
    return None if prof is None else 1e3 * prof["busy_s"] / ctx["profiled_steps"]
