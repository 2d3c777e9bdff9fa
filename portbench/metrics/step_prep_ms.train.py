"""Host ms per optimizer step before the train graph's launch: the program's
span train.prepare (kpdiff_tpu_torch/training/trainer.py: from step_fn's
entry to the replay; the schedule, the cache key, the batch copied into the
graph's buffers), over the steps that replayed a captured graph without a
profiler recording (steps that captured or were profiled keep their time
apart). The device is idle through it. None on the empty context or where
the program has no such span (or no replayed step)."""
from portbench import program_tracer


def read(ctx):
    snap = program_tracer.snapshot() if ctx.get("steps") else None
    prep = None if snap is None else snap["spans"].get("train.prepare")
    return prep["ns"] / prep["n"] * 1e-6 if prep and prep["n"] else None
