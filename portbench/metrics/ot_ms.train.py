"""Device ms per optimizer step of the receptor encoder's OT loss (the
Sinkhorn iterations), forward and backward: the `ot` slot of the program's
timers inside the train graphs (kpdiff_tpu_torch/utils/profiling.py; a
segment's backward is credited to its own slot), over every train-graph
replay of the run. None on the empty context, where the program has no
such timers, or where no train graph replayed (the CPU)."""
from portbench import program_tracer


def read(ctx):
    return program_tracer.slot_ms("train", "ot") if ctx.get("steps") else None
