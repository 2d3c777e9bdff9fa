"""Device ms per optimizer step of the dense ll and kk edges (the plain
version under autograd), forward and backward: the `ll` and `kk` slots of
the program's timers inside the train graphs
(kpdiff_tpu_torch/utils/profiling.py), over every train-graph replay of
the run. None on the empty context, where the program has no such timers,
or where no train graph replayed (the CPU)."""
from portbench import program_tracer


def read(ctx):
    return program_tracer.slot_ms("train", "ll", "kk") if ctx.get("steps") else None
