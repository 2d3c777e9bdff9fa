"""Kernels per reverse step: the kernel nodes of each captured chain graph,
counted once at its capture from the graph itself (cudaGraphGetNodes; the
tracer's own stamps left out), weighted by the replays its timers saw
(kpdiff_tpu_torch/utils/profiling.py). None on the empty context, where
the program has no such count, or where no chain graph replayed (the CPU)."""
from portbench import program_tracer


def read(ctx):
    t = program_tracer.timers("chain") if ctx.get("pockets") else None
    return None if t is None else t["kernels_x_replays"] / t["replays"]
