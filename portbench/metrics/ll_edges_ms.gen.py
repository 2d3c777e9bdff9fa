"""Device ms per reverse step of the ll edges (the ligand's radius grid,
through the edge kernel on EGNN): the `ll` slot of the program's timers
inside the chain graphs (kpdiff_tpu_torch/utils/profiling.py), over every
chain-graph replay of the run. None on the empty context, where the
program has no such timers, or where no chain graph replayed (the CPU)."""
from portbench import program_tracer


def read(ctx):
    return program_tracer.slot_ms("chain", "ll") if ctx.get("pockets") else None
