"""Device ms per reverse step of the kl and lk edges (kNN pairs or dense):
the `kl` slot of the program's timers inside the chain graphs
(kpdiff_tpu_torch/utils/profiling.py; placed by edge set in the EGNN and
GVP conv layers), over every chain-graph replay of the run, set-up's
included. None on the empty context, where the program has no such timers,
or where no chain graph replayed (the CPU)."""
from portbench import program_tracer


def read(ctx):
    return program_tracer.slot_ms("chain", "kl") if ctx.get("pockets") else None
