"""Share of the kk neighbor list's slots that hold an edge, %: the serving
layer's counters (kpdiff_tpu_torch/serve.py) of valid kk edges over the
slots the list computes (rows run x keypoint slots x cap), each times the
chain's steps, over every chunk whose kk was a neighbor list; weighting by
chain steps keeps set-up's one-step chains out of the way. None on the
empty context or where the program has no such counters (a commit before
them) or made no neighbor list."""
from portbench import program_tracer


def read(ctx):
    snap = program_tracer.snapshot() if ctx.get("pockets") else None
    if snap is None:
        return None
    c = snap["counters"]
    slots = c.get("serve.kk_nbr_slots", 0)
    return 100.0 * c.get("serve.kk_nbr_edges", 0) / slots if slots else None
