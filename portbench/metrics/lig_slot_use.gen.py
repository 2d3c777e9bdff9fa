"""Share of the ligand slots the chain computes that hold real atoms, %:
the serving layer's counters (kpdiff_tpu_torch/serve.py) of real ligand
atom-steps (each chunk's real molecules' atoms x chain steps) over slot
atom-steps (rows run, repeat-padding included, x bucket x chain steps);
weighting by chain steps keeps set-up's one-step chains out of the way.
None on the empty context, where the program has no such counters, or
where no chain graph replayed (the CPU)."""
from portbench import program_tracer


def read(ctx):
    if not ctx.get("pockets") or program_tracer.timers("chain") is None:
        return None
    c = program_tracer.snapshot()["counters"]
    slots = c.get("serve.slot_atom_steps", 0)
    return 100.0 * c.get("serve.lig_atom_steps", 0) / slots if slots else None
