"""Share of the keypoint slots the chain computes that hold a real
keypoint, %: the serving layer's counters (kpdiff_tpu_torch/serve.py) of
valid keypoints (each chunk's kp_mask summed over its rows) over keypoint
slots (rows run x keypoint slots), each times the chain's steps, over every
chunk; weighting by chain steps keeps set-up's one-step chains out of the
way. Every per-keypoint cost of a step (the kk rows, the kl and lk pairs,
the keypoint updates) follows the slots, not the pocket's atoms. None on
the empty context or where the program has no such counters (a commit
before them)."""
from portbench import program_tracer


def read(ctx):
    snap = program_tracer.snapshot() if ctx.get("pockets") else None
    if snap is None:
        return None
    c = snap["counters"]
    slots = c.get("serve.kp_slot_steps", 0)
    return 100.0 * c.get("serve.kp_atom_steps", 0) / slots if slots else None
