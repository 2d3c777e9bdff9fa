"""Share of the chip's bfloat16 peak, %: three times the dynamics' forward
model operations of the profiled steps (flops.step_flops on each batch's
ligand radius pairs on the clean positions and its kNN pairs; the kk pairs
and the encoder left out, so a lower bound), over the window's wall per step
times the steps, over the peak (peaks.json)."""


def read(ctx):
    peak, fwd = ctx["peak"], ctx["forward_flops"]
    if peak is None or not fwd or not ctx["steps"]:
        return None
    wall_per_step = ctx["window_s"] / ctx["steps"]
    return 100.0 * 3 * (sum(fwd) / len(fwd)) / wall_per_step / peak["bf16_flops_per_s"]
