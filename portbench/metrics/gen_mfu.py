"""Share of the chip's bfloat16 peak, %: the model operations of every
reverse step the window's chains ran (flops.step_flops on the pairs each
edge set's mask made active at that step, from the chain's recorded
states) over the chains' device-timeline seconds, over the peak
(peaks.json). None where the card is not in the table."""


def read(ctx):
    peak = ctx["peak"]
    pockets = ctx["pockets"]
    if peak is None or not pockets or any("model_flops" not in p for p in pockets):
        return None
    seconds = sum(p["chain_ms"] for p in pockets) * 1e-3
    return 100.0 * sum(p["model_flops"] for p in pockets) / seconds / peak["bf16_flops_per_s"]
