"""Device-timeline ms per reverse step: the benchmark's CUDA events around the
sampler model's `sample` call, summed over the window's pockets, over the
steps those chains ran."""


def read(ctx):
    steps = sum(p["steps"] for p in ctx["pockets"])
    return sum(p["chain_ms"] for p in ctx["pockets"]) / steps if steps else None
