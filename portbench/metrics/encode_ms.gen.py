"""Device-timeline ms per pocket from the sampler model's `encode` call to
the return of its `compact_kk` (the benchmark's CUDA events around them),
averaged over the window's pockets."""


def read(ctx):
    pockets = ctx["pockets"]
    return sum(p["encode_ms"] for p in pockets) / len(pockets) if pockets else None
