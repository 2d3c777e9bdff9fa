"""Host time of the serving layer per pocket, ms: KeypointSampler's own
`last_request` parts around the chain (front_end_s: sizes, padding,
collation; copy_s: the outputs to the host and decoding; build_s: bond
perception), summed over the window's pockets, over the pockets."""


def read(ctx):
    pockets = ctx["pockets"]
    return 1e3 * sum(p["host_s"] for p in pockets) / len(pockets) if pockets else None
