"""Device time of the edge kernel behind EGNNEdge's dense form (models/egnn.py) in one checkout of the port, for
comparing kernel versions on one card.

    python3 kpdiff_tpu_torch/edge_ab.py ROOT LABEL [--clocks] >> results.jsonl

(run as a file, not with -m, so that the package comes from ROOT)
Imports kpdiff_tpu_torch from the checkout at ROOT (this tree, or an earlier
commit unpacked with `git archive`), builds its kernel and times it, bf16, at
the shapes the main paths give it (flagship ll and kk at batch 128 and 32,
width 256, a data-parallel rank's ll32 at batch 8, kk20, the dense kl/lk
grids, kk 128 x 128, block windows, a keypoint-sharded rank's kk 24 -> 3) on
inputs made from one seed. Active pairs follow the main paths' densities
(kk dense, ll about half). Each row is the device ms per launch, 20 launches
queued behind a spin kernel (chip_smoke.py's `device_ms`), its active pairs
and a digest of its outputs (equal digests: bitwise equal sums). --clocks
adds the profiling build's phase shares at flagship kk40 and ll48. Prints
one JSON line. Two checkouts run in one call on one card: parent, change,
change, parent.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

SHAPES = (("kk40_b128", 128, 40, 40, 257, 0.975), ("ll48_b128", 128, 48, 48, 257, 0.55),
          ("ll32_b128", 128, 32, 32, 257, 0.55), ("ll16_b128", 128, 16, 16, 257, 0.55),
          ("kk40_b32", 32, 40, 40, 257, 0.975), ("ll32_b32", 32, 32, 32, 257, 0.55),
          ("kk40_h256_b32", 32, 40, 40, 256, 0.975), ("ll32_h256_b32", 32, 32, 32, 256, 0.55),
          ("ll32_b8", 8, 32, 32, 257, 0.55), ("kk20_b32", 32, 20, 20, 257, 0.95),
          ("kl40_32_b32", 32, 40, 32, 257, 0.5), ("lk32_40_b32", 32, 32, 40, 257, 0.5),
          ("kk128_b32", 32, 128, 128, 257, 0.3), ("blocks192_64", 192, 192, 64, 257, 0.1),
          ("kk24_3_b32", 32, 24, 3, 257, 0.95))
CLOCK_SHAPES = ("kk40_b128", "ll48_b128")
SPIN_CYCLES = 20_000_000


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("root", help="checkout whose kpdiff_tpu_torch is timed")
    ap.add_argument("label")
    ap.add_argument("--clocks", action="store_true", help="also the profiling build's phase shares")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch
    from kpdiff_tpu_torch.ops.cuda import egnn_edge as E

    if not torch.cuda.is_available():
        sys.exit("edge_ab: needs a CUDA card")
    dev = torch.device("cuda", 0)

    def queued(fn, iters=20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def inputs(b, ns, nd, h, density):
        rng = np.random.default_rng(7)

        def t(x, dtype=torch.float32):
            return torch.as_tensor(x, device=dev).to(dtype).contiguous()

        bw = 1.0 / np.sqrt(h)
        a = [t(rng.normal(size=(b, n, h)).astype(np.float32)) for n in (ns, nd, ns, nd)]
        w_dij = [t(rng.normal(size=h).astype(np.float32)) for _ in range(2)]
        w2e, w2c = (t(rng.uniform(-bw, bw, size=(h, h)).astype(np.float32)) for _ in range(2))
        b2e, attw, atb, b2c = (t(rng.uniform(-bw, bw, size=n).astype(np.float32)) for n in (h, h, 1, h))
        wout = t(rng.uniform(-bw, bw, size=h).astype(np.float32) * 0.01)
        x_s = t(rng.normal(size=(b, ns, 3)).astype(np.float32) * 3)
        x_d = t(rng.normal(size=(b, nd, 3)).astype(np.float32) * 3)
        adj = t(rng.random((b, ns, nd)) < density, torch.bool)
        cd = torch.bfloat16
        a = [E.aligned_rows(x, cd) for x in a]
        w2e, w2c = E.pack_w2(w2e, cd), E.pack_w2(w2c, cd)
        return (*a, *w_dij, w2e, b2e, attw, atb, w2c, b2c, wout, x_s, x_d, adj)

    def digest(out):
        return hashlib.sha256(b"".join(o.contiguous().cpu().numpy().tobytes() for o in out)).hexdigest()[:16]

    kw = dict(use_tanh=True, coords_range=10.0, compute_dtype=torch.bfloat16)
    rows, clocks = {}, {}
    for name, b, ns, nd, h, density in SHAPES:
        a = inputs(b, ns, nd, h, density)
        rows[name] = dict(device_ms=queued(lambda: E.egnn_edge_dense(*a, **kw)), pairs=int(a[15].sum()),
                          digest=digest(E.egnn_edge_dense(*a, **kw)))
        if args.clocks and name in CLOCK_SHAPES:
            got = E.phase_clocks(*a, **kw)
            by_role = got if isinstance(next(iter(got.values())), dict) else {"all": got}
            clocks[name] = {role: {k: v / max(sum(c.values()), 1) for k, v in c.items()} for role, c in by_role.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(label=args.label, card=card, rows=rows, phase_shares=clocks)), flush=True)


if __name__ == "__main__":
    main()
