"""Offline metric CLI (kpdiff_tpu/cli/compute_metrics.py; reference
compute_metrics.py).

Walks sampled_mols/*/raw_ligands.sdf, evaluates molecule quality, and
pickles the results (reference compute_metrics.py:17-44).
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sampled_mols_dir", type=str, required=True)
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)

    from kpdiff_tpu_torch.analysis.metrics import evaluate_samples
    from kpdiff_tpu_torch.data.sdf import parse_sdf

    root = Path(args.sampled_mols_dir)
    positions, elements = [], []
    per_pocket = {}
    for pocket_dir in sorted(root.glob("pocket_*")):
        sdf = pocket_dir / "raw_ligands.sdf"
        if not sdf.exists():
            continue
        mols = parse_sdf(sdf)
        pp, pe = [], []
        for m in mols:
            pp.append(m.coords)
            pe.append(m.elements)
        positions.extend(pp)
        elements.extend(pe)
        per_pocket[pocket_dir.name] = evaluate_samples(pp, pe)

    overall = evaluate_samples(positions, elements)
    result = {"overall": overall, "per_pocket": per_pocket}
    out = Path(args.out) if args.out else root / "metrics.pkl"
    with open(out, "wb") as f:
        pickle.dump(result, f)
    print({k: (round(v, 4) if isinstance(v, float) else v) for k, v in overall.items()})
    print(f"wrote {out}")
    return result


if __name__ == "__main__":
    main()
