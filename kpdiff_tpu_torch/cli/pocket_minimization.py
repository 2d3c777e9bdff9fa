"""Per-pocket minimization CLI with lockfile (kpdiff_tpu/cli/pocket_minimization.py;
reference analysis/pocket_minimization.py:116-141 __main__ path).

    python -m kpdiff_tpu_torch.cli.pocket_minimization --pocket_dir sampled_mols/pocket_0
"""
from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pocket_dir", type=str, required=True)
    p.add_argument("--n_iters", type=int, default=400)
    args = p.parse_args(argv)

    from kpdiff_tpu_torch.analysis.molecule_builder import BuiltMolecule
    from kpdiff_tpu_torch.analysis.pocket_minimization import pocket_minimization
    from kpdiff_tpu_torch.data.pdb import parse_pdb
    from kpdiff_tpu_torch.data.sdf import parse_sdf, write_sdf

    pdir = Path(args.pocket_dir)
    lock = pdir / "min_running"
    if lock.exists():
        print(f"{pdir}: lockfile present, skipping")
        return
    lock.touch()
    try:
        pocket = parse_pdb(pdir / "pocket.pdb")
        mols_sdf = parse_sdf(pdir / "raw_ligands.sdf")
        mols = [
            BuiltMolecule(elements=m.elements, coords=m.coords, bonds=m.bonds)
            for m in mols_sdf
        ]
        minimized, rmsds = pocket_minimization(pocket.coords, mols, n_iters=args.n_iters)
        write_sdf([m.to_sdf_mol(title=f"min_{i}") for i, m in enumerate(minimized)], pdir / "minimized.sdf")
        with open(pdir / "minimization_rmsd.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["mol_idx", "rmsd"])
            for i, r in enumerate(rmsds):
                w.writerow([i, f"{r:.4f}"])
        print(f"{pdir}: minimized {len(minimized)} mols, mean RMSD {np.mean(rmsds):.3f}")
    finally:
        lock.unlink(missing_ok=True)


if __name__ == "__main__":
    main()
