"""Pocket-constrained ligand relaxation (kpdiff_tpu/analysis/pocket_minimization.py).

Reference: RDKit UFF with receptor atoms as fixed points, 400 iters,
RMSD before/after (analysis/pocket_minimization.py:67-109). When RDKit is
available we use exactly that; otherwise a first-party numpy relaxation
runs: harmonic bond springs at the perceived bond lengths + soft-sphere
repulsion between nonbonded pairs and against fixed pocket atoms. It is
not a real force field, but it removes the same class of steric clashes
the UFF step targets and gives comparable RMSD bookkeeping.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from kpdiff_tpu_torch.analysis.molecule_builder import COVALENT_RADII, HAVE_RDKIT, BuiltMolecule, to_rdkit


def rmsd(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=-1))))


def minimize_ligand_in_pocket(
    mol: BuiltMolecule,
    pocket_coords: np.ndarray,
    n_iters: int = 400,
    clash_dist: float = 2.4,
    step: float = 0.02,
) -> Tuple[BuiltMolecule, float]:
    """Relax ligand coordinates with the pocket fixed. Returns (mol', rmsd)."""
    if HAVE_RDKIT:
        out = _rdkit_minimize(mol, pocket_coords, n_iters)
        if out is not None:
            return out

    x0 = mol.coords.copy()
    x = mol.coords.astype(np.float64).copy()
    bonds = [(a, b) for a, b, _ in mol.bonds]
    d0 = np.array([np.linalg.norm(x0[a] - x0[b]) for a, b in bonds]) if bonds else np.zeros(0)
    n = x.shape[0]
    bonded = np.zeros((n, n), bool)
    for a, b in bonds:
        bonded[a, b] = bonded[b, a] = True
    radii = np.array([COVALENT_RADII.get(e, 0.76) for e in mol.elements])

    for _ in range(n_iters):
        g = np.zeros_like(x)
        # bond springs toward the perceived lengths
        for k, (a, b) in enumerate(bonds):
            diff = x[a] - x[b]
            d = np.linalg.norm(diff) + 1e-9
            f = 2.0 * (d - d0[k]) * diff / d
            g[a] += f
            g[b] -= f
        # intramolecular soft-sphere repulsion (nonbonded)
        diff = x[:, None] - x[None]
        d = np.linalg.norm(diff, axis=-1) + 1e-9
        rmin = radii[:, None] + radii[None] + 0.5
        overlap = np.maximum(rmin - d, 0.0)
        np.fill_diagonal(overlap, 0.0)
        overlap[bonded] = 0.0
        g += np.sum((-2.0 * overlap / d)[..., None] * diff, axis=1)
        # pocket clash repulsion (pocket fixed)
        pd = x[:, None] - pocket_coords[None]
        dp = np.linalg.norm(pd, axis=-1) + 1e-9
        po = np.maximum(clash_dist - dp, 0.0)
        g += np.sum((-2.0 * po / dp)[..., None] * pd, axis=1)

        x -= step * g

    out = BuiltMolecule(
        elements=list(mol.elements), coords=x.astype(np.float32), bonds=list(mol.bonds),
        largest_frag_frac=mol.largest_frag_frac,
    )
    return out, rmsd(x0, x)


def _rdkit_minimize(mol: BuiltMolecule, pocket_coords: np.ndarray, n_iters: int):
    """RDKit UFF with fixed receptor atoms (reference :67-109)."""
    try:
        from rdkit import Chem
        from rdkit.Chem import AllChem

        lig = to_rdkit(mol)
        Chem.SanitizeMol(lig)
        rec = Chem.RWMol()
        conf_pos = []
        for x, y, z in pocket_coords:
            rec.AddAtom(Chem.Atom("C"))
            conf_pos.append((float(x), float(y), float(z)))
        rc = Chem.Conformer(rec.GetNumAtoms())
        for i, p in enumerate(conf_pos):
            rc.SetAtomPosition(i, p)
        rec = rec.GetMol()
        rec.AddConformer(rc)
        combo = Chem.CombineMols(rec, lig)
        ff = AllChem.UFFGetMoleculeForceField(combo, ignoreInterfragInteractions=False)
        for i in range(rec.GetNumAtoms()):
            ff.AddFixedPoint(i)
        ff.Minimize(maxIts=n_iters)
        pos = combo.GetConformer().GetPositions()[rec.GetNumAtoms():]
        out = BuiltMolecule(
            elements=list(mol.elements), coords=np.asarray(pos, np.float32), bonds=list(mol.bonds),
            largest_frag_frac=mol.largest_frag_frac,
        )
        return out, rmsd(mol.coords, out.coords)
    except Exception:
        return None


def pocket_minimization(
    pocket_coords: np.ndarray,
    mols: List[BuiltMolecule],
    n_iters: int = 400,
) -> Tuple[List[BuiltMolecule], List[float]]:
    """Loop over the molecules (reference pocket_minimization :49-62 used a
    multiprocessing pool; sizes here don't need one)."""
    out_mols, rmsds = [], []
    for m in mols:
        mm, r = minimize_ligand_in_pocket(m, pocket_coords, n_iters=n_iters)
        out_mols.append(mm)
        rmsds.append(r)
    return out_mols, rmsds


def minimize_and_write(pocket_coords: np.ndarray, mols: List[BuiltMolecule], out_dir,
                       n_iters: int = 400) -> List[float]:
    """In-sampler minimization output (reference test.py:269-274 /
    byop.py:389-395 filenames): `pocket_minimized_ligands.sdf` +
    `pocket_min_rmsds.csv` written into ``out_dir``. Returns the RMSDs."""
    import csv
    from pathlib import Path

    from kpdiff_tpu_torch.data.sdf import write_sdf

    out_dir = Path(out_dir)
    minimized, rmsds = pocket_minimization(pocket_coords, mols, n_iters=n_iters)
    write_sdf([m.to_sdf_mol(title=f"min_{i}") for i, m in enumerate(minimized)],
              out_dir / "pocket_minimized_ligands.sdf")
    with open(out_dir / "pocket_min_rmsds.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["mol_idx", "rmsd"])
        for i, r in enumerate(rmsds):
            w.writerow([i, f"{r:.4f}"])
    return rmsds
