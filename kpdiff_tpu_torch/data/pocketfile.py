"""Pocket-file writer (kpdiff_tpu/data/pocketfile.py; upstream
data_processing/make_bindingmoad_pocketfile.py): extract the residues near a
reference ligand and write them as a PDB.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from kpdiff_tpu_torch.data.pdb import parse_pdb, write_pdb


def write_pocket_file(
    rec_pdb_path: str | Path,
    ligand_coords: np.ndarray,
    out_path: str | Path,
    cutoff: float = 8.0,
    remove_hydrogen: bool = True,
):
    """Write pocket.pdb containing every residue with an atom within
    `cutoff` Å of the reference ligand."""
    atoms = parse_pdb(rec_pdb_path, remove_hydrogen=remove_hydrogen)
    rec = atoms.select(~atoms.is_hetero)
    if len(rec) == 0:
        raise ValueError(f"no protein atoms in {rec_pdb_path}")
    d = np.linalg.norm(rec.coords[:, None] - np.asarray(ligand_coords)[None], axis=-1)
    near = d.min(axis=1) < cutoff
    pocket_res = np.unique(rec.res_index[near])
    pocket = rec.select(np.isin(rec.res_index, pocket_res))
    write_pdb(pocket, out_path)
    return pocket
