"""PDBbind dataset (legacy; kpdiff_tpu/data/pdbbind.py, after the upstream
data_processing/pdbbind_dataset.py:18-145).

Layout parity with the reference:
  * an index file of PDB ids, one per line (pdbbind_dataset.py:88-90);
  * raw data under raw_data_dir/{id}/{id}_protein_nowater.pdb and
    raw_data_dir/{id}/{id}_ligand.sdf (pdbbind_dataset.py:99-105);
  * per-PDB processed artifacts under processed_data_dir/{id}/
    (reference saves a DGL graph + a torch payload,
    pdbbind_dataset.py:119-131; here one {id}.npz of plain arrays).

Differences by design: processing uses the first-party PDB/SDF parsers
and residue-level pocket extraction (data/pocket.py) instead of
prody/rdkit, and items come back in the same dict schema as
ComplexDataset.get() so PaddedLoader consumes them directly (the
reference needed its own collate_fn + GraphDataLoader,
pdbbind_dataset.py:133-145). The reference's unfinished
use_boltzmann_ot branch (its get_ot_loss_weights TODO) is not ported.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from kpdiff_tpu_torch.data.pdb import parse_pdb
from kpdiff_tpu_torch.data.pocket import Unparsable, featurize_atoms, get_pocket_atoms, make_element_map
from kpdiff_tpu_torch.data.sdf import parse_sdf


def process_pdbbind(
    index_file: str | Path,
    raw_data_dir: str | Path,
    processed_data_dir: str | Path,
    rec_elements: List[str],
    lig_elements: List[str],
    lig_box_padding: float = 6.0,
    pocket_cutoff: float = 4.0,
    dataset_size: Optional[int] = None,
    remove_hydrogen: bool = True,
) -> List[str]:
    """Process raw PDBbind entries into per-PDB npz files; returns the ids
    processed (failures are skipped with a count, reference-style)."""
    raw = Path(raw_data_dir)
    out_root = Path(processed_data_dir)
    out_root.mkdir(parents=True, exist_ok=True)

    with open(index_file) as f:
        pdb_ids = [line.strip() for line in f if line.strip()]
    if dataset_size is not None:
        pdb_ids = pdb_ids[:dataset_size]

    rec_map = make_element_map(rec_elements)
    lig_map = make_element_map(lig_elements)

    done, failures = [], 0
    for pdb_id in pdb_ids:
        try:
            atoms = parse_pdb(raw / pdb_id / f"{pdb_id}_protein_nowater.pdb",
                              remove_hydrogen=remove_hydrogen)
            mols = parse_sdf(raw / pdb_id / f"{pdb_id}_ligand.sdf")
            if not mols:
                raise Unparsable(f"{pdb_id}: empty ligand sdf")
            mol = mols[0]
            lig_elems = [e for e in mol.elements]
            lig_pos = np.asarray(mol.coords, np.float32)
            if remove_hydrogen:
                keep = np.array([e != "H" for e in lig_elems])
                lig_pos = lig_pos[keep]
                lig_elems = [e for e, k in zip(lig_elems, keep) if k]
            # same featurization convention as the main pipeline: atoms
            # outside the element list are dropped, no 'other' column
            lig_feat, lig_other = featurize_atoms(lig_elems, lig_map)
            lig_feat = lig_feat[~lig_other].astype(np.float32)
            lig_pos = lig_pos[~lig_other]

            pocket_pos, pocket_feat, byres_mask, ip = get_pocket_atoms(
                atoms.coords, atoms.element, atoms.res_index, lig_pos,
                box_padding=lig_box_padding, pocket_cutoff=pocket_cutoff,
                element_map=rec_map,
            )
            # byres_mask indexes the 'other'-element-filtered atom set
            # (get_pocket_atoms drops them first) — filter res_index the
            # same way before applying it
            _, rec_other = featurize_atoms(atoms.element, rec_map)
            res_idx = atoms.res_index[~rec_other][byres_mask]

            out_dir = out_root / pdb_id
            out_dir.mkdir(exist_ok=True)
            np.savez_compressed(
                out_dir / f"{pdb_id}.npz",
                lig_pos=lig_pos, lig_feat=lig_feat,
                rec_pos=pocket_pos.astype(np.float32), rec_feat=pocket_feat.astype(np.float32),
                rec_res_idx=res_idx.astype(np.int32),
                interface_points=ip.astype(np.float32),
            )
            done.append(pdb_id)
        except Exception:
            failures += 1
    if failures:
        print(f"pdbbind: processed {len(done)}, skipped {failures} unparsable entries", flush=True)
    return done


class PDBbindDataset:
    """Per-PDB processed-file dataset with the ComplexDataset item schema
    (so PaddedLoader and the CLIs consume it unchanged)."""

    def __init__(self, processed_data_dir: str | Path, pdb_ids: Optional[List[str]] = None):
        self.root = Path(processed_data_dir)
        if pdb_ids is None:
            pdb_ids = sorted(p.name for p in self.root.iterdir()
                             if (p / f"{p.name}.npz").exists())
        self.pdb_ids = pdb_ids
        if not self.pdb_ids:
            raise ValueError(f"no processed PDBbind entries under {self.root}")
        # feature width for loader setup (mirrors ComplexDataset.lig_feat)
        first = np.load(self.root / self.pdb_ids[0] / f"{self.pdb_ids[0]}.npz")
        self.lig_feat = first["lig_feat"]

    def __len__(self) -> int:
        return len(self.pdb_ids)

    def get(self, i: int) -> Dict[str, np.ndarray]:
        pdb_id = self.pdb_ids[i]
        z = np.load(self.root / pdb_id / f"{pdb_id}.npz")
        return dict(
            lig_pos=z["lig_pos"], lig_feat=z["lig_feat"],
            rec_pos=z["rec_pos"], rec_feat=z["rec_feat"],
            rec_res_idx=z["rec_res_idx"], interface_points=z["interface_points"],
        )

    def get_files(self, i: int):
        pdb_id = self.pdb_ids[i]
        return (str(self.root / pdb_id / f"{pdb_id}.npz"), None)
