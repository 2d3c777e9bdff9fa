"""BindingMOAD processing CLI (kpdiff_tpu/cli/process_bindingmoad.py; the
upstream process_bindingmoad.py). Host numpy only: the pickles hold numpy
arrays, never torch tensors.

Reads DiffSBDD-style split files (moad_{train,val,test}.txt of entries like
"PDBID_LIGNAME:CHAIN:RESI"), parses the .bio* assembly PDBs with the
first-party parser, extracts per-ligand pockets (all-atom, or ca_only with
20-dim residue one-hots), accumulates the side artifacts
(type counts, joint size histogram, molecule-key set), and writes the
concatenated-tensor split pickles the dataset loader consumes
(reference process_bindingmoad.py:328-533).

    python -m kpdiff_tpu_torch.cli.process_bindingmoad \
        --data_dir BindingMOAD_2020/ --split_dir splits/ --out data/bindingmoad_processed/
"""
from __future__ import annotations

import argparse
import pickle
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from kpdiff_tpu_torch.constants import aa_to_idx, protein_letters_3to1
from kpdiff_tpu_torch.data.pdb import PdbAtoms, parse_pdb
from kpdiff_tpu_torch.data.pocket import (
    InterfacePointException,
    Unparsable,
    featurize_atoms,
    get_interface_points,
    make_element_map,
)


def element_fixer(element: str) -> str:
    """Normalize element capitalization (reference process_bindingmoad element_fixer)."""
    if len(element) > 1:
        return element[0].upper() + element[1:].lower()
    return element.upper()


def read_label_file(split_file: Path) -> List[tuple]:
    """Entries 'pdbid_LIG:CHAIN:RESI' (reference :328-339)."""
    out = []
    for line in split_file.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        pdb, rest = line.split("_", 1)
        lig_name, chain, resi = rest.split(":")
        out.append((pdb.lower(), lig_name, chain, int(resi)))
    return out


def process_ligand_and_pocket(
    atoms: PdbAtoms,
    lig_name: str,
    lig_chain: str,
    lig_resi: int,
    rec_element_map: Dict[str, int],
    lig_element_map: Dict[str, int],
    pocket_cutoff: float,
    ip_dist_threshold: float = 5.0,
    ip_exclusion_threshold: float = 2.0,
    ca_only: bool = False,
    min_ligand_atoms: int = 8,
):
    """One ligand + its pocket -> tensors (reference :84-204)."""
    if len(atoms) == 0:
        raise Unparsable("empty structure")
    lig_mask = (
        np.array([rn == lig_name for rn in atoms.resname], dtype=bool)
        & np.array([c == lig_chain for c in atoms.chain], dtype=bool)
        & (atoms.resseq == lig_resi)
    )
    if lig_mask.sum() < min_ligand_atoms:
        raise Unparsable(f"ligand {lig_name}:{lig_chain}:{lig_resi} missing or too small")
    lig_coords = atoms.coords[lig_mask]
    lig_elements = [element_fixer(atoms.element[i]) for i in np.where(lig_mask)[0]]
    lig_feats, lig_other = featurize_atoms(lig_elements, lig_element_map)
    if lig_other.sum() > 0:
        raise Unparsable("ligand contains unsupported atom types")

    rec_mask = ~atoms.is_hetero & ~lig_mask
    rec = atoms.select(rec_mask)

    # pocket residues: any atom < cutoff of any ligand atom (:125-139)
    d = np.linalg.norm(rec.coords[:, None] - lig_coords[None], axis=-1)
    near = d.min(axis=1) < pocket_cutoff
    pocket_res = np.unique(rec.res_index[near])
    if pocket_res.size == 0:
        raise Unparsable("no pocket residues found")
    in_pocket = np.isin(rec.res_index, pocket_res)
    pocket = rec.select(in_pocket)

    if ca_only:
        ca = np.array([n == "CA" for n in pocket.name])
        pocket = pocket.select(ca)
        try:
            res_chars = [protein_letters_3to1[rn] for rn in pocket.resname]
        except KeyError:
            raise Unparsable(f"unsupported residue types: {set(pocket.resname)}")
        res_idx = np.array([aa_to_idx[c] for c in res_chars])
        feats = np.zeros((len(res_idx), len(aa_to_idx)), np.float32)
        feats[np.arange(len(res_idx)), res_idx] = 1
        pocket_coords = pocket.coords
        pocket_res_idx = pocket.res_index
        interface_points = np.zeros((0, 3), np.float32)  # ca_only skips IPs (:193-198)
    else:
        elements = [element_fixer(e) for e in pocket.element]
        feats, other = featurize_atoms(elements, rec_element_map)
        pocket_coords = pocket.coords[~other]
        feats = feats[~other]
        pocket_res_idx = pocket.res_index[~other]
        try:
            interface_points = get_interface_points(
                lig_coords, pocket_coords,
                distance_threshold=ip_dist_threshold, exclusion_threshold=ip_exclusion_threshold,
            )
        except Exception as e:
            raise InterfacePointException(e)

    # compact residue re-indexing
    _, pocket_res_idx = np.unique(pocket_res_idx, return_inverse=True)

    return dict(
        lig_pos=lig_coords.astype(np.float32),
        lig_feat=lig_feats.astype(np.float32),
        lig_elements=lig_elements,
        rec_pos=pocket_coords.astype(np.float32),
        rec_feat=feats.astype(np.float32),
        rec_res_idx=pocket_res_idx.astype(np.int32),
        interface_points=interface_points.astype(np.float32),
    )


def write_split_pickle(out_file: Path, items: List[dict], rec_files: List[str], lig_files: List[str]):
    """Concatenated-tensor pickle in the reference format (:489-512)."""
    def seg_concat(key):
        arrs = [it[key] for it in items]
        segs = np.cumsum([0] + [a.shape[0] for a in arrs])
        return (np.concatenate(arrs) if arrs else np.zeros((0, 3))), segs

    lig_pos, lig_seg = seg_concat("lig_pos")
    lig_feat, _ = seg_concat("lig_feat")
    rec_pos, rec_seg = seg_concat("rec_pos")
    rec_feat, _ = seg_concat("rec_feat")
    rri, _ = seg_concat_1d(items, "rec_res_idx")
    ips, ip_seg = seg_concat("interface_points")
    data = dict(
        lig_pos=lig_pos, lig_feat=lig_feat, rec_pos=rec_pos, rec_feat=rec_feat,
        rec_res_idx=rri, interface_points=ips,
        rec_segments=rec_seg, lig_segments=lig_seg, ip_segments=ip_seg,
        rec_files=rec_files, lig_files=lig_files,
    )
    with open(out_file, "wb") as f:
        pickle.dump(data, f)


def seg_concat_1d(items, key):
    arrs = [it[key] for it in items]
    segs = np.cumsum([0] + [a.shape[0] for a in arrs])
    return (np.concatenate(arrs) if arrs else np.zeros(0, np.int32)), segs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", type=str, required=True, help="directory of BindingMOAD .bio/.pdb files")
    p.add_argument("--split_dir", type=str, required=True, help="directory with moad_{train,val,test}.txt")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--ca_only", action="store_true")
    p.add_argument("--pocket_cutoff", type=float, default=8.0)
    p.add_argument("--min_ligand_atoms", type=int, default=8)
    p.add_argument("--rec_elements", nargs="+", default=["C", "N", "O", "S", "P", "F", "Cl", "Br", "I", "B"])
    p.add_argument("--lig_elements", nargs="+", default=["C", "N", "O", "S", "P", "F", "Cl", "Br", "I", "B"])
    p.add_argument("--max_complexes", type=int, default=None)
    args = p.parse_args(argv)

    from kpdiff_tpu_torch.analysis.molecule_builder import build_molecule, canonical_key
    from kpdiff_tpu_torch.models.size_dist import build_joint_histogram, save_joint_histogram

    data_dir, split_dir, out_dir = Path(args.data_dir), Path(args.split_dir), Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    rec_map = make_element_map(args.rec_elements)
    lig_map = make_element_map(args.lig_elements)

    train_rec_sizes, train_lig_sizes = [], []
    train_keys = set()
    type_counts: Counter = Counter()

    for split in ["train", "val", "test"]:
        split_file = split_dir / f"moad_{split}.txt"
        if not split_file.exists():
            print(f"split file {split_file} missing, skipping")
            continue
        entries = read_label_file(split_file)
        if args.max_complexes:
            entries = entries[: args.max_complexes]
        items, rec_files, lig_files = [], [], []
        n_fail = 0
        for pdb_id, lig_name, chain, resi in entries:
            pdb_file = _find_structure(data_dir, pdb_id)
            if pdb_file is None:
                n_fail += 1
                continue
            try:
                atoms = parse_pdb(pdb_file, remove_hydrogen=True)
                item = process_ligand_and_pocket(
                    atoms, lig_name, chain, resi, rec_map, lig_map,
                    pocket_cutoff=args.pocket_cutoff, ca_only=args.ca_only,
                    min_ligand_atoms=args.min_ligand_atoms,
                )
            except (Unparsable, InterfacePointException) as e:
                n_fail += 1
                continue
            items.append(item)
            rec_files.append(str(pdb_file))
            lig_files.append(f"{pdb_id}_{lig_name}:{chain}:{resi}")
            if split == "train":
                train_rec_sizes.append(item["rec_pos"].shape[0])
                train_lig_sizes.append(item["lig_pos"].shape[0])
                type_counts.update(item["lig_elements"])
                mol = build_molecule(item["lig_pos"], item["lig_elements"], sanitize=False)
                if mol is not None:
                    train_keys.add(canonical_key(mol))

        write_split_pickle(out_dir / f"{split}.pkl", items, rec_files, lig_files)
        print(f"{split}: {len(items)} complexes processed, {n_fail} failed")

    if train_rec_sizes:
        counts = np.array([type_counts.get(e, 0) for e in args.lig_elements], float)
        with open(out_dir / "train_type_counts.pkl", "wb") as f:
            pickle.dump(counts, f)
        hist, rb, lb = build_joint_histogram(train_rec_sizes, train_lig_sizes)
        save_joint_histogram(out_dir / "train_n_node_joint_dist.pkl", hist, rb, lb)
        with open(out_dir / "train_smiles.pkl", "wb") as f:
            pickle.dump(train_keys, f)
        print(f"side artifacts written to {out_dir}")


def _find_structure(data_dir: Path, pdb_id: str) -> Optional[Path]:
    for pattern in (f"{pdb_id}.bio1", f"{pdb_id}.bio2", f"{pdb_id}.pdb", f"{pdb_id.upper()}.pdb",
                    f"{pdb_id}.bio1.pdb", f"{pdb_id.upper()}.bio1"):
        f = data_dir / pattern
        if f.exists():
            return f
    hits = list(data_dir.glob(f"{pdb_id}*"))
    return hits[0] if hits else None


if __name__ == "__main__":
    main()
