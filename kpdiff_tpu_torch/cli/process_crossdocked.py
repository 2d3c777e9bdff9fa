"""CrossDocked processing CLI (kpdiff_tpu/cli/process_crossdocked.py; the
upstream process_crossdocked.py, whose readme flags that path as possibly
broken). It writes the same split-pickle format as the BindingMOAD
pipeline, so the rest of the package is format-agnostic.

Index file: a pickle/torch file mapping split -> list of
(pocket_pdb_relpath, ligand_sdf_relpath) pairs (the DiffSBDD crossdocked
index the reference consumes, process_crossdocked.py:63-76).

    python -m kpdiff_tpu_torch.cli.process_crossdocked \
        --data_dir crossdocked_pocket10/ --index_file split_by_name.pt \
        --out data/crossdocked_processed/
"""
from __future__ import annotations

import argparse
import pickle
from collections import Counter
from pathlib import Path

import numpy as np


def load_index(path: Path):
    """Index pickles may be plain pickle or torch-saved."""
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except Exception:
        import torch

        return torch.load(path, map_location="cpu", weights_only=False)


def process_pair(pocket_pdb: Path, ligand_sdf: Path, rec_map, lig_map, ds_cfg):
    from kpdiff_tpu_torch.data.pdb import parse_pdb
    from kpdiff_tpu_torch.data.pocket import Unparsable, get_pocket_atoms
    from kpdiff_tpu_torch.data.sdf import parse_sdf

    atoms = parse_pdb(pocket_pdb, remove_hydrogen=ds_cfg.get("remove_hydrogen", True))
    rec = atoms.select(~atoms.is_hetero)
    if len(rec) == 0:
        raise Unparsable("no protein atoms")

    mols = parse_sdf(ligand_sdf)
    if not mols:
        raise Unparsable("no ligand in sdf")
    lig = mols[0]
    if ds_cfg.get("remove_hydrogen", True):
        lig = lig.without_hydrogens()
    if lig.n_atoms < ds_cfg.get("min_ligand_atoms", 8):
        raise Unparsable("ligand too small")

    from kpdiff_tpu_torch.data.pocket import featurize_atoms

    lig_feats, lig_other = featurize_atoms(lig.elements, lig_map)
    if lig_other.sum() > 0:
        raise Unparsable("unsupported ligand atom types")

    pocket_coords, pocket_feats, byres_mask, interface_points = get_pocket_atoms(
        rec.coords, rec.element, rec.res_index, lig.coords,
        box_padding=ds_cfg.get("lig_box_padding", 8),
        pocket_cutoff=ds_cfg.get("pocket_cutoff", 8),
        element_map=rec_map,
        interface_distance_threshold=ds_cfg.get("interface_distance_threshold", 5),
        interface_exclusion_threshold=ds_cfg.get("interface_exclusion_threshold", 2),
    )
    res_idx = rec.res_index[byres_mask]
    _, res_idx = np.unique(res_idx, return_inverse=True)

    return dict(
        lig_pos=lig.coords.astype(np.float32),
        lig_feat=lig_feats.astype(np.float32),
        lig_elements=list(lig.elements),
        rec_pos=pocket_coords.astype(np.float32),
        rec_feat=pocket_feats.astype(np.float32),
        rec_res_idx=res_idx.astype(np.int32),
        interface_points=interface_points.astype(np.float32),
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--index_file", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--rec_elements", nargs="+", default=["C", "N", "O", "S", "P", "F", "Cl", "Br", "I", "B"])
    p.add_argument("--lig_elements", nargs="+", default=["C", "N", "O", "S", "P", "F", "Cl", "Br", "I", "B"])
    p.add_argument("--pocket_cutoff", type=float, default=8.0)
    p.add_argument("--min_ligand_atoms", type=int, default=8)
    p.add_argument("--max_complexes", type=int, default=None)
    p.add_argument("--skip_train", action="store_true")
    args = p.parse_args(argv)

    from kpdiff_tpu_torch.analysis.molecule_builder import build_molecule, canonical_key
    from kpdiff_tpu_torch.cli.process_bindingmoad import write_split_pickle
    from kpdiff_tpu_torch.data.pocket import InterfacePointException, Unparsable, make_element_map
    from kpdiff_tpu_torch.models.size_dist import build_joint_histogram, save_joint_histogram

    data_dir = Path(args.data_dir)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    rec_map = make_element_map(args.rec_elements)
    lig_map = make_element_map(args.lig_elements)
    ds_cfg = dict(
        remove_hydrogen=True, min_ligand_atoms=args.min_ligand_atoms,
        pocket_cutoff=args.pocket_cutoff, lig_box_padding=8,
    )

    index = load_index(Path(args.index_file))
    train_rec_sizes, train_lig_sizes, train_keys = [], [], set()
    type_counts: Counter = Counter()

    for split_key, pairs in index.items():
        if split_key == "train" and args.skip_train:
            continue
        if args.max_complexes:
            pairs = pairs[: args.max_complexes]
        items, rec_files, lig_files = [], [], []
        n_fail = 0
        for pocket_rel, lig_rel in pairs:
            try:
                item = process_pair(data_dir / pocket_rel, data_dir / lig_rel, rec_map, lig_map, ds_cfg)
            except (Unparsable, InterfacePointException, FileNotFoundError):
                n_fail += 1
                continue
            items.append(item)
            rec_files.append(str(data_dir / pocket_rel))
            lig_files.append(str(data_dir / lig_rel))
            if split_key == "train":
                train_rec_sizes.append(item["rec_pos"].shape[0])
                train_lig_sizes.append(item["lig_pos"].shape[0])
                type_counts.update(item["lig_elements"])
                mol = build_molecule(item["lig_pos"], item["lig_elements"], sanitize=False)
                if mol is not None:
                    train_keys.add(canonical_key(mol))
        out_name = {"test": "test", "val": "val", "train": "train"}.get(split_key, split_key)
        write_split_pickle(out_dir / f"{out_name}.pkl", items, rec_files, lig_files)
        print(f"{split_key}: {len(items)} processed, {n_fail} failed", flush=True)

    if train_rec_sizes:
        counts = np.array([type_counts.get(e, 0) for e in args.lig_elements], float)
        with open(out_dir / "train_type_counts.pkl", "wb") as f:
            pickle.dump(counts, f)
        hist, rb, lb = build_joint_histogram(train_rec_sizes, train_lig_sizes)
        save_joint_histogram(out_dir / "train_n_node_joint_dist.pkl", hist, rb, lb)
        with open(out_dir / "train_smiles.pkl", "wb") as f:
            pickle.dump(train_keys, f)


if __name__ == "__main__":
    main()
