"""BYOP, bring your own protein (kpdiff_tpu/cli/byop.py; reference byop.py).

The user supplies a receptor (.pdb or .cif/.mmcif) and a reference ligand
SDF that defines the pocket; pocket extraction and featurization run at
inference with the first-party parsers, then the port's sampler draws
molecules at the reference ligand's centre of mass on one CUDA card
(`--device cpu` runs the plain PyTorch path on the CPU); with
`--kp_shard_devices N` the keypoints are split over N devices
(serve.py::KeypointSampler starts the N - 1 worker ranks).

    python -m kpdiff_tpu_torch.cli.byop --model_dir runs/<run> \\
        --receptor_file prot.pdb --ligand_file ref_lig.sdf --out byop_out/

Writes raw_ligands.sdf, pocket.pdb, keypoints.xyz (learned encoders) and,
with --pocket_minimization, pocket_minimized_ligands.sdf and
pocket_min_rmsds.csv into --out.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_dir", type=str, required=True, help="port run dir: config.yml + checkpoints/step_N.pt")
    p.add_argument("--checkpoint_step", type=int, default=None)
    p.add_argument("--receptor_file", type=str, required=True, help="receptor structure, .pdb or .cif/.mmcif")
    p.add_argument("--ligand_file", type=str, required=True, help="reference ligand SDF defining the pocket")
    p.add_argument("--out", type=str, default="byop_out")
    p.add_argument("--n_mols", type=int, default=32)
    p.add_argument("--sample_steps", type=int, default=0,
                   help="strided sampling with K < n_timesteps ancestral steps; 0 = the full chain")
    p.add_argument("--eta", type=float, default=1.0,
                   help="DDIM noise scale: 1.0 = the ancestral chain; 0.0 = deterministic DDIM")
    p.add_argument("--max_batch_size", type=int, default=64)
    p.add_argument("--kp_shard_devices", type=int, default=0,
                   help="split the keypoints of the reverse diffusion over this many devices "
                        "(parallel/kp_shard.py; one rank each)")
    p.add_argument("--pocket_minimization", action="store_true",
                   help="relax the sampled ligands inside the fixed pocket and write "
                        "pocket_minimized_ligands.sdf + pocket_min_rmsds.csv")
    p.add_argument("--ligand_size", type=str, default="random",
                   help="'random' (joint size distribution), 'ref' (reference ligand count) or an integer")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default; raises without CUDA) or cpu")
    return p.parse_args(argv)


def process_ligand_and_pocket(receptor_file, ligand_file, config):
    """Pocket extraction at inference (reference byop.py:99-206). The
    receptor may be .pdb or .cif/.mmcif. A `dataset.ca_only` config (the
    *_ca families) gets one node per pocket residue, its Cα, featurized by
    the 20 residue one-hots and without interface points, as the processing
    CLI's --ca_only (kpdiff_tpu/cli/process_bindingmoad.py:96-108)."""
    from kpdiff_tpu_torch.constants import aa_to_idx, protein_letters_3to1
    from kpdiff_tpu_torch.data.mmcif import parse_structure
    from kpdiff_tpu_torch.data.pocket import get_pocket_atoms, make_element_map
    from kpdiff_tpu_torch.data.sdf import parse_sdf

    ds_cfg = config["dataset"]
    atoms = parse_structure(receptor_file, remove_hydrogen=ds_cfg.get("remove_hydrogen", True))
    rec = atoms.select(~atoms.is_hetero)

    lig = parse_sdf(ligand_file)[0]
    if ds_cfg.get("remove_hydrogen", True):
        lig = lig.without_hydrogens()

    emap = make_element_map(ds_cfg["rec_elements"])
    pocket_coords, pocket_feats, byres_mask, interface_points = get_pocket_atoms(
        rec.coords, rec.element, rec.res_index, lig.coords,
        box_padding=ds_cfg.get("lig_box_padding", 8),
        pocket_cutoff=ds_cfg.get("pocket_cutoff", 8),
        element_map=emap,
        interface_distance_threshold=ds_cfg.get("interface_distance_threshold", 5),
        interface_exclusion_threshold=ds_cfg.get("interface_exclusion_threshold", 2),
    )
    rec_atoms = rec.select(byres_mask)
    pocket_res_idx = rec.res_index[byres_mask]
    if ds_cfg.get("ca_only", False):
        rec_atoms = rec_atoms.select(np.array([n == "CA" for n in rec_atoms.name], dtype=bool))
        unknown = sorted({rn for rn in rec_atoms.resname if rn not in protein_letters_3to1})
        if unknown:
            raise ValueError(f"ca_only pocket: unsupported residue types {unknown}")
        aa = np.array([aa_to_idx[protein_letters_3to1[rn]] for rn in rec_atoms.resname], dtype=np.int64)
        pocket_coords, pocket_res_idx = rec_atoms.coords, rec_atoms.res_index
        pocket_feats = np.zeros((len(aa), len(aa_to_idx)), np.float32)
        pocket_feats[np.arange(len(aa)), aa] = 1
        interface_points = np.zeros((0, 3), np.float32)
    _, pocket_res_idx = np.unique(pocket_res_idx, return_inverse=True)  # compact residue indices
    return dict(
        rec_pos=pocket_coords.astype(np.float32),
        rec_feat=pocket_feats.astype(np.float32),
        rec_res_idx=pocket_res_idx.astype(np.int32),
        interface_points=interface_points.astype(np.float32),
        lig_pos=lig.coords.astype(np.float32),
        lig_feat=np.zeros((lig.n_atoms, len(ds_cfg["lig_elements"])), np.float32),
        rec_atoms=rec_atoms,
        ref_lig=lig,
    )


def main(argv=None):
    args = parse_args(argv)

    from kpdiff_tpu_torch.serve import KeypointSampler

    sampler = KeypointSampler(args.model_dir, checkpoint_step=args.checkpoint_step,
                              batch_size=min(args.n_mols, args.max_batch_size), seed=args.seed,
                              sample_steps=args.sample_steps, eta=args.eta,
                              kp_shard_devices=args.kp_shard_devices, device=args.device)
    if sampler.rank:  # a worker rank under torchrun: sample rank 0's chunks
        sampler.worker_loop()
        return []
    try:
        return _run(args, sampler)
    finally:
        sampler.close()


def _run(args, sampler):
    from kpdiff_tpu_torch.data.pdb import write_pdb, write_xyz
    from kpdiff_tpu_torch.data.sdf import write_sdf

    config = sampler.config
    data = process_ligand_and_pocket(args.receptor_file, args.ligand_file, config)
    n_ref_atoms = data["lig_pos"].shape[0]
    n_pocket = data["rec_pos"].shape[0]
    print(f"pocket: {n_pocket} atoms; reference ligand: {n_ref_atoms} atoms", flush=True)
    if n_pocket > sampler.pad.n_rec or data["interface_points"].shape[0] > sampler.pad.n_ip:
        raise SystemExit(f"pocket ({n_pocket} atoms) exceeds padding capacity {sampler.pad.n_rec}; "
                         "increase padding.n_rec in the config")
    ligand_size = args.ligand_size if args.ligand_size in ("random", "ref") else int(args.ligand_size)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    mols = sampler.sample_for_arrays(
        rec_pos=data["rec_pos"], rec_feat=data["rec_feat"], rec_res_idx=data["rec_res_idx"],
        interface_points=data["interface_points"], init_com=data["lig_pos"].mean(0),  # byop.py:324-334
        ref_n_atoms=n_ref_atoms, n_mols=args.n_mols, ligand_size=ligand_size)
    dt = time.time() - t0

    write_sdf([m.to_sdf_mol(title=f"byop_{j}") for j, m in enumerate(mols)], out_dir / "raw_ligands.sdf")
    write_pdb(data["rec_atoms"], out_dir / "pocket.pdb")
    if sampler.model.cfg.rec_encoder_type == "learned":
        kp_x, kp_mask = (v.cpu().numpy() for v in sampler.last_keypoints)
        write_xyz(kp_x[kp_mask], ["C"] * int(kp_mask.sum()), out_dir / "keypoints.xyz")
    if args.pocket_minimization:
        from kpdiff_tpu_torch.analysis.pocket_minimization import minimize_and_write

        rmsds = minimize_and_write(data["rec_pos"], mols, out_dir)
        mean_r = np.mean(rmsds) if rmsds else 0.0
        print(f"pocket minimization: {len(rmsds)} mols, mean RMSD {mean_r:.3f}", flush=True)
    print(f"{len(mols)} valid molecules in {dt:.1f}s -> {out_dir}", flush=True)
    return mols


if __name__ == "__main__":
    main()
