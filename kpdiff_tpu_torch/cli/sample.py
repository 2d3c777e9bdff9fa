"""Evaluation sampler CLI (kpdiff_tpu/cli/sample.py; reference test.py +
sample.py).

Per test pocket: encode the receptor once, batch-replicate, run the reverse
diffusion on one CUDA card (`--device cpu` for the plain PyTorch path),
build molecules on the host, retry until samples_per_pocket valid
molecules or max_tries, and write the reference's output layout:

    output_dir/pocket_{i}/
        raw_ligands.sdf      # sampled molecules
        pocket.pdb           # pocket written from the processed arrays
        keypoints.xyz        # keypoint positions (learned encoders)
        sample_time.txt      # wall-clock seconds for this pocket
        sample_time.pkl
        trajectories/        # with --visualize: one SDF per sample

With `--n_devices N` the chain runs on N devices, one rank each
(parallel/): `--shard_mode data` gives each rank its rows of the batch
(rounded up to a multiple of N), `--shard_mode kp` its keypoint rows of
every pocket's batch (parallel/kp_shard.py). Outside a process group the
CLI starts its N ranks itself; under torchrun it uses the group. Rank 0
writes the outputs.

Usage:
    python -m kpdiff_tpu_torch.cli.sample --model_dir runs/<run>/ --out sampled_mols/
    python -m kpdiff_tpu_torch.cli.sample --model_dir ... --synthetic 4   # no dataset
"""
from __future__ import annotations

import argparse
import dataclasses
import pickle
import shutil
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_dir", type=str, required=True, help="port run dir: config.yml + checkpoints/step_N.pt")
    p.add_argument("--checkpoint_step", type=int, default=None)
    p.add_argument("--out", type=str, default="sampled_mols_out")
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--dataset_idx", type=int, default=None)
    p.add_argument("--dataset_size", type=int, default=None)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--samples_per_pocket", type=int, default=100)
    p.add_argument("--max_batch_size", type=int, default=128)
    p.add_argument("--n_devices", type=int, default=1, help="devices (ranks); 0 = every visible device")
    p.add_argument("--shard_mode", choices=["data", "kp"], default="data",
                   help="data: split the batch over the devices; kp: split the keypoints (parallel/kp_shard.py)")
    p.add_argument("--max_tries", type=int, default=3)
    p.add_argument("--avg_validity", type=float, default=0.85)
    p.add_argument("--use_ref_lig_com", action="store_true")
    p.add_argument("--ligand_size", type=str, default="ref",
                   help="'ref' (reference ligand count), 'random' (joint size distribution) or an int")
    p.add_argument("--sample_steps", type=int, default=0,
                   help="strided sampling with K < n_timesteps ancestral steps; 0 = the full chain")
    p.add_argument("--eta", type=float, default=1.0,
                   help="DDIM noise scale: 1.0 = the ancestral chain; 0.0 = deterministic DDIM")
    p.add_argument("--pocket_minimization", action="store_true",
                   help="relax each pocket's sampled ligands in place and write "
                        "pocket_minimized_ligands.sdf + pocket_min_rmsds.csv per pocket")
    p.add_argument("--ligand_only_minimization", action="store_true",
                   help="relax each sampled ligand without the pocket and write minimized_ligands.sdf per pocket")
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--frames_every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default; raises without CUDA) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from kpdiff_tpu_torch.device import resolve_device
    from kpdiff_tpu_torch.parallel import distributed as pdist

    dev = resolve_device(args.device)
    if not pdist.join_launcher_group(args.device):
        n = pdist.resolve_n_devices(args.n_devices, dev)
        if n > 1:
            pdist.spawn(_rank_main, n, args=(args,), device=args.device)
            return
    _sample(args)


def _rank_main(rank, args):
    _sample(args)


def _sample(args):
    import torch

    from kpdiff_tpu_torch.parallel import distributed as pdist
    from kpdiff_tpu_torch.parallel.kp_shard import data_shard, shard_encoded
    from kpdiff_tpu_torch.parallel.mesh import gather_batch, make_mesh, padded_batch, shard_batch

    from kpdiff_tpu_torch.analysis.molecule_builder import build_molecule
    from kpdiff_tpu_torch.config import PaddingConfig, resolve_feature_sizes
    from kpdiff_tpu_torch.data.dataset import ComplexDataset, resolve_lig_buckets, synthetic_dataset
    from kpdiff_tpu_torch.data.padding import pad_item, to_complex
    from kpdiff_tpu_torch.data.pdb import write_xyz
    from kpdiff_tpu_torch.data.sdf import write_sdf
    from kpdiff_tpu_torch.serve import load_run_model

    mesh = None
    if pdist.in_group():
        if args.n_devices not in (0, pdist.world_size()):
            raise ValueError(f"--n_devices {args.n_devices} inside a group of {pdist.world_size()} ranks")
        mesh = make_mesh(pdist.world_size(), ("model" if args.shard_mode == "kp" else "data",), device=args.device)
    writer = pdist.rank() == 0
    config, model = load_run_model(args.model_dir, args.checkpoint_step,
                                   device=mesh.device if mesh else args.device)
    dev = next(model.parameters()).device
    pad = PaddingConfig.from_config(config)
    n_rec_feat, n_lig_feat, _ = resolve_feature_sizes(config)
    lig_elements = config["dataset"]["lig_elements"]

    if args.synthetic:
        ds = synthetic_dataset(args.synthetic, seed=args.seed + 100, n_rec_feat=n_rec_feat,
                               n_lig_feat=len(lig_elements), rec_range=(min(24, pad.n_rec // 2), pad.n_rec),
                               lig_range=(min(8, max(pad.n_lig // 2, 2)), pad.n_lig))
    else:
        ds = ComplexDataset.from_pickle(Path(config["dataset"]["location"]) / f"{args.split}.pkl")

    out_root = Path(args.out)
    if writer:
        out_root.mkdir(parents=True, exist_ok=True)
    batch = args.max_batch_size
    data_par = mesh is not None and args.shard_mode == "data"
    if data_par:
        batch = padded_batch(batch, mesh.n_devices)
    idxs = [args.dataset_idx] if args.dataset_idx is not None else range(min(len(ds), args.dataset_size or len(ds)))

    size_dist = None
    if args.ligand_size == "random":
        from kpdiff_tpu_torch.models.size_dist import LigandSizeDistribution

        size_dist = LigandSizeDistribution(Path(config["dataset"]["location"]))
    rng_np = np.random.default_rng(args.seed + 1)
    # each pocket's batch is padded to the smallest bucket that fits its largest requested ligand
    buckets = resolve_lig_buckets(config, ds, pad.n_lig) or [pad.n_lig]
    generator = torch.Generator(device=dev).manual_seed(args.seed)

    for i in idxs:
        t0 = time.time()
        item = ds.get(int(i))
        if args.ligand_size == "ref":
            sizes = [item["lig_pos"].shape[0]] * batch
        elif args.ligand_size == "random":
            sizes = size_dist.sample(np.array([item["rec_pos"].shape[0]]), batch, rng_np)[0]
        else:
            sizes = [int(args.ligand_size)] * batch
        sizes = np.clip(np.asarray(sizes), 2, pad.n_lig)
        bucket = next(b for b in buckets if int(sizes.max()) <= b)
        pad_i = dataclasses.replace(pad, n_lig=bucket)

        items = []
        for n in sizes:
            it = dict(item)
            it["lig_pos"] = np.zeros((int(n), 3), np.float32)
            it["lig_feat"] = np.zeros((int(n), item["lig_feat"].shape[1]), np.float32)
            padded = pad_item(it, pad_i, n_lig_feat_out=n_lig_feat)
            if padded is None:
                break
            items.append(padded)
        if len(items) < batch:
            print(f"pocket {i}: exceeds padding capacity, skipped", flush=True)
            continue
        cpx = to_complex(items, pad_i, model.cfg.rec_nf, model.kp_vec_dim, device=dev)
        init_com = None
        if args.use_ref_lig_com:
            init_com = torch.as_tensor(np.broadcast_to(item["lig_pos"].mean(0), (batch, 3)).astype(np.float32),
                                       device=dev)

        # encode once per pocket (reference test.py:164) and compact the static kk edges,
        # under no_grad so that every dense edge takes the CUDA kernel; every rank
        # builds the same batch and takes its part
        shard = None
        with torch.no_grad():
            if data_par:
                cpx, init_com = shard_batch(cpx, mesh), shard_batch(init_com, mesh)
                shard = data_shard(mesh, batch)
            enc, kk = model.encode(cpx)
            kk = model.compact_kk(enc, kk)
            enc_s, kk_s = enc, kk
            if mesh is not None and not data_par:
                enc_s, kk_s, shard = shard_encoded(enc, kk, mesh, axis="model")
        mols = []
        n_tries = 0
        while len(mols) < args.samples_per_pocket and n_tries < args.max_tries:
            n_tries += 1
            out = model.sample(enc_s, kk_s, init_com=init_com,
                               return_every=args.frames_every if args.visualize else 0,
                               sample_steps=args.sample_steps, eta=args.eta, generator=generator, kp_shard=shard)
            if data_par:  # every rank gets the whole batch, so that all take the same retry decision
                out = {k: gather_batch(v, mesh, dim=1 if k.startswith("frames") else 0) for k, v in out.items()}
            out = {k: v.cpu().numpy() for k, v in out.items()}
            lig_x, lig_h, lig_mask = out["lig_x"], out["lig_h"], out["lig_mask"]
            for b in range(batch):
                m = lig_mask[b]
                if m.sum() == 0:
                    continue
                feats = lig_h[b][m][:, : len(lig_elements)]
                elements = [lig_elements[j] for j in feats.argmax(1)]
                mol = build_molecule(lig_x[b][m], elements, largest_frag=True, sanitize=True)
                if mol is not None:
                    mols.append(mol)
                    if writer and args.visualize and "frames_x" in out and len(mols) <= 10:
                        _write_frames(out, b, m, lig_elements, out_root / f"pocket_{i}" / "trajectories", len(mols))
                if len(mols) >= args.samples_per_pocket:
                    break

        dt = time.time() - t0
        if not writer:
            continue
        pdir = out_root / f"pocket_{i}"
        pdir.mkdir(parents=True, exist_ok=True)
        write_sdf([m.to_sdf_mol(title=f"pocket{i}_sample{j}") for j, m in enumerate(mols)], pdir / "raw_ligands.sdf")
        _write_pocket_pdb(item, pdir / "pocket.pdb")
        if args.ligand_only_minimization:
            from kpdiff_tpu_torch.analysis.pocket_minimization import pocket_minimization

            lo_mols, _ = pocket_minimization(np.zeros((0, 3), np.float32), mols, n_iters=200)
            write_sdf([m.to_sdf_mol(title=f"lomin_{j}") for j, m in enumerate(lo_mols)],
                      pdir / "minimized_ligands.sdf")
        if args.pocket_minimization:
            from kpdiff_tpu_torch.analysis.pocket_minimization import minimize_and_write

            rmsds = minimize_and_write(item["rec_pos"], mols, pdir)
            mean_r = np.mean(rmsds) if rmsds else 0.0
            print(f"pocket {i}: minimized {len(rmsds)} mols, mean RMSD {mean_r:.3f}", flush=True)
        # copy the original receptor/ligand files when the split names them (reference test.py)
        rec_file, lig_file = ds.get_files(int(i)) if hasattr(ds, "get_files") else (None, None)
        if rec_file and Path(rec_file).exists():
            ref_dir = pdir / "reference_files"
            ref_dir.mkdir(exist_ok=True)
            shutil.copy(rec_file, pdir / "receptor.pdb")
            shutil.copy(rec_file, ref_dir / Path(rec_file).name)
            if lig_file and Path(str(lig_file)).exists():
                shutil.copy(lig_file, ref_dir / Path(lig_file).name)
        if model.cfg.rec_encoder_type == "learned":
            kx, km = enc.kp_x[0].cpu().numpy(), enc.kp_mask[0].cpu().numpy()
            write_xyz(kx[km], ["C"] * int(km.sum()), pdir / "keypoints.xyz")
        (pdir / "sample_time.txt").write_text(f"{dt}\n")
        with open(pdir / "sample_time.pkl", "wb") as f:
            pickle.dump({"time": dt, "n_valid": len(mols), "n_tries": n_tries, "batch": batch}, f)
        print(f"pocket {i}: {len(mols)}/{args.samples_per_pocket} valid in {n_tries} tries, "
              f"{dt:.1f}s ({dt / max(len(mols), 1):.3f} s/mol)", flush=True)


def _write_pocket_pdb(item, path):
    """Write pocket atoms as a PDB from processed arrays (the original file
    is unavailable at sampling time for pickle-only datasets)."""
    with open(path, "w") as f:
        for j, (x, y, z) in enumerate(item["rec_pos"]):
            res = int(item["rec_res_idx"][j]) % 10000
            f.write(f"ATOM  {j + 1:5d}  X   UNK A{res:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00           C\n")
        f.write("END\n")


def _write_frames(out, b, mask, lig_elements, traj_dir, sample_idx):
    from kpdiff_tpu_torch.data.sdf import SdfMol, write_sdf

    traj_dir.mkdir(parents=True, exist_ok=True)
    fx = np.asarray(out["frames_x"])[:, b]
    fh = np.asarray(out["frames_h"])[:, b]
    mols = []
    for t in range(fx.shape[0]):
        feats = fh[t][mask][:, : len(lig_elements)]
        elements = [lig_elements[j] for j in feats.argmax(1)]
        mols.append(SdfMol(title=f"frame{t}", elements=elements, coords=fx[t][mask], bonds=[]))
    write_sdf(mols, traj_dir / f"sample_{sample_idx}_traj.sdf")


if __name__ == "__main__":
    main()
