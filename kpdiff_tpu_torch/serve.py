"""Programmatic sampling API of the port (kpdiff_tpu/serve.py): load a trained
run once, sample many pockets.

    from kpdiff_tpu_torch.serve import KeypointSampler
    s = KeypointSampler("runs/egnn_40kp_.../", batch_size=64)   # config.yml + checkpoints/step_N.pt
    mols = s.sample_for_pocket("prot.pdb", "ref_ligand.sdf", n_mols=100)
    # -> list of BuiltMolecule (positions, elements, perceived bonds)
    s = KeypointSampler.from_params("configs/egnn_40kp.yml", "artifacts/egnn_40kp_trained_params.npz")

Each request's ligand sizes ("random" from the run's size histogram, "ref"
from the reference ligand, or an int) are sorted in descending order and
sampled in chunks of at most `batch_size`; each chunk is padded to the
smallest ligand bucket that fits its largest ligand, encoded once, its
static kk edges compacted with a grow-only cap, and sampled under no_grad
(so every dense edge takes the CUDA kernel). Bond perception runs on the
way out and molecules that fail to build are dropped.

Known difference from the JAX sampler: a chunk holds only the molecules it
samples, where the JAX one repeat-pads every chunk to `batch_size` to reuse
one compiled executable.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from kpdiff_tpu_torch.analysis.molecule_builder import BuiltMolecule, build_molecule
from kpdiff_tpu_torch.config import PaddingConfig, load_config, model_from_config, resolve_feature_sizes
from kpdiff_tpu_torch.data.padding import pad_item, to_complex
from kpdiff_tpu_torch.device import resolve_device
from kpdiff_tpu_torch.utils.params_io import load_params, read_keystr_npz


def check_parallelism(n_devices: int = 1, kp_shard_devices: int = 0, shard_mode: str = "data") -> None:
    """The port samples on one device: anything else raises."""
    if n_devices != 1 or kp_shard_devices not in (0, 1) or shard_mode != "data":
        raise NotImplementedError(
            f"n_devices={n_devices} kp_shard_devices={kp_shard_devices} shard_mode={shard_mode!r}: multi-device "
            "sampling (data parallel, keypoint sharding) is not ported yet; pass 1, 0 and 'data'")


def decode_ligands(out, lig_elements: List[str]):
    """Sampler outputs -> [(coords (n, 3), element symbols)] of the rows with
    atoms, on the host."""
    lig_x, lig_h, lig_mask = (out[k].cpu().numpy() for k in ("lig_x", "lig_h", "lig_mask"))
    ligands = []
    for b in range(lig_x.shape[0]):
        m = lig_mask[b]
        if m.sum() == 0:
            continue
        feats = lig_h[b][m][:, : len(lig_elements)]
        ligands.append((lig_x[b][m], [lig_elements[j] for j in feats.argmax(1)]))
    return ligands


def load_run_model(model_dir: str | Path, checkpoint_step: Optional[int] = None, device: str = "cuda",
                   seed: int = 0):
    """(config, model in eval mode) of a port run directory: config.yml and
    checkpoints/step_N.pt (the newest without `checkpoint_step`)."""
    from kpdiff_tpu_torch.training.trainer import read_checkpoint

    dev = resolve_device(device)
    model_dir = Path(model_dir)
    config = load_config(model_dir / "config.yml")
    model = model_from_config(config, device=dev, seed=seed)
    ckpt = read_checkpoint(model_dir / "checkpoints", checkpoint_step)
    load_params(model, {n: v.numpy() for n, v in ckpt["params"].items()})
    model.eval()
    return config, model


class KeypointSampler:
    def __init__(self, model_dir: str | Path, checkpoint_step: Optional[int] = None, batch_size: int = 64,
                 seed: int = 0, sample_steps: int = 0, eta: float = 1.0, lig_buckets: Optional[List[int]] = None,
                 kp_shard_devices: int = 0, device: str = "cuda"):
        """A port run directory (what `cli/train.py` writes). sample_steps:
        strided sampling with K < n_timesteps steps, 0 = the full chain; eta:
        DDIM noise scale, 1.0 = the ancestral chain; lig_buckets: ascending
        ligand padding buckets ending at padding.n_lig (None: the config's
        explicit list, else multiples of 8). Raises when CUDA is missing
        unless device='cpu'."""
        check_parallelism(kp_shard_devices=kp_shard_devices)
        config, model = load_run_model(model_dir, checkpoint_step, device=device, seed=seed)
        self._setup(config, model, Path(model_dir), batch_size, seed, sample_steps, eta, lig_buckets)

    @classmethod
    def from_params(cls, config_path: str | Path, params_npz: Optional[str | Path], batch_size: int = 64,
                    device: str = "cuda", seed: int = 0, sample_steps: int = 0, eta: float = 1.0,
                    lig_buckets: Optional[List[int]] = None) -> "KeypointSampler":
        """Model from `config_path` with weights from a keystr npz (the JAX
        package's export format); `params_npz=None` keeps the weights
        initialised from `seed`. Raises when CUDA is missing unless
        device='cpu'."""
        config = load_config(config_path)
        model = model_from_config(config, device=device, seed=seed)
        if params_npz is not None:
            load_params(model, read_keystr_npz(params_npz))
        model.eval()
        self = cls.__new__(cls)
        self._setup(config, model, Path(config_path).parent, batch_size, seed, sample_steps, eta, lig_buckets)
        return self

    def _setup(self, config, model, model_dir, batch_size, seed, sample_steps, eta, lig_buckets):
        self.config = config
        self.model = model
        self.model_dir = model_dir
        self.device = next(model.parameters()).device
        self.pad = PaddingConfig.from_config(config)
        self.n_rec_feat, self.n_lig_feat, _ = resolve_feature_sizes(config)
        self.lig_elements = config["dataset"]["lig_elements"]
        self.batch_size = batch_size
        self.sample_steps, self.eta = sample_steps, eta
        if lig_buckets is None:
            cfg_buckets = config.get("padding", {}).get("lig_buckets")
            if isinstance(cfg_buckets, (list, tuple)) and cfg_buckets:
                lig_buckets = sorted(int(b) for b in cfg_buckets)
            else:  # 'auto'/absent: no size histogram at serving time -> multiples of 8
                lig_buckets = list(range(8, self.pad.n_lig + 1, 8))
                if not lig_buckets or lig_buckets[-1] != self.pad.n_lig:
                    lig_buckets.append(self.pad.n_lig)
        if lig_buckets[-1] != self.pad.n_lig:
            raise ValueError(f"largest lig bucket {lig_buckets[-1]} must equal padding.n_lig {self.pad.n_lig}")
        self.lig_buckets = lig_buckets
        self._kk_cap = 0  # grow-only kk neighbor-list cap
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._np_rng = np.random.default_rng(seed)
        self._size_dist = None
        self.last_request = {}  # host and device seconds of the newest request, by part
        self.last_keypoints = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def _run(self, cpx, init_com):
        """Encode, compact kk and sample under no_grad, so that every dense
        edge takes the CUDA kernel. Returns the outputs and the kk layout."""
        enc, kk = self.model.encode(cpx)
        self.last_keypoints = (enc.kp_x[0], enc.kp_mask[0])  # the pocket's keypoints, for keypoints.xyz
        kk = self.model.compact_kk(enc, kk, min_cap=self._kk_cap)
        if isinstance(kk, tuple):
            self._kk_cap = max(self._kk_cap, int(kk[0].shape[-1]))
        out = self.model.sample(enc, kk, init_com=init_com, sample_steps=self.sample_steps, eta=self.eta,
                                generator=self._gen)
        return out, (f"nbr{int(kk[0].shape[-1])}" if isinstance(kk, tuple) else "dense")

    # ------------------------------------------------------------------ API

    def sample_for_pocket(self, receptor_file: str | Path, ref_ligand_file: str | Path, n_mols: int = 32,
                          ligand_size: str | int = "random") -> List[BuiltMolecule]:
        """Receptor PDB/mmCIF + reference-ligand SDF -> valid molecules (the
        BYOP pipeline)."""
        from kpdiff_tpu_torch.cli.byop import process_ligand_and_pocket

        t0 = time.perf_counter()
        data = process_ligand_and_pocket(str(receptor_file), str(ref_ligand_file), self.config)
        parse_s = time.perf_counter() - t0
        mols = self.sample_for_arrays(
            rec_pos=data["rec_pos"], rec_feat=data["rec_feat"], rec_res_idx=data["rec_res_idx"],
            interface_points=data["interface_points"], init_com=data["lig_pos"].mean(0),
            ref_n_atoms=data["lig_pos"].shape[0], n_mols=n_mols, ligand_size=ligand_size)
        self.last_request["parse_pocket_s"] = parse_s
        self.last_request["pocket_atoms"] = int(data["rec_pos"].shape[0])
        return mols

    def _sizes(self, n_rec: int, n_mols: int, ligand_size, ref_n_atoms) -> np.ndarray:
        if ligand_size == "random":
            from kpdiff_tpu_torch.models.size_dist import LigandSizeDistribution

            if self._size_dist is None:
                self._size_dist = LigandSizeDistribution(Path(self.config["dataset"]["location"]))
            sizes = self._size_dist.sample(np.array([n_rec]), n_mols, self._np_rng)[0]
        elif ligand_size == "ref":
            if ref_n_atoms is None:
                raise ValueError("ligand_size='ref' needs ref_n_atoms")
            sizes = np.full(n_mols, int(ref_n_atoms))
        else:
            sizes = np.full(n_mols, int(ligand_size))
        return np.clip(sizes, 2, self.pad.n_lig)

    def sample_for_arrays(self, rec_pos: np.ndarray, rec_feat: np.ndarray, rec_res_idx: Optional[np.ndarray] = None,
                          interface_points: Optional[np.ndarray] = None, init_com: Optional[np.ndarray] = None,
                          ref_n_atoms: Optional[int] = None, n_mols: int = 32,
                          ligand_size: str | int = "random") -> List[BuiltMolecule]:
        """Sample `n_mols` ligands for one featurized pocket; returns the
        molecules that build (bonds perceived, largest fragment, valence
        checked)."""
        t0 = time.perf_counter()
        n_rec = rec_pos.shape[0]
        if rec_res_idx is None:
            rec_res_idx = np.zeros(n_rec, np.int32)
        if interface_points is None:
            interface_points = np.zeros((0, 3), np.float32)
        # larger ligands first, so that each chunk's bucket is as tight as possible
        sizes = np.sort(self._sizes(n_rec, n_mols, ligand_size, ref_n_atoms))[::-1]
        stats = dict(front_end_s=time.perf_counter() - t0, sample_s=0.0, copy_s=0.0, build_s=0.0, chunks=[],
                     sample_steps=self.sample_steps)

        mols: List[BuiltMolecule] = []
        done = 0
        while done < n_mols:
            t0 = time.perf_counter()
            bs = min(self.batch_size, n_mols - done)
            chunk = sizes[done: done + bs]
            bucket = next(b for b in self.lig_buckets if int(chunk.max()) <= b)
            pad_b = dataclasses.replace(self.pad, n_lig=bucket)
            items = []
            for n in chunk:
                item = dict(
                    lig_pos=np.zeros((int(n), 3), np.float32),
                    lig_feat=np.zeros((int(n), len(self.lig_elements)), np.float32),
                    rec_pos=rec_pos.astype(np.float32), rec_feat=rec_feat.astype(np.float32),
                    rec_res_idx=rec_res_idx.astype(np.int32), interface_points=interface_points.astype(np.float32),
                )
                padded = pad_item(item, pad_b, n_lig_feat_out=self.n_lig_feat)
                if padded is None:
                    raise ValueError(f"pocket ({n_rec} atoms) exceeds padding capacity {self.pad.n_rec}")
                items.append(padded)
            cpx = to_complex(items, pad_b, self.model.cfg.rec_nf, self.model.kp_vec_dim, device=self.device)
            com = None
            if init_com is not None:
                com = torch.as_tensor(np.broadcast_to(np.asarray(init_com, np.float32), (bs, 3)).copy(),
                                      device=self.device)
            t1 = time.perf_counter()
            out, layout = self._run(cpx, com)
            self._sync()
            t2 = time.perf_counter()
            ligands = decode_ligands(out, self.lig_elements)
            t3 = time.perf_counter()
            for coords, elements in ligands:
                mol = build_molecule(coords, elements)
                if mol is not None:
                    mols.append(mol)
            t4 = time.perf_counter()
            stats["front_end_s"] += t1 - t0
            stats["sample_s"] += t2 - t1
            stats["copy_s"] += t3 - t2
            stats["build_s"] += t4 - t3
            stats["chunks"].append(dict(batch=bs, bucket=bucket, kk=layout, sizes=[int(s) for s in chunk]))
            done += bs
        self.last_request = stats
        return mols
