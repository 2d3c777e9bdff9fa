"""Programmatic sampling API of the port (kpdiff_tpu/serve.py:150-233).

    from kpdiff_tpu_torch.serve import KeypointSampler
    s = KeypointSampler.from_params("configs/egnn_40kp.yml",
                                    "artifacts/egnn_40kp_trained_params.npz", batch_size=64)
    mols = s.sample_for_arrays(rec_pos, rec_feat, rec_res_idx, init_com, n_mols=32, ligand_size=20)
    # -> list of (coords (n, 3), element symbols)

Each request is padded to the smallest ligand bucket that fits it, encoded
once, its static kk edges compacted with a grow-only cap, and sampled. Bond
perception, the PDB/SDF front end and ligand_size="random" are not ported
yet: a molecule comes back as coordinates and element symbols.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from kpdiff_tpu_torch.config import PaddingConfig, load_config, model_from_config, resolve_feature_sizes
from kpdiff_tpu_torch.data.padding import pad_item, to_complex
from kpdiff_tpu_torch.utils.params_io import load_params, read_keystr_npz


class KeypointSampler:
    def __init__(self, config: dict, model, batch_size: int = 64, seed: int = 0, sample_steps: int = 0,
                 eta: float = 1.0, lig_buckets: Optional[List[int]] = None):
        self.config = config
        self.model = model
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

    @classmethod
    def from_params(cls, config_path: str | Path, params_npz: Optional[str | Path], batch_size: int = 64,
                    device: str = "cuda", seed: int = 0, **kwargs) -> "KeypointSampler":
        """Model from `config_path` with weights from a keystr npz (the JAX
        package's export format); `params_npz=None` keeps the weights
        initialised from `seed`. Raises when CUDA is missing unless
        device='cpu'."""
        config = load_config(config_path)
        model = model_from_config(config, device=device, seed=seed)
        if params_npz is not None:
            load_params(model, read_keystr_npz(params_npz))
        model.eval()
        return cls(config, model, batch_size=batch_size, seed=seed, **kwargs)

    @torch.no_grad()
    def _run(self, cpx, init_com):
        """Encode, compact kk and sample under no_grad, so that every dense
        edge takes the CUDA kernel."""
        enc, kk = self.model.encode(cpx)
        kk = self.model.compact_kk(enc, kk, min_cap=self._kk_cap)
        if isinstance(kk, tuple):
            self._kk_cap = max(self._kk_cap, int(kk[0].shape[-1]))
        return self.model.sample(enc, kk, init_com=init_com, sample_steps=self.sample_steps,
                                 eta=self.eta, generator=self._gen)

    def sample_for_arrays(self, rec_pos: np.ndarray, rec_feat: np.ndarray,
                          rec_res_idx: Optional[np.ndarray] = None, init_com: Optional[np.ndarray] = None,
                          n_mols: int = 32, ligand_size: int = 20,
                          interface_points: Optional[np.ndarray] = None) -> List[Tuple[np.ndarray, List[str]]]:
        """Sample `n_mols` ligands of `ligand_size` atoms for one pocket.

        Returns one (coords (n, 3), element symbols) per molecule."""
        if isinstance(ligand_size, str):
            raise NotImplementedError("ligand_size='random'/'ref' is not ported yet; pass an int")
        n_rec = rec_pos.shape[0]
        if rec_res_idx is None:
            rec_res_idx = np.zeros(n_rec, np.int32)
        if interface_points is None:
            interface_points = np.zeros((0, 3), np.float32)
        size = int(np.clip(int(ligand_size), 2, self.pad.n_lig))

        out_mols: List[Tuple[np.ndarray, List[str]]] = []
        done = 0
        while done < n_mols:
            bs = min(self.batch_size, n_mols - done)
            bucket = next(b for b in self.lig_buckets if size <= b)
            pad_b = dataclasses.replace(self.pad, n_lig=bucket)
            item = dict(
                lig_pos=np.zeros((size, 3), np.float32),
                lig_feat=np.zeros((size, len(self.lig_elements)), np.float32),
                rec_pos=rec_pos.astype(np.float32), rec_feat=rec_feat.astype(np.float32),
                rec_res_idx=rec_res_idx.astype(np.int32), interface_points=interface_points.astype(np.float32),
            )
            padded = pad_item(item, pad_b, n_lig_feat_out=self.n_lig_feat)
            if padded is None:
                raise ValueError(f"pocket ({n_rec} atoms) exceeds padding capacity {self.pad.n_rec}")
            cpx = to_complex([padded] * bs, pad_b, self.model.cfg.rec_nf, device=self.device)
            com = None
            if init_com is not None:
                com = torch.as_tensor(np.broadcast_to(np.asarray(init_com, np.float32), (bs, 3)).copy(),
                                      device=self.device)
            out = self._run(cpx, com)
            lig_x, lig_h, lig_mask = (out[k].cpu().numpy() for k in ("lig_x", "lig_h", "lig_mask"))
            for b in range(bs):
                m = lig_mask[b]
                if m.sum() == 0:
                    continue
                feats = lig_h[b][m][:, : len(self.lig_elements)]
                out_mols.append((lig_x[b][m], [self.lig_elements[j] for j in feats.argmax(1)]))
            done += bs
        return out_mols
