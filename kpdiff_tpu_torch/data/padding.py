"""Padding of ragged complexes and their collation into a PaddedComplex.

`pad_item` is a copy of kpdiff_tpu/data/dataset.py::pad_item and
`to_complex` of the collation in kpdiff_tpu/cli/sample.py::_to_complex;
the port keeps its own copies so that it imports nothing of the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from kpdiff_tpu_torch.config import PaddingConfig
from kpdiff_tpu_torch.models.complex import PaddedComplex, make_complex


def pad_item(
    item: Dict[str, np.ndarray],
    pad: PaddingConfig,
    max_fake_atom_frac: float = 0.0,
    rng: Optional[np.random.Generator] = None,
    n_lig_feat_out: Optional[int] = None,
) -> Optional[Dict[str, np.ndarray]]:
    """One ragged complex -> padded arrays (None if it exceeds capacity)."""
    n_lig = item["lig_pos"].shape[0]
    n_rec = item["rec_pos"].shape[0]
    n_ip = item["interface_points"].shape[0]
    lig_pos, lig_feat = item["lig_pos"], item["lig_feat"]

    if max_fake_atom_frac > 0:
        if rng is None:
            raise ValueError("fake atoms need an rng")
        lig_feat = np.concatenate([lig_feat, np.zeros((n_lig, 1), lig_feat.dtype)], axis=1)
        n_fake = int(rng.integers(0, math.ceil(max_fake_atom_frac * n_lig) + 1))
        if n_fake:
            lo, hi = lig_pos.min(0, keepdims=True), lig_pos.max(0, keepdims=True)
            fake_pos = rng.random((n_fake, 3)).astype(np.float32) * (hi - lo) + lo
            fake_feat = np.zeros((n_fake, lig_feat.shape[1]), lig_feat.dtype)
            fake_feat[:, -1] = 1
            lig_pos = np.concatenate([lig_pos, fake_pos], axis=0)
            lig_feat = np.concatenate([lig_feat, fake_feat], axis=0)
            n_lig += n_fake

    if n_lig > pad.n_lig or n_rec > pad.n_rec or n_ip > pad.n_ip:
        return None
    f_lig = n_lig_feat_out or lig_feat.shape[1]

    def padded(a, n, feat=None):
        out = np.zeros((n, feat if feat is not None else a.shape[1]), np.float32)
        out[: a.shape[0], : a.shape[1]] = a
        return out

    return dict(
        lig_x=padded(lig_pos, pad.n_lig),
        lig_h=padded(lig_feat, pad.n_lig, f_lig),
        lig_mask=np.arange(pad.n_lig) < n_lig,
        rec_x=padded(item["rec_pos"], pad.n_rec),
        rec_h=padded(item["rec_feat"], pad.n_rec),
        rec_mask=np.arange(pad.n_rec) < n_rec,
        rec_res_idx=np.pad(item["rec_res_idx"], (0, pad.n_rec - n_rec)).astype(np.int32),
        ip_x=padded(item["interface_points"], pad.n_ip),
        ip_mask=np.arange(pad.n_ip) < n_ip,
    )


def to_complex(items: List[Dict[str, np.ndarray]], pad: PaddingConfig, kp_feat_dim: int,
               kp_vec_dim: Optional[int] = None, device="cpu") -> PaddedComplex:
    """Stack padded items into a PaddedComplex on `device` (a zero kp_v of
    kp_vec_dim channels for GVP models)."""
    st = {k: np.stack([it[k] for it in items]) for k in items[0]}
    return make_complex(st["rec_x"], st["rec_h"], st["rec_mask"], st["lig_x"], st["lig_h"], st["lig_mask"],
                        n_kp=pad.n_kp, kp_feat_dim=kp_feat_dim, kp_vec_dim=kp_vec_dim, rec_res_idx=st["rec_res_idx"],
                        ip_x=st["ip_x"], ip_mask=st["ip_mask"], device=device)
