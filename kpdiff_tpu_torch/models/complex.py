"""PaddedComplex as a dataclass of tensors (kpdiff_tpu/models/complex.py).

All tensors carry a batch dim B and static per-type node capacities;
validity is tracked with boolean masks. The synthetic generators are
copies of the JAX package's numpy code, seeded the same way, so both
packages get identical inputs from one seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class PaddedComplex:
    rec_x: torch.Tensor  # (B, Nr, 3) f32
    rec_h: torch.Tensor  # (B, Nr, Fr)
    rec_mask: torch.Tensor  # (B, Nr) bool
    rec_res_idx: torch.Tensor  # (B, Nr) int32
    lig_x: torch.Tensor  # (B, Nl, 3)
    lig_h: torch.Tensor  # (B, Nl, Fl)
    lig_mask: torch.Tensor  # (B, Nl) bool
    kp_x: torch.Tensor  # (B, K, 3)
    kp_h: torch.Tensor  # (B, K, Dk)
    kp_mask: torch.Tensor  # (B, K) bool
    kp_v: Optional[torch.Tensor] = None  # (B, K, V, 3) for GVP models
    ip_x: Optional[torch.Tensor] = None  # (B, P, 3)
    ip_mask: Optional[torch.Tensor] = None  # (B, P) bool

    @property
    def batch_size(self) -> int:
        return self.lig_x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rec_x.device

    def replace(self, **changes) -> "PaddedComplex":
        return dataclasses.replace(self, **changes)

    def to(self, device, non_blocking: bool = False) -> "PaddedComplex":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device, non_blocking=non_blocking)
            for f in dataclasses.fields(self) if getattr(self, f.name) is not None})


def make_complex(rec_x, rec_h, rec_mask, lig_x, lig_h, lig_mask, n_kp: int, kp_feat_dim: int,
                 kp_vec_dim: Optional[int] = None, rec_res_idx=None, ip_x=None, ip_mask=None,
                 device="cpu") -> PaddedComplex:
    """Numpy (or tensor) arrays -> PaddedComplex on `device`, keypoints empty
    (with a zero kp_v of kp_vec_dim channels for GVP models)."""

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    b = np.shape(rec_x)[0]
    if rec_res_idx is None:
        rec_res_idx = np.zeros(np.shape(rec_x)[:2], np.int32)
    f32 = torch.float32
    return PaddedComplex(
        rec_x=t(rec_x, f32), rec_h=t(rec_h, f32), rec_mask=t(rec_mask, torch.bool),
        rec_res_idx=t(rec_res_idx, torch.int32),
        lig_x=t(lig_x, f32), lig_h=t(lig_h, f32), lig_mask=t(lig_mask, torch.bool),
        kp_x=torch.zeros((b, n_kp, 3), dtype=f32, device=device),
        kp_h=torch.zeros((b, n_kp, kp_feat_dim), dtype=f32, device=device),
        kp_mask=torch.zeros((b, n_kp), dtype=torch.bool, device=device),
        kp_v=None if kp_vec_dim is None else torch.zeros((b, n_kp, kp_vec_dim, 3), dtype=f32, device=device),
        ip_x=None if ip_x is None else t(ip_x, f32),
        ip_mask=None if ip_mask is None else t(ip_mask, torch.bool),
    )


def synthetic_complex_np(
    rng: np.random.Generator,
    n_rec: int,
    n_lig: int,
    n_rec_pad: int,
    n_lig_pad: int,
    n_rec_feat: int = 10,
    n_lig_feat: int = 10,
    n_ip_pad: int = 0,
):
    """One synthetic pocket/ligand pair as padded numpy arrays; a copy of
    kpdiff_tpu/models/complex.py::synthetic_complex_np with its default
    Poisson shell (same draws)."""
    lig_x = rng.normal(size=(n_lig, 3)) * 2.0
    # pocket atoms on a shell of radius ~6-10 A around the ligand COM
    dirs = rng.normal(size=(n_rec, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rad = rng.uniform(5.0, 10.0, size=(n_rec, 1))
    rec_x = lig_x.mean(0, keepdims=True) + dirs * rad + rng.normal(size=(n_rec, 3)) * 0.5

    def onehot(n, f):
        idx = rng.integers(0, f, size=n)
        out = np.zeros((n, f), np.float32)
        out[np.arange(n), idx] = 1
        return out

    rec_xp = np.zeros((n_rec_pad, 3), np.float32)
    rec_xp[:n_rec] = rec_x
    rec_hp = np.zeros((n_rec_pad, n_rec_feat), np.float32)
    rec_hp[:n_rec] = onehot(n_rec, n_rec_feat)
    rec_mask = np.zeros(n_rec_pad, bool)
    rec_mask[:n_rec] = True
    res_idx = np.zeros(n_rec_pad, np.int32)
    res_idx[:n_rec] = np.sort(rng.integers(0, max(n_rec // 4, 1), size=n_rec))

    lig_xp = np.zeros((n_lig_pad, 3), np.float32)
    lig_xp[:n_lig] = lig_x
    lig_hp = np.zeros((n_lig_pad, n_lig_feat), np.float32)
    lig_hp[:n_lig] = onehot(n_lig, n_lig_feat)
    lig_mask = np.zeros(n_lig_pad, bool)
    lig_mask[:n_lig] = True

    out = dict(
        rec_x=rec_xp, rec_h=rec_hp, rec_mask=rec_mask, rec_res_idx=res_idx,
        lig_x=lig_xp, lig_h=lig_hp, lig_mask=lig_mask,
    )
    if n_ip_pad:
        n_ip = min(max(n_lig // 2, 2), n_ip_pad)
        ip = np.zeros((n_ip_pad, 3), np.float32)
        li = rng.integers(0, n_lig, size=n_ip)
        d = np.linalg.norm(rec_x[None] - lig_x[li][:, None], axis=-1)
        ri = d.argmin(1)
        ip[:n_ip] = (lig_x[li] + rec_x[ri]) / 2
        ipm = np.zeros(n_ip_pad, bool)
        ipm[:n_ip] = True
        out.update(ip_x=ip, ip_mask=ipm)
    return out


def synthetic_batch(
    seed: int,
    batch: int,
    n_rec_pad: int = 96,
    n_lig_pad: int = 24,
    n_rec_feat: int = 10,
    n_lig_feat: int = 10,
    n_kp: int = 8,
    kp_feat_dim: int = 32,
    kp_vec_dim: Optional[int] = None,
    n_ip_pad: int = 16,
    min_rec: int = 24,
    min_lig: int = 8,
    device="cpu",
) -> PaddedComplex:
    """Copy of kpdiff_tpu/models/complex.py::synthetic_batch (same draws)."""
    rng = np.random.default_rng(seed)
    min_rec = min(min_rec, n_rec_pad)
    min_lig = min(min_lig, n_lig_pad)
    items = []
    for _ in range(batch):
        n_rec = int(rng.integers(min_rec, n_rec_pad + 1))
        n_lig = int(rng.integers(min_lig, n_lig_pad + 1))
        items.append(synthetic_complex_np(rng, n_rec, n_lig, n_rec_pad, n_lig_pad, n_rec_feat,
                                          n_lig_feat, n_ip_pad))
    stacked = {k: np.stack([it[k] for it in items]) for k in items[0]}
    return make_complex(
        stacked["rec_x"], stacked["rec_h"], stacked["rec_mask"],
        stacked["lig_x"], stacked["lig_h"], stacked["lig_mask"],
        n_kp=n_kp, kp_feat_dim=kp_feat_dim, kp_vec_dim=kp_vec_dim, rec_res_idx=stacked["rec_res_idx"],
        ip_x=stacked.get("ip_x"), ip_mask=stacked.get("ip_mask"), device=device,
    )
