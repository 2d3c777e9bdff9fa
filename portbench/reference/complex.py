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
