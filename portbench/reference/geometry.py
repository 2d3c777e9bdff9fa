"""Masked geometry primitives over padded (B, N, ...) tensors
(kpdiff_tpu/ops/geometry.py)."""
from __future__ import annotations

import torch

__all__ = ["masked_mean", "masked_com", "norm_no_nan", "rbf_embed"]


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int, keepdim: bool = False,
                eps: float = 0.0) -> torch.Tensor:
    """Mean of `x` over `dim` counting only entries where `mask` is true;
    entirely-masked rows return 0 (denominator clamped to >= 1)."""
    mask = mask.to(x.dtype)
    while mask.dim() < x.dim():
        mask = mask[..., None]
    total = torch.sum(x * mask, dim=dim, keepdim=keepdim)
    count = torch.sum(mask, dim=dim, keepdim=keepdim)
    return total / torch.clamp(count, min=1.0 + eps)


def masked_com(pos: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Center of mass of (B, N, 3) positions under a (B, N) mask -> (B, 3)."""
    return masked_mean(pos, mask, dim=1)


def norm_no_nan(x: torch.Tensor, dim: int = -1, keepdim: bool = False, eps: float = 1e-8,
                sqrt: bool = True) -> torch.Tensor:
    """L2 norm with the squared norm clamped above eps before the sqrt."""
    out = torch.clamp(torch.sum(torch.square(x), dim=dim, keepdim=keepdim), min=eps)
    return torch.sqrt(out) if sqrt else out


def rbf_embed(d: torch.Tensor, d_min: float = 0.0, d_max: float = 20.0, d_count: int = 16) -> torch.Tensor:
    """Gaussian radial-basis embedding of distances along a new last axis:
    centres linspace(d_min, d_max, d_count), width (d_max - d_min) / d_count."""
    mu = torch.linspace(d_min, d_max, d_count, dtype=d.dtype, device=d.device)
    sigma = (d_max - d_min) / d_count
    return torch.exp(-torch.square((d[..., None] - mu) / sigma))
