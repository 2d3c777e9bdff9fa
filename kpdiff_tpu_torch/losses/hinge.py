"""Distance hinge losses (kpdiff_tpu/losses/hinge.py)."""
from __future__ import annotations

import torch


def _pairwise_dist(pos_a: torch.Tensor, pos_b: torch.Tensor) -> torch.Tensor:
    """(B, Na, Nb) euclidean distances, rows from pos_a."""
    return torch.sqrt(torch.sum(torch.square(pos_a[:, :, None, :] - pos_b[:, None, :, :]), dim=-1))


def masked_hinge_loss(pos_a: torch.Tensor, mask_a: torch.Tensor, pos_b: torch.Tensor, mask_b: torch.Tensor,
                      threshold: float) -> torch.Tensor:
    """Sum over valid (a, b) pairs of max(threshold - d, 0), summed over the batch."""
    valid = mask_a[:, :, None] & mask_b[:, None, :]
    return torch.sum(torch.clamp(threshold - _pairwise_dist(pos_a, pos_b), min=0.0) * valid)


def masked_self_hinge_loss(pos: torch.Tensor, mask: torch.Tensor, threshold: float) -> torch.Tensor:
    """The same over the pairs i < j of one point set."""
    n = pos.shape[1]
    triu = torch.triu(torch.ones((n, n), dtype=torch.bool, device=pos.device), diagonal=1)
    valid = mask[:, :, None] & mask[:, None, :] & triu[None]
    return torch.sum(torch.clamp(threshold - _pairwise_dist(pos, pos), min=0.0) * valid)
