"""Static-shape neighbor structures (kpdiff_tpu/ops/neighbors.py).

Dense masked adjacency (B, Ns, Nd) for small node sets and
destination-major neighbor lists (B, Nd, K) for large ones; edge
directions follow the JAX package. `torch.topk` may order ties
differently from `jax.lax.top_k`, so index arrays can differ where
distances tie; the edge SETS under their masks are the same.
"""
from __future__ import annotations

import torch

from kpdiff_tpu_torch.ops.edge_sets import NbrList

__all__ = [
    "gather_rows",
    "masked_pair_dist2",
    "dense_radius_adjacency",
    "dense_knn_adjacency",
    "knn_indices",
    "radius_neighbor_list",
]

_INF = 1e30


def masked_pair_dist2(x_src, mask_src, x_dst, mask_dst, exclude_self: bool = False) -> torch.Tensor:
    """Squared distances (B, Ns, Nd) with invalid pairs set to +inf (1e30)."""
    diff = x_src[:, :, None, :] - x_dst[:, None, :, :]
    d2 = torch.sum(torch.square(diff), dim=-1)
    valid = mask_src[:, :, None] & mask_dst[:, None, :]
    if exclude_self:
        ns, nd = d2.shape[1], d2.shape[2]
        valid = valid & ~torch.eye(ns, nd, dtype=torch.bool, device=d2.device)[None]
    return torch.where(valid, d2, torch.full_like(d2, _INF))


def dense_radius_adjacency(x_src, mask_src, x_dst, mask_dst, radius: float,
                           exclude_self: bool = False) -> torch.Tensor:
    """Boolean (B, Ns, Nd): src strictly within `radius` of dst."""
    d2 = masked_pair_dist2(x_src, mask_src, x_dst, mask_dst, exclude_self=exclude_self)
    return d2 < float(radius) ** 2


def dense_knn_adjacency(x_src, mask_src, x_dst, mask_dst, k: int, per: str = "dst",
                        exclude_self: bool = False) -> torch.Tensor:
    """Boolean (B, Ns, Nd) adjacency from k-nearest selection.

    per='dst': each destination marks its k nearest sources (the ll kNN
    graph); per='src': each source marks its k nearest destinations. Rows
    with fewer than k valid partners mark only the valid ones."""
    if per not in ("dst", "src"):
        raise ValueError(f"per must be 'dst' or 'src', got {per}")
    d2 = masked_pair_dist2(x_src, mask_src, x_dst, mask_dst, exclude_self=exclude_self)
    scores = -d2.transpose(1, 2) if per == "dst" else -d2  # rows choose among the last axis
    neg_d2, idx = torch.topk(scores, min(k, scores.shape[-1]), dim=-1)
    valid = neg_d2 > -_INF * 0.5
    adj = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    adj.scatter_(-1, idx, valid)
    return adj.transpose(1, 2) if per == "dst" else adj


def knn_indices(x_src, mask_src, x_dst, mask_dst, k: int):
    """For each destination, its k nearest sources: (idx (B, Nd, k) int64,
    dist (B, Nd, k) ascending, valid (B, Nd, k) bool)."""
    d2 = masked_pair_dist2(x_src, mask_src, x_dst, mask_dst)
    scores = -d2.transpose(1, 2)  # (B, Nd, Ns)
    neg_d2, idx = torch.topk(scores, min(k, scores.shape[-1]), dim=-1)
    valid = neg_d2 > -_INF * 0.5
    dist = torch.sqrt(torch.clamp(-neg_d2, min=0.0))
    return idx, dist, valid


def radius_neighbor_list(x_src, mask_src, x_dst, mask_dst, radius: float, max_neighbors: int,
                         exclude_self: bool = False):
    """Destination-major list of the (up to) `max_neighbors` nearest sources
    within `radius`: NbrList(idx (B, Nd, K) int64, valid (B, Nd, K) bool)."""
    d2 = masked_pair_dist2(x_src, mask_src, x_dst, mask_dst, exclude_self=exclude_self)
    scores = -d2.transpose(1, 2)
    neg_d2, idx = torch.topk(scores, min(max_neighbors, scores.shape[-1]), dim=-1)
    return NbrList(idx, (-neg_d2) < float(radius) ** 2)


def gather_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of h (B, N, ...) at idx (B, M, k) -> (B, M, k, ...)."""
    b, m, k = idx.shape
    flat = idx.reshape(b, m * k).reshape(b, m * k, *([1] * (h.dim() - 2)))
    return torch.gather(h, 1, flat.expand(-1, -1, *h.shape[2:])).reshape(b, m, k, *h.shape[2:])
