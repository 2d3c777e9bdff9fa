"""Fixed (non-learned) receptor encoder (kpdiff_tpu/models/encoder_fixed.py).

The keypoints become the pocket atoms: kp_* are the rec_* tensors, so the
keypoint capacity is n_rec, and the kk edge set is the rr radius graph
(cutoff graph_cutoffs['rr'], not ['kk']: the reference copies its rr edges).
"""
from __future__ import annotations

from typing import Optional

import torch

from kpdiff_tpu_torch.models.complex import PaddedComplex
from kpdiff_tpu_torch.ops.neighbors import dense_radius_adjacency, radius_neighbor_list
from kpdiff_tpu_torch.ops.spatial import spatial_sort_permutation


def fixed_encode(cpx: PaddedComplex, n_vec_feats: Optional[int] = None, sort_spatial: bool = False) -> PaddedComplex:
    """Copy the pocket atoms into the keypoint slots.

    sort_spatial orders them along a Morton curve (kk_layout 'block');
    keypoints are a set, so the permutation changes nothing else.
    n_vec_feats gives GVP models a zero kp_v of shape (B, K, n_vec_feats, 3)."""
    kp_x, kp_h, kp_mask = cpx.rec_x, cpx.rec_h, cpx.rec_mask
    if sort_spatial:
        perm = spatial_sort_permutation(kp_x, kp_mask)
        kp_x = torch.take_along_dim(kp_x, perm[..., None], dim=1)
        kp_h = torch.take_along_dim(kp_h, perm[..., None], dim=1)
        kp_mask = torch.take_along_dim(kp_mask, perm, dim=1)
    kp_v = None
    if n_vec_feats is not None:
        kp_v = torch.zeros((*kp_x.shape[:2], n_vec_feats, 3), dtype=kp_x.dtype, device=kp_x.device)
    return cpx.replace(kp_x=kp_x, kp_h=kp_h, kp_mask=kp_mask, kp_v=kp_v)


def fixed_kk_edges(cpx: PaddedComplex, rr_cutoff: float, layout: str = "dense", max_neighbors: int = 100):
    """kk edges of the fixed encoder: the rr radius graph over the pocket
    atoms, dense (B, K, K) or a neighbor list (idx, valid)."""
    if layout == "dense":
        return dense_radius_adjacency(cpx.kp_x, cpx.kp_mask, cpx.kp_x, cpx.kp_mask, rr_cutoff, exclude_self=True)
    return radius_neighbor_list(cpx.kp_x, cpx.kp_mask, cpx.kp_x, cpx.kp_mask, rr_cutoff, max_neighbors,
                                exclude_self=True)
