"""The fixed receptor encoder (upstream's `rec_encoder_type: fixed`, the
paper's all-atom and Cα baselines): no learned weights, every pocket atom is
a keypoint. The keypoints are the receptor's atoms in their input order, so
the keypoint capacity is the receptor's padding, and the kk edges are the
receptor's rr radius graph (graph_cutoffs['rr']: upstream copies its rr
edges into the kk edge set; the kk cutoff is not read).
"""
from __future__ import annotations

import torch

from portbench.reference.complex import PaddedComplex
from portbench.reference.neighbors import dense_radius_adjacency


def fixed_encode(cpx: PaddedComplex) -> PaddedComplex:
    """The pocket atoms as the keypoints: positions, element one-hots, mask."""
    return cpx.replace(kp_x=cpx.rec_x, kp_h=cpx.rec_h, kp_mask=cpx.rec_mask)


def rr_adjacency(kp_x: torch.Tensor, kp_mask: torch.Tensor, rr_cutoff: float) -> torch.Tensor:
    """The kk edges of a fixed encoder: the dense (B, K, K) radius graph at
    the rr cutoff, no self edges."""
    return dense_radius_adjacency(kp_x, kp_mask, kp_x, kp_mask, rr_cutoff, exclude_self=True)
