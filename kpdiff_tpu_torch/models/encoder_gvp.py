"""Learned GVP receptor encoder: pocket atoms -> K keypoints with scalar and
vector features (kpdiff_tpu/models/encoder_gvp.py).

rr convs run over a capped radius neighbor list (`rr_layout: nbr`) or, with
`rr_layout: block`, over banded windows of the Morton-sorted pocket (each
tile of `choose_tile(n_rec, rr_block_size)` destinations against the 3 *
tile sources of its window; the pocket stays sorted inside the encoder, as
in the JAX package); both layouts share the parameters. Keypoint positions
come from a masked attention over the pocket atoms, rk convs over each
keypoint's k_closest atoms (or those within kp_rad). Kept from the JAX
package: separate query and key projections (src_net, dst_net); keypoint
scalars and vectors start at zero; the message normaliser at message_norm 0
has no +1; rbf_dmax is the rr cutoff for rr convs and the rk cutoff for rk
convs; rk convs use destination features from the second on and compute in
f32 whatever the compute dtype; attn_semantics 'executed' replicates the
reference's unnormalised attention.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from kpdiff_tpu_torch.models.complex import PaddedComplex
from kpdiff_tpu_torch.models.gvp import (
    GVPChain,
    GVPEdgeMessages,
    GVPLayerNorm,
    _update_specs,
    apply_gvp_dropout,
    gvp_dropout_masks,
)
from kpdiff_tpu_torch.models.nn import MLP, LayerNorm, TorchLinear
from kpdiff_tpu_torch.ops.edge_sets import Blocks, NbrList, edge_count
from kpdiff_tpu_torch.ops.geometry import masked_mean
from kpdiff_tpu_torch.ops.neighbors import gather_rows, knn_indices, radius_neighbor_list
from kpdiff_tpu_torch.ops.spatial import (
    block_radius_adjacency,
    block_same_residue,
    choose_tile,
    spatial_sort_permutation,
)

_NEG = -1e30


class GVPEdgeConvNbr(nn.Module):
    """Single-edge-type GVP conv over a `NbrList` or the banded windows
    `Blocks` of one node set: messages, then a residual update of the
    destinations (reference gvp.py:170-341)."""

    def __init__(self, scalar_size: int, vector_size: int, gen: torch.Generator, n_message_gvps: int = 1,
                 n_update_gvps: int = 1, use_dst_feats: bool = False, edge_feat_size: int = 0,
                 rbf_dmax: float = 15.0, message_norm: Union[float, str] = 10,
                 dropout: float = 0.0, dtype: str = "float32"):
        super().__init__()
        self.edge = GVPEdgeMessages(scalar_size, vector_size, gen, n_message_gvps=n_message_gvps, rbf_dmax=rbf_dmax,
                                    use_dst_feats=use_dst_feats, edge_feat_size=edge_feat_size,
                                    agg="mean" if message_norm == "mean" else "sum", dtype=dtype)
        self.message_norm = GVPLayerNorm(scalar_size)
        self.update = GVPChain(_update_specs(scalar_size, vector_size, n_update_gvps), gen, dtype=dtype)
        self.update_norm = GVPLayerNorm(scalar_size)
        self.dropout = float(dropout)

    def forward(self, src, dst, edges, z, mask_dst, edge_feat=None, dropout: bool = False,
                generator: Optional[torch.Generator] = None):
        h_s, x_s, v_s = src
        h_d, x_d, v_d = dst
        s_msg, v_msg = self.edge(h_s, v_s, x_s, h_d, v_d, x_d, edges, edge_feat)
        s_msg = s_msg / z
        v_msg = v_msg / (z[..., None] if torch.is_tensor(z) else z)
        drop = dropout and self.dropout > 0
        if drop:
            s_msg, v_msg = apply_gvp_dropout(s_msg, v_msg, gvp_dropout_masks(generator, s_msg, v_msg, self.dropout),
                                             self.dropout)
        h, v = self.message_norm(h_d + s_msg, v_d + v_msg)
        s_res, v_res = self.update(h, v)
        s_res, v_res = s_res.to(h.dtype), v_res.to(v.dtype)
        if drop:
            s_res, v_res = apply_gvp_dropout(s_res, v_res, gvp_dropout_masks(generator, s_res, v_res, self.dropout),
                                             self.dropout)
        h, v = self.update_norm(h + s_res, v + v_res)
        m = mask_dst[..., None].to(h.dtype)
        return h * m, v * m[..., None]


class GVPReceptorEncoder(nn.Module):
    """ReceptorEncoderGVP (kpdiff_tpu/models/encoder_gvp.py:160-327)."""

    def __init__(self, gen: torch.Generator, in_scalar_size: int, n_keypoints: int = 20, out_scalar_size: int = 128,
                 vector_size: int = 16, n_rr_convs: int = 3, n_rk_convs: int = 2, n_message_gvps: int = 1,
                 n_update_gvps: int = 1, message_norm: Union[float, str] = 10, use_sameres_feat: bool = False,
                 kp_rad: float = 0.0, k_closest: int = 0, dropout: float = 0.0,
                 graph_cutoffs: Optional[Dict[str, float]] = None, rr_max_neighbors: int = 32,
                 rr_layout: str = "nbr", rr_block_size: int = 64, compute_dtype: str = "float32",
                 attn_semantics: str = "intent"):
        super().__init__()
        if (kp_rad != 0) == (k_closest != 0):
            raise ValueError("exactly one of kp_rad / k_closest must be non-zero")
        if rr_layout not in ("nbr", "block"):
            raise ValueError(f"rr_layout {rr_layout!r}: 'nbr' or 'block'")
        self.rr_layout, self.rr_block_size = rr_layout, rr_block_size
        F_, K = out_scalar_size, n_keypoints
        self.K, self.F = K, F_
        self.vector_size = vector_size
        self.n_rr_convs, self.n_rk_convs = n_rr_convs, n_rk_convs
        self.message_norm = message_norm
        self.use_sameres_feat = use_sameres_feat
        self.kp_rad, self.k_closest = kp_rad, k_closest
        self.rr_cutoff = graph_cutoffs["rr"]
        self.rr_max_neighbors = rr_max_neighbors
        self.attn_semantics = attn_semantics
        self.scalar_embed = MLP(in_scalar_size, [F_, F_], ["silu", "silu"], gen)
        self.scalar_norm = LayerNorm(F_)
        common = dict(n_message_gvps=n_message_gvps, n_update_gvps=n_update_gvps, message_norm=message_norm,
                      dropout=dropout)
        for i in range(n_rr_convs):
            self.add_module(f"rr_conv{i}", GVPEdgeConvNbr(
                F_, vector_size, gen, edge_feat_size=1 if use_sameres_feat else 0, rbf_dmax=graph_cutoffs["rr"],
                dtype=compute_dtype, **common))
        self.keypoint_embedding = TorchLinear(F_, F_ * K, gen)
        self.keypoint_embedding_norm = LayerNorm(F_ * K)
        self.src_net = TorchLinear(F_, F_, gen, use_bias=False)
        self.dst_net = TorchLinear(F_, F_, gen, use_bias=False)
        for i in range(n_rk_convs):
            self.add_module(f"rk_conv{i}", GVPEdgeConvNbr(
                F_, vector_size, gen, use_dst_feats=i != 0, rbf_dmax=graph_cutoffs["rk"], **common))

    def _z(self, n_edges, n_nodes):
        if self.message_norm == "mean":
            return 1.0
        if self.message_norm == 0:  # no +1 here (reference receptor_encoder_gvp.py:243-246, 266-269)
            return (n_edges / n_nodes)[:, None, None]
        return float(self.message_norm)

    def forward(self, cpx: PaddedComplex, dropout: bool = False,
                generator: Optional[torch.Generator] = None) -> PaddedComplex:
        """dropout=True (the training loss) applies the configured dropout
        with masks drawn from `generator`."""
        b, nr = cpx.rec_mask.shape
        K, F_ = self.K, self.F
        x0, mask, res = cpx.rec_x, cpx.rec_mask, cpx.rec_res_idx
        drop = dict(dropout=dropout, generator=generator)

        rec_h = cpx.rec_h
        if self.rr_layout == "block":
            # the pocket in Morton order from here on (a set: safe)
            perm = spatial_sort_permutation(x0, mask)
            x0, rec_h = (torch.take_along_dim(a, perm[..., None], dim=1) for a in (x0, rec_h))
            mask, res = torch.take_along_dim(mask, perm, dim=1), torch.take_along_dim(res, perm, dim=1)
        h = self.scalar_norm(self.scalar_embed(rec_h)) * mask[..., None]
        v = torch.zeros((b, nr, self.vector_size, 3), dtype=h.dtype, device=h.device)

        edge_feat = None
        if self.rr_layout == "block":
            tile = choose_tile(nr, self.rr_block_size)
            rr_edges = Blocks(block_radius_adjacency(x0, mask, self.rr_cutoff, tile))
            if self.use_sameres_feat:
                edge_feat = block_same_residue(res, tile).to(h.dtype)
        else:
            rr_edges = radius_neighbor_list(x0, mask, x0, mask, self.rr_cutoff, self.rr_max_neighbors,
                                            exclude_self=True)
            if self.use_sameres_feat:
                edge_feat = (gather_rows(res, rr_edges.idx) == res[:, :, None]).to(h.dtype)[..., None]
        n_rec = torch.clamp(torch.sum(mask, dim=1), min=1).float()
        z = self._z(edge_count(rr_edges).float(), n_rec)
        for i in range(self.n_rr_convs):
            h, v = getattr(self, f"rr_conv{i}")((h, x0, v), (h, x0, v), rr_edges, z, mask, edge_feat, **drop)

        # keypoint initializer: positions by attention over the pocket atoms
        kp_emb = self.keypoint_embedding_norm(F.silu(self.keypoint_embedding(masked_mean(h, mask, dim=1))))
        kp_emb = kp_emb.reshape(b, K, F_)
        raw = torch.einsum("bkf,brf->bkr", self.dst_net(kp_emb), self.src_net(h))
        logits = torch.where(mask[:, None, :], raw / math.sqrt(float(F_)), torch.full_like(raw, _NEG))
        if self.attn_semantics == "executed":
            denom = torch.sum(torch.exp(logits), dim=-1, keepdim=True)
            attn = torch.where(mask[:, None, :], raw, torch.zeros_like(raw)) / denom
        else:
            attn = torch.softmax(logits, dim=-1)
        kp_pos = torch.einsum("bkr,brc->bkc", attn, x0)

        kp_h = torch.zeros((b, K, F_), dtype=h.dtype, device=h.device)
        kp_v = torch.zeros((b, K, self.vector_size, 3), dtype=h.dtype, device=h.device)
        kp_mask = torch.ones((b, K), dtype=torch.bool, device=h.device)
        if self.k_closest > 0:
            rk_idx, _dist, rk_valid = knn_indices(x0, mask, kp_pos, kp_mask, self.k_closest)
            rk = NbrList(rk_idx, rk_valid)
        else:
            rk = radius_neighbor_list(x0, mask, kp_pos, kp_mask, self.kp_rad, 10)
        z_rk = self._z(edge_count(rk).float(), float(K))
        for i in range(self.n_rk_convs):
            kp_h, kp_v = getattr(self, f"rk_conv{i}")((h, x0, v), (kp_h, kp_pos, kp_v), rk, z_rk, kp_mask, **drop)
        return cpx.replace(kp_x=kp_pos, kp_h=kp_h, kp_mask=kp_mask, kp_v=kp_v)
