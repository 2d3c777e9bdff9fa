"""Learned EGNN receptor encoder: pocket atoms -> K equivariant keypoints
(kpdiff_tpu/models/encoder_egnn.py:38-295).

rr edges come as the default `rr_layout: nbr`, a capped radius neighbor
list, or as `rr_layout: block`: the pocket atoms sorted along a Morton
curve (and kept in that order inside the encoder, as in the JAX package),
then banded windows of 3 * tile sources against each tile of `tile`
destinations (`choose_tile(n_rec, rr_block_size)`), self-pairs excluded,
with the same-residue edge feature on the windows. Both layouts share one
`EGNNEdge` (`edge_rr`), in its encoder configuration (edge features, one
coord hidden layer), which never takes the edge kernel: the list in its
`nbr` form, the block windows in its `dense` form.

Executed semantics kept from the JAX package: rk_fc_src serves as both
query and key (rk_fc_dst exists for parameter parity only); the encoder's
message normaliser has no +1; the node update is not residual; k_closest
features use the original pocket positions; `attn_semantics` 'executed'
replicates the reference's unnormalised attention.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from kpdiff_tpu_torch.models.complex import PaddedComplex
from kpdiff_tpu_torch.models.egnn import EGNNEdge
from kpdiff_tpu_torch.models.nn import MLP, LayerNorm, TorchLinear
from kpdiff_tpu_torch.ops.edge_sets import Blocks, edge_count
from kpdiff_tpu_torch.ops.geometry import masked_mean
from kpdiff_tpu_torch.ops.neighbors import gather_rows, knn_indices, radius_neighbor_list
from kpdiff_tpu_torch.ops.spatial import (
    block_radius_adjacency,
    block_same_residue,
    choose_tile,
    spatial_sort_permutation,
)

_NEG = -1e30


class ReceptorConvLayer(nn.Module):
    """One EGNN conv over the rr edge set: a `NbrList`, or with rr_layout
    'block' the banded windows `Blocks` (B, nt, 3 * tile, tile)."""

    def __init__(self, f_in: int, hidden_size: int, out_size: int, gen: torch.Generator,
                 use_tanh: bool = True, coords_range: float = 10.0, fix_pos: bool = False,
                 norm: bool = False, edge_feat_size: int = 0, dtype: str = "float32"):
        super().__init__()
        self.edge_rr = EGNNEdge(
            f_in, hidden_size, gen, use_tanh=use_tanh, coords_range=coords_range,
            coord_hidden_layers=1, compute_coord=not fix_pos, edge_feat_size=edge_feat_size, dtype=dtype)
        self.node_mlp = MLP(f_in + hidden_size, [hidden_size, out_size], ["silu", ""], gen)
        self.LayerNorm_0 = LayerNorm(out_size) if norm else None

    def forward(self, h, x, mask, rr_edges, z, edge_feat=None):
        agg_h, agg_x = self.edge_rr(h, h, x, x, rr_edges, edge_feat)
        new_h = self.node_mlp(torch.cat([h, agg_h / z], dim=-1))
        if self.LayerNorm_0 is not None:
            new_h = self.LayerNorm_0(new_h)
        m = mask[..., None].to(new_h.dtype)
        return new_h * m, (x + agg_x / z) * m


class EGNNReceptorEncoder(nn.Module):
    def __init__(self, gen: torch.Generator, n_keypoints: int = 20, in_n_node_feat: int = 13,
                 hidden_n_node_feat: int = 256, out_n_node_feat: int = 256, n_convs: int = 6,
                 use_tanh: bool = True, coords_range: float = 10.0, kp_feat_scale: float = 1.0,
                 message_norm: float = 1.0, kp_rad: float = 0.0, k_closest: int = 0, norm: bool = False,
                 fix_pos: bool = False, use_sameres_feat: bool = False, n_kk_convs: int = 0,
                 n_kk_heads: int = 4, graph_cutoffs: Dict[str, float] = None, rr_max_neighbors: int = 32,
                 rr_layout: str = "nbr", rr_block_size: int = 64, nbr_gather: str = "onehot",
                 compute_dtype: str = "float32", attn_semantics: str = "intent"):
        super().__init__()
        if (kp_rad != 0) == (k_closest != 0):
            raise ValueError("exactly one of kp_rad / k_closest must be non-zero")
        if n_kk_convs > 0:
            raise NotImplementedError("KeyKeyConv is unfinished in the reference")
        if rr_layout not in ("nbr", "block"):
            raise ValueError(f"rr_layout {rr_layout!r}: 'nbr' or 'block'")
        self.K, self.F = n_keypoints, out_n_node_feat
        self.message_norm = message_norm
        self.kp_rad, self.k_closest = kp_rad, k_closest
        self.fix_pos = fix_pos
        self.use_sameres_feat = use_sameres_feat
        self.rr_cutoff = graph_cutoffs["rr"]
        self.rr_max_neighbors = rr_max_neighbors
        self.rr_layout, self.rr_block_size = rr_layout, rr_block_size
        self.attn_semantics = attn_semantics
        self.n_convs = n_convs
        f_in = in_n_node_feat
        for i in range(n_convs):
            last = i == n_convs - 1
            out_size = out_n_node_feat if (last or n_convs == 1) else hidden_n_node_feat
            self.add_module(f"rec_conv{i}", ReceptorConvLayer(
                f_in, hidden_n_node_feat, out_size, gen, use_tanh=use_tanh, coords_range=coords_range,
                fix_pos=fix_pos, norm=norm, edge_feat_size=1 if use_sameres_feat else 0,
                dtype=compute_dtype))
            f_in = out_size
        Fo, K = out_n_node_feat, n_keypoints
        self.keypoint_embedding = TorchLinear(Fo, Fo * K, gen)
        self.rk_fc_src = TorchLinear(Fo, Fo, gen, use_bias=False)
        self.rk_fc_dst = TorchLinear(Fo, Fo, gen, use_bias=False)  # parameter parity only
        self.kp_feature_mlp = TorchLinear(Fo + (k_closest if k_closest else 0), Fo, gen)
        self.kp_feature_norm = LayerNorm(Fo) if norm else None

    def forward(self, cpx: PaddedComplex) -> PaddedComplex:
        b = cpx.rec_mask.shape[0]
        K, Fo = self.K, self.F
        x0, h, mask, res = cpx.rec_x, cpx.rec_h, cpx.rec_mask, cpx.rec_res_idx

        edge_feat = None
        if self.rr_layout == "block":
            # the pocket in Morton order from here on (a set: safe)
            perm = spatial_sort_permutation(x0, mask)
            x0, h = torch.take_along_dim(x0, perm[..., None], dim=1), torch.take_along_dim(h, perm[..., None], dim=1)
            mask, res = torch.take_along_dim(mask, perm, dim=1), torch.take_along_dim(res, perm, dim=1)
            tile = choose_tile(x0.shape[1], self.rr_block_size)
            rr_edges = Blocks(block_radius_adjacency(x0, mask, self.rr_cutoff, tile))
            if self.use_sameres_feat:
                edge_feat = block_same_residue(res, tile).to(h.dtype)
        else:
            rr_edges = radius_neighbor_list(x0, mask, x0, mask, self.rr_cutoff, self.rr_max_neighbors,
                                            exclude_self=True)
            if self.use_sameres_feat:
                res_nbr = gather_rows(res, rr_edges.idx)
                edge_feat = (res_nbr == res[:, :, None]).to(h.dtype)[..., None]
        n_edges = edge_count(rr_edges).float()

        if self.message_norm == 0:  # no +1 here (receptor_encoder.py:501-506)
            n_rec = torch.clamp(torch.sum(mask, dim=1), min=1).float()
            z = (n_edges / n_rec)[:, None, None]
        else:
            z = torch.full((), float(self.message_norm), device=h.device)

        x = x0
        for i in range(self.n_convs):
            h, x = getattr(self, f"rec_conv{i}")(h, x, mask, rr_edges, z, edge_feat)

        mean_feat = masked_mean(h, mask, dim=1)
        kp_h = F.silu(self.keypoint_embedding(mean_feat)).reshape(b, K, Fo)

        ft_rec = self.rk_fc_src(h)
        ft_kp = self.rk_fc_src(kp_h)
        raw = torch.einsum("bkf,brf->bkr", ft_kp, ft_rec)
        logits = torch.where(mask[:, None, :], raw / math.sqrt(float(Fo)), torch.full_like(raw, _NEG))
        if self.attn_semantics == "executed":
            denom = torch.sum(torch.exp(logits), dim=-1, keepdim=True)
            attn = torch.where(mask[:, None, :], raw, torch.zeros_like(raw)) / denom
        else:
            attn = torch.softmax(logits, dim=-1)
        val = x0 if self.fix_pos else x
        kp_pos = torch.einsum("bkr,brc->bkc", attn, val)

        kp_mask = torch.ones((b, K), dtype=torch.bool, device=h.device)
        if self.k_closest:
            idx, dist, valid = knn_indices(x0, mask, kp_pos, kp_mask, self.k_closest)
            vf = valid[..., None].to(h.dtype)
            h_nbr = gather_rows(h, idx)
            h_mean = torch.sum(h_nbr * vf, dim=2) / torch.clamp(torch.sum(vf, dim=2), min=1.0)
            kp_feat_in = torch.cat([h_mean, dist * valid], dim=-1)
        else:
            idx, within = radius_neighbor_list(x0, mask, kp_pos, kp_mask, self.kp_rad, 100)
            h_sum = torch.sum(gather_rows(h, idx) * within[..., None].to(h.dtype), dim=2)
            z_kp = (torch.sum(within, dim=(1, 2)).float() / K + 1.0)[:, None, None]
            kp_feat_in = h_sum / z_kp

        kp_feat = F.silu(self.kp_feature_mlp(kp_feat_in))
        if self.kp_feature_norm is not None:
            kp_feat = self.kp_feature_norm(kp_feat)
        return cpx.replace(kp_x=kp_pos, kp_h=kp_feat, kp_mask=kp_mask)
