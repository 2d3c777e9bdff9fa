"""E(3)-equivariant message passing over the edge sets of ops/edge_sets.py:
dense pair grids, kNN pair lists, neighbor lists and block windows
(kpdiff_tpu/models/egnn.py).

Executed semantics kept from the JAX package (and its reference):
  * dij = |diff + 1e-30| with masked pairs' diffs zeroed first;
  * coordinate messages are (x_src - x_dst) / (dij + 1) times the coord
    MLP's scalar, tanh-clamped to coords_range when use_tanh;
  * coordinate messages flow on every edge type;
  * the first layer of each MLP is factorised into per-node products:
    W @ concat(h_src, h_dst, d) == W_s h_src + W_d h_dst + w d.

Parameters carry the flax names and (in, out) layouts.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F
from torch import nn

from kpdiff_tpu_torch.models.nn import MLP, LayerNorm, compute_dtype, uniform_, xavier_uniform_scaled
from kpdiff_tpu_torch.ops.cuda.egnn_edge import (egnn_edge_dense, egnn_edge_dense_plain, egnn_edge_list, pack_w2,
                                                 row_stride)
from kpdiff_tpu_torch.ops.edge_sets import Blocks, KernelList, NbrList, PairList, refuse
from kpdiff_tpu_torch.ops.neighbors import gather_rows


def records_grad(module: nn.Module, *tensors) -> bool:
    """Whether autograd records a call of `module` on `tensors`: grad enabled
    and a parameter or input that requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in itertools.chain(module.parameters(), tensors))


def _offsets(diff, mask):
    """Pair offsets zeroed where `mask` is not set, and their lengths |diff + 1e-30| (..., 1)."""
    diff = torch.where(mask[..., None], diff, 0.0)
    return diff, torch.linalg.norm(diff + 1e-30, dim=-1, keepdim=True)


class EGNNEdge(nn.Module):
    """EGNN messages of one edge type (kpdiff_tpu/models/egnn.py:118-686):
    one parameter set and three forms, `dense` over a (B, Ns, Nd) pair grid,
    `nbr` over a destination-major neighbor list and `pairs` over a kNN pair
    list anchored at one node set. `forward` takes an edge set in any form
    of ops/edge_sets.py and runs the form it names; a `Blocks` runs `dense`
    on its windows, and a `KernelList` runs `nbr_kernel` (below).

    `dense` has three routes. In the dynamics' configuration (`kernel_ok`:
    two coord hidden layers, coordinates computed, no edge features) the
    per-node first-layer projections are f32 matrix products, as in the JAX
    package's Pallas path, and the per-pair work goes through
    `ops/cuda/egnn_edge.py` (`kernel`): the CUDA kernel on a CUDA tensor,
    its plain version on a CPU tensor. Where autograd records (grad enabled
    and a parameter or input that requires grad) it runs the plain version
    on its parameters instead, so that training gets gradients; sampling
    and encoding run under no_grad and take the kernel. The encoder's
    configuration (edge features, one coord hidden layer, or
    compute_coord=False for fix_pos) never takes the kernel, as the JAX
    package's `pallas_ok` never does: it runs the JAX package's XLA path in
    plain PyTorch on every device (`_generic`).

    A neighbor list takes the kernel's list mode (`nbr_kernel`: the
    projections of `kernel`, then `egnn_edge_list`, forward only) where the
    dynamics chose the kernel's route and handed it in as a `KernelList`
    (models/dynamics_egnn.py, the one place that decides); a plain `NbrList`
    runs `nbr`. `nbr` and `pairs` run in plain PyTorch; where the edge
    kernel is taken the dynamics hands kNN pairs in as dense masks instead.
    """

    def __init__(self, f_in: int, hidden_size: int, gen: torch.Generator, use_tanh: bool = False,
                 coords_range: float = 10.0, coord_hidden_layers: int = 2, compute_coord: bool = True,
                 edge_feat_size: int = 0, dtype: str = "float32"):
        super().__init__()
        h = hidden_size
        self.use_tanh = use_tanh
        self.coords_range = float(coords_range)
        self.cd = compute_dtype(dtype)
        self.coord_hidden_layers = coord_hidden_layers
        self.compute_coord = compute_coord
        self.edge_feat_size = edge_feat_size
        self.kernel_ok = compute_coord and coord_hidden_layers == 2 and edge_feat_size == 0
        self._pack = None  # (parameter key, kernel weight operands)
        self._first_layer("edge", f_in, h, gen)
        self._linear("edge_lin2", h, h, gen)
        self._linear("attn", h, 1, gen)
        if compute_coord:
            self._first_layer("coord", f_in, h, gen)
            for i in range(coord_hidden_layers - 1):
                self._linear(f"coord_lin{i + 2}", h, h, gen)
            self.coord_out_w = xavier_uniform_scaled(h, 1, 0.001, gen)

    def _linear(self, name, d_in, d_out, gen):
        bound = 1.0 / math.sqrt(d_in)
        setattr(self, f"{name}_w", nn.Parameter(uniform_((d_in, d_out), bound, gen)))
        setattr(self, f"{name}_b", nn.Parameter(uniform_((d_out,), bound, gen)))

    def _first_layer(self, name, f_in, h, gen):
        e = 1 + self.edge_feat_size
        setattr(self, f"{name}_w_src", nn.Parameter(uniform_((f_in, h), 1.0 / math.sqrt(f_in), gen)))
        setattr(self, f"{name}_w_dst", nn.Parameter(uniform_((f_in, h), 1.0 / math.sqrt(f_in), gen)))
        setattr(self, f"{name}_w_dij", nn.Parameter(uniform_((e, h), 1.0 / math.sqrt(e), gen)))
        setattr(self, f"{name}_b", nn.Parameter(uniform_((h,), 1.0 / math.sqrt(2 * f_in + e), gen)))

    def coord_layers(self):
        return [(getattr(self, f"coord_lin{i + 2}_w"), getattr(self, f"coord_lin{i + 2}_b"))
                for i in range(self.coord_hidden_layers - 1)]

    def _kernel_weights(self):
        """The kernel's weight operands, converted once and cached until a
        parameter changes: the first layers' source and destination matrices
        (and destination biases) of both chains side by side, f32, each
        zero padded to `row_stride` columns (one product per side writes the
        kernel's a_* rows of both chains), f32 vectors, and the second
        layers packed in the compute dtype (`pack_w2`)."""
        params = tuple(self.parameters())
        key = (self.cd, tuple((p.data_ptr(), p._version, p.dtype) for p in params))
        if self._pack is None or self._pack[0] != key:
            f32 = torch.float32

            def vec(p):
                return p.detach().reshape(-1).to(f32).contiguous()

            def cols(*ps):
                return torch.cat([F.pad(p.detach().to(f32), (0, row_stride(p.shape[-1]) - p.shape[-1]))
                                  for p in ps], dim=-1).contiguous()

            pack = dict(w_src=cols(self.edge_w_src, self.coord_w_src), w_dst=cols(self.edge_w_dst, self.coord_w_dst),
                        b_dst=cols(self.edge_b, self.coord_b))
            pack.update(
                w_edij=vec(self.edge_w_dij[0]), w_cdij=vec(self.coord_w_dij[0]),
                w2e=pack_w2(self.edge_lin2_w, self.cd), b2e=vec(self.edge_lin2_b),
                attw=vec(self.attn_w), atb=vec(self.attn_b),
                w2c=pack_w2(self.coord_lin2_w, self.cd), b2c=vec(self.coord_lin2_b),
                wout=vec(self.coord_out_w))
            self._pack = (key, pack)
        return self._pack[1]

    def _kernel_operands(self, h_src, h_dst, x_src, x_dst):
        """The kernel entries' operands before the edges: both chains'
        per-node projections in one f32 product per side, rounded to the
        compute dtype (sources take the first layers' `w_src`, destinations
        `w_dst`), the cached weights and the positions in f32."""
        f32 = torch.float32
        w = self._kernel_weights()
        h = self.edge_b.shape[0]
        lda = row_stride(h)
        a_src = (h_src.to(f32) @ w["w_src"]).to(self.cd)
        a_dst = (h_dst.to(f32) @ w["w_dst"] + w["b_dst"]).to(self.cd)
        return (a_src[..., :h], a_dst[..., :h], a_src[..., lda:lda + h], a_dst[..., lda:lda + h],
                w["w_edij"], w["w_cdij"], w["w2e"], w["b2e"], w["attw"], w["atb"],
                w["w2c"], w["b2c"], w["wout"], x_src.to(f32).contiguous(), x_dst.to(f32).contiguous())

    def kernel(self, h_src, h_dst, x_src, x_dst, adj):
        """Messages over a dense (B, Ns, Nd) pair grid through the kernel's
        entry `egnn_edge_dense` (the CUDA kernel on CUDA tensors, its plain
        version on CPU tensors), forward only: the per-node projections,
        then the per-pair work on the active pairs of `adj`."""
        return egnn_edge_dense(*self._kernel_operands(h_src, h_dst, x_src, x_dst), adj.contiguous(),
                               use_tanh=self.use_tanh, coords_range=self.coords_range, compute_dtype=self.cd)

    def nbr_kernel(self, h_src, h_dst, x_src, x_dst, edges: NbrList):
        """Messages over a destination-major neighbor list through the
        kernel's entry `egnn_edge_list` (its list mode, which reads the list
        and builds no mask), forward only: the projections of `kernel`, then
        the per-pair work on the list's valid slots."""
        return egnn_edge_list(*self._kernel_operands(h_src, h_dst, x_src, x_dst), edges.idx,
                              edges.valid.contiguous(), use_tanh=self.use_tanh, coords_range=self.coords_range,
                              compute_dtype=self.cd)

    def forward(self, h_src, h_dst, x_src, x_dst, edges, edge_feat=None):
        """-> (agg_h (B, Nd, H) f32, agg_x (B, Nd, 3)) of the edge set `edges`."""
        if torch.is_tensor(edges):
            return self.dense(h_src, h_dst, x_src, x_dst, edges, edge_feat)
        if isinstance(edges, KernelList):
            return self.nbr_kernel(h_src, h_dst, x_src, x_dst, edges)
        if isinstance(edges, NbrList):
            return self.nbr(h_src, h_dst, x_src, x_dst, edges.idx, edges.valid, edge_feat)
        if isinstance(edges, PairList):
            if edges.anchor_is_src:
                return self.pairs(h_src, h_dst, x_src, x_dst, edges.idx, edges.valid, anchor_is_src=True)
            return self.pairs(h_dst, h_src, x_dst, x_src, edges.idx, edges.valid, anchor_is_src=False)
        if isinstance(edges, Blocks):  # square over one node set: the sources'
            (hs, xs), (hd, xd), adj, ef = edges.grid((h_src, x_src), edge_feat)
            return edges.ungrid(*self.dense(hs, hd, xs, xd, adj, ef))
        refuse(edges)

    def dense(self, h_src, h_dst, x_src, x_dst, adj, edge_feat=None):
        """Messages over a dense (B, Ns, Nd) pair grid, by the route above."""
        if not self.kernel_ok:
            return self._generic(h_src, h_dst, x_src, x_dst, adj, edge_feat)
        if not records_grad(self, h_src, h_dst, x_src, x_dst):
            return self.kernel(h_src, h_dst, x_src, x_dst, adj)
        # Training: the plain version on the parameters themselves, so
        # autograd reaches all of them (the JAX package trains through
        # its XLA path; the kernel is forward-only there and here).
        f32 = torch.float32
        hs, hd = h_src.to(f32), h_dst.to(f32)
        return egnn_edge_dense_plain(
            hs @ self.edge_w_src, hd @ self.edge_w_dst + self.edge_b,
            hs @ self.coord_w_src, hd @ self.coord_w_dst + self.coord_b,
            self.edge_w_dij[0], self.coord_w_dij[0], self.edge_lin2_w, self.edge_lin2_b,
            self.attn_w[:, 0], self.attn_b, self.coord_lin2_w, self.coord_lin2_b, self.coord_out_w[:, 0],
            x_src.to(f32).contiguous(), x_dst.to(f32).contiguous(), adj.contiguous(),
            use_tanh=self.use_tanh, coords_range=self.coords_range, compute_dtype=self.cd)

    def _pair_terms(self, preact, mask, dij):
        """The per-pair terms of the pair pre-activations `preact(w_s, w_d,
        w_dij, bias)` of both chains: the edge messages m, their coefficients
        mask x gate, and with compute_coord the coordinate coefficients
        mask x scalar / (dij + 1) (else None). Products in the compute dtype,
        the gate's and the scalar's sums in f32."""
        cd, f32 = self.cd, torch.float32
        m = F.silu(preact(self.edge_w_src, self.edge_w_dst, self.edge_w_dij, self.edge_b))
        m = F.silu(m @ self.edge_lin2_w.to(cd) + self.edge_lin2_b.to(cd))
        gate = torch.sigmoid(torch.sum(m * self.attn_w[:, 0].to(cd), dim=-1, dtype=f32) + self.attn_b[0].float())
        coeff = mask.to(m.dtype) * gate.to(m.dtype)
        if not self.compute_coord:
            return m, coeff, None
        c = F.silu(preact(self.coord_w_src, self.coord_w_dst, self.coord_w_dij, self.coord_b))
        for cw, cb in self.coord_layers():
            c = F.silu(c @ cw.to(cd) + cb.to(cd))
        scalar = torch.sum(c * self.coord_out_w[:, 0].to(cd), dim=-1, dtype=f32)
        if self.use_tanh:
            scalar = torch.tanh(scalar) * self.coords_range
        return m, coeff, mask.to(f32) * scalar / (dij[..., 0] + 1.0)

    def _generic(self, h_src, h_dst, x_src, x_dst, adj, edge_feat=None):
        """The JAX package's dense XLA path (no split t-channel): pair
        pre-activations and products in the compute dtype, reductions in f32."""
        cd = self.cd
        diff, dij = _offsets(x_src[:, :, None, :] - x_dst[:, None, :, :], adj)  # (B, Ns, Nd, .)
        scalars = dij if edge_feat is None else torch.cat([dij, edge_feat.to(dij.dtype)], dim=-1)

        def preact(w_s, w_d, w_dij, bias):
            return ((h_src.to(cd) @ w_s.to(cd))[:, :, None, :]
                    + (h_dst.to(cd) @ w_d.to(cd))[:, None, :, :]
                    + scalars.to(cd) @ w_dij.to(cd)
                    + bias.to(cd))

        m, coeff, coeff_x = self._pair_terms(preact, adj, dij)
        agg_h = torch.einsum("bsd,bsdh->bdh", coeff.float(), m.float())
        if coeff_x is None:
            return agg_h, torch.zeros_like(x_dst)
        return agg_h, torch.einsum("bsd,bsdc->bdc", coeff_x, diff)

    def pairs(self, h_anchor, h_other, x_anchor, x_other, idx, valid, anchor_is_src: bool):
        """Messages over a kNN pair list idx (B, K, k) into the other node set
        (kpdiff_tpu/models/egnn.py:329-531). anchor_is_src (kl): the anchor
        sends, messages land on the gathered nodes; otherwise (lk) the
        gathered nodes send to the anchor. The anchor takes `w_src` for kl
        and `w_dst` for lk, as `dense`'s sources and destinations do."""
        cd, f32 = self.cd, torch.float32
        b, K, k = idx.shape
        h_g = gather_rows(h_other.to(cd), idx)
        x_g = gather_rows(x_other, idx)
        x_a = x_anchor[:, :, None, :]
        diff, dij = _offsets(x_a - x_g if anchor_is_src else x_g - x_a, valid)  # (B, K, k, .)

        def preact(w_s, w_d, w_dij, bias):
            w_anchor, w_gathered = (w_s, w_d) if anchor_is_src else (w_d, w_s)
            return ((h_anchor.to(cd) @ w_anchor.to(cd))[:, :, None, :]
                    + h_g @ w_gathered.to(cd)
                    + dij.to(cd) * w_dij[0].to(cd)
                    + bias.to(cd))

        m, coeff, coeff_x = self._pair_terms(preact, valid, dij)
        if not anchor_is_src:
            return torch.einsum("bek,bekh->beh", coeff.float(), m.float()), torch.einsum("bek,bekc->bec", coeff_x, diff)
        # scatter onto the gathered side, summed in f32
        flat = idx.reshape(b, K * k)
        msg = (coeff[..., None].float() * m.float()).reshape(b, K * k, -1)
        mx = (coeff_x[..., None] * diff).reshape(b, K * k, 3)
        n_other = h_other.shape[1]
        agg_h = torch.zeros((b, n_other, msg.shape[-1]), dtype=f32, device=msg.device)
        agg_x = torch.zeros((b, n_other, 3), dtype=f32, device=mx.device)
        return (agg_h.scatter_add_(1, flat[..., None].expand_as(msg), msg),
                agg_x.scatter_add_(1, flat[..., None].expand_as(mx), mx))

    def nbr(self, h_src, h_dst, x_src, x_dst, nbr_idx, nbr_valid, edge_feat=None):
        """Messages over a destination-major neighbor list nbr_idx (B, Nd, K)
        into the sources (kpdiff_tpu/models/egnn.py:534-686): a masked sum
        over K."""
        cd = self.cd
        h_nbr = gather_rows(h_src, nbr_idx)
        diff, dij = _offsets(gather_rows(x_src, nbr_idx) - x_dst[:, :, None, :], nbr_valid)  # (B, Nd, K, .)
        scalars = dij if edge_feat is None else torch.cat([dij, edge_feat], dim=-1)

        def preact(w_s, w_d, w_dij, bias):
            return (h_nbr.to(cd) @ w_s.to(cd)
                    + (h_dst.to(cd) @ w_d.to(cd))[:, :, None, :]
                    + scalars.to(cd) @ w_dij.to(cd)
                    + bias.to(cd))

        m, coeff, coeff_x = self._pair_terms(preact, nbr_valid, dij)
        agg_h = torch.sum((m * coeff[..., None]).float(), dim=2)
        if coeff_x is None:
            return agg_h, torch.zeros_like(x_dst)
        return agg_h, torch.einsum("bdk,bdkc->bdc", coeff_x, diff)


class NodeUpdate(nn.Module):
    """Residual phi_h update plus optional LayerNorm (kpdiff_tpu/models/egnn.py:689-704)."""

    def __init__(self, f_in: int, hidden_size: int, out_size: int, gen: torch.Generator, norm: bool = False,
                 dtype: str = "float32"):
        super().__init__()
        self.node_mlp = MLP(f_in + hidden_size, [hidden_size, out_size], ["silu", ""], gen, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(out_size) if norm else None

    def forward(self, h, h_agg):
        upd = self.node_mlp(torch.cat([h, h_agg.to(h.dtype)], dim=-1))
        out = h + upd.to(h.dtype)
        if self.LayerNorm_0 is not None:
            out = self.LayerNorm_0(out)
        return out
