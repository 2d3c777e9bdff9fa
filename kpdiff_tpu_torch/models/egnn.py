"""E(3)-equivariant message passing over dense pair grids, kNN pair lists and
neighbor lists (kpdiff_tpu/models/egnn.py).

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
from kpdiff_tpu_torch.ops.cuda.egnn_edge import egnn_edge_dense, egnn_edge_dense_plain, pack_w2, row_stride
from kpdiff_tpu_torch.ops.neighbors import gather_rows


def records_grad(module: nn.Module, *tensors) -> bool:
    """Whether autograd records a call of `module` on `tensors`: grad enabled
    and a parameter or input that requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in itertools.chain(module.parameters(), tensors))


class _EdgeParams(nn.Module):
    """Parameter scheme shared by the three EGNN edge modules, and their
    route through the edge kernel's entry (`kernel`), open to those in the
    dynamics' configuration (`kernel_ok`: two coord hidden layers,
    coordinates computed, no edge features). Subclasses set `cd`,
    `use_tanh` and `coords_range`."""

    def __init__(self, f_in: int, hidden_size: int, gen: torch.Generator, coord_hidden_layers: int = 2,
                 compute_coord: bool = True, edge_feat_size: int = 0):
        super().__init__()
        h = hidden_size
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

    def kernel(self, h_src, h_dst, x_src, x_dst, adj):
        """Messages over a dense (B, Ns, Nd) pair grid through the kernel's
        entry `egnn_edge_dense` (the CUDA kernel on CUDA tensors, its plain
        version on CPU tensors), forward only: both chains' per-node
        projections in one f32 product per side, rounded to the compute
        dtype, then the per-pair work on the active pairs of `adj`.
        Sources take the first layers' `w_src`, destinations `w_dst`."""
        f32 = torch.float32
        w = self._kernel_weights()
        h = self.edge_b.shape[0]
        lda = row_stride(h)
        a_src = (h_src.to(f32) @ w["w_src"]).to(self.cd)
        a_dst = (h_dst.to(f32) @ w["w_dst"] + w["b_dst"]).to(self.cd)
        return egnn_edge_dense(
            a_src[..., :h], a_dst[..., :h], a_src[..., lda:lda + h], a_dst[..., lda:lda + h],
            w["w_edij"], w["w_cdij"], w["w2e"], w["b2e"], w["attw"], w["atb"],
            w["w2c"], w["b2c"], w["wout"], x_src.to(f32).contiguous(), x_dst.to(f32).contiguous(),
            adj.contiguous(), use_tanh=self.use_tanh, coords_range=self.coords_range, compute_dtype=self.cd)


def _gate(m, attn_w, attn_b, cd):
    """sigmoid(m . attn_w + attn_b): compute-dtype products summed in f32."""
    return torch.sigmoid(torch.sum(m * attn_w[:, 0].to(cd), dim=-1, dtype=torch.float32)
                         + attn_b[0].float())


def _coord_scalar(mod, c, cd, use_tanh, coords_range):
    """Coordinate-chain tail from the first hidden layer c to the clamped scalar."""
    for cw, cb in mod.coord_layers():
        c = F.silu(c @ cw.to(cd) + cb.to(cd))
    scalar = torch.sum(c * mod.coord_out_w[:, 0].to(cd), dim=-1, dtype=torch.float32)
    if use_tanh:
        scalar = torch.tanh(scalar) * coords_range
    return scalar


class EGNNEdgeDense(_EdgeParams):
    """EGNN messages for one edge type over a dense (B, Ns, Nd) pair grid
    (kpdiff_tpu/models/egnn.py:118-326).

    In the dynamics' configuration (two coord hidden layers, coordinates
    computed, no edge features) the per-node first-layer projections are f32
    matrix products here, as in the JAX package's Pallas path, and the
    per-pair work goes through `ops/cuda/egnn_edge.py`: the CUDA kernel on a
    CUDA tensor, its plain version on a CPU tensor. Where autograd records
    (grad enabled and a parameter or input that requires grad) the module
    runs the plain version on its parameters instead, so that training gets
    gradients; sampling and encoding run under no_grad and take the kernel.

    The encoder's configuration (edge features, one coord hidden layer, or
    compute_coord=False for fix_pos) never takes the kernel, as the JAX
    package's `pallas_ok` never does: it runs the JAX package's XLA path in
    plain PyTorch on every device (`_generic`).
    """

    def __init__(self, f_in: int, hidden_size: int, gen: torch.Generator, use_tanh: bool = False,
                 coords_range: float = 10.0, coord_hidden_layers: int = 2, compute_coord: bool = True,
                 edge_feat_size: int = 0, dtype: str = "float32"):
        super().__init__(f_in, hidden_size, gen, coord_hidden_layers, compute_coord, edge_feat_size)
        self.use_tanh = use_tanh
        self.coords_range = float(coords_range)
        self.cd = compute_dtype(dtype)

    def forward(self, h_src, h_dst, x_src, x_dst, adj, edge_feat=None):
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

    def _generic(self, h_src, h_dst, x_src, x_dst, adj, edge_feat=None):
        """The JAX package's dense XLA path (no split t-channel): pair
        pre-activations and products in the compute dtype, reductions in f32."""
        cd, f32 = self.cd, torch.float32
        diff = torch.where(adj[..., None], x_src[:, :, None, :] - x_dst[:, None, :, :], 0.0)
        dij = torch.linalg.norm(diff + 1e-30, dim=-1, keepdim=True)  # (B, Ns, Nd, 1)
        scalars = dij if edge_feat is None else torch.cat([dij, edge_feat.to(dij.dtype)], dim=-1)

        def pair_preact(w_s, w_d, w_dij, bias):
            return ((h_src.to(cd) @ w_s.to(cd))[:, :, None, :]
                    + (h_dst.to(cd) @ w_d.to(cd))[:, None, :, :]
                    + scalars.to(cd) @ w_dij.to(cd)
                    + bias.to(cd))

        m = F.silu(pair_preact(self.edge_w_src, self.edge_w_dst, self.edge_w_dij, self.edge_b))
        m = F.silu(m @ self.edge_lin2_w.to(cd) + self.edge_lin2_b.to(cd))
        gate = _gate(m, self.attn_w, self.attn_b, cd)
        coeff = adj.to(m.dtype) * gate.to(m.dtype)
        agg_h = torch.einsum("bsd,bsdh->bdh", coeff.float(), m.float())
        if not self.compute_coord:
            return agg_h, torch.zeros_like(x_dst)
        c = F.silu(pair_preact(self.coord_w_src, self.coord_w_dst, self.coord_w_dij, self.coord_b))
        scalar = _coord_scalar(self, c, cd, self.use_tanh, self.coords_range)
        coeff_x = adj.to(f32) * scalar / (dij[..., 0] + 1.0)
        return agg_h, torch.einsum("bsd,bsdc->bdc", coeff_x, diff)


class EGNNEdgeKNNPairs(_EdgeParams):
    """EGNN edge math over a kNN pair list anchored at one node set
    (kpdiff_tpu/models/egnn.py:329-531): idx (B, K, k) indexes the other set.
    anchor_is_src=True (kl): the anchor sends, messages land on the gathered
    nodes; False (lk): the gathered nodes send to the anchor.

    `forward` is the pair list in plain PyTorch (training, the CPU). Where
    the edge kernel is taken (CUDA tensors, no autograd recording) the
    dynamics hands the same edge set to `kernel` as a dense mask instead
    (models/dynamics_egnn.py): kl (B, K, Nl) with the anchor as source, lk
    its transpose with the anchor as destination. Either way the anchor
    takes `w_src` for kl and `w_dst` for lk, as EGNNEdgeDense's sources and
    destinations do."""

    def __init__(self, f_in: int, hidden_size: int, gen: torch.Generator, anchor_is_src: bool,
                 use_tanh: bool = False, coords_range: float = 10.0, dtype: str = "float32"):
        super().__init__(f_in, hidden_size, gen)
        self.anchor_is_src = anchor_is_src
        self.use_tanh = use_tanh
        self.coords_range = float(coords_range)
        self.cd = compute_dtype(dtype)

    def forward(self, h_anchor, h_other, x_anchor, x_other, idx, valid):
        cd, f32 = self.cd, torch.float32
        b, K, k = idx.shape
        n_other = h_other.shape[1]
        if self.anchor_is_src:
            w_anchor, w_gathered = self.edge_w_src, self.edge_w_dst
            cw_anchor, cw_gathered = self.coord_w_src, self.coord_w_dst
        else:
            w_anchor, w_gathered = self.edge_w_dst, self.edge_w_src
            cw_anchor, cw_gathered = self.coord_w_dst, self.coord_w_src

        h_g = gather_rows(h_other.to(cd), idx)
        x_g = gather_rows(x_other, idx)
        x_a = x_anchor[:, :, None, :]
        diff = x_a - x_g if self.anchor_is_src else x_g - x_a
        diff = torch.where(valid[..., None], diff, 0.0)
        dij = torch.linalg.norm(diff + 1e-30, dim=-1, keepdim=True)  # (B, K, k, 1)

        def preact(wa, wg, wdij, bias):
            return ((h_anchor.to(cd) @ wa.to(cd))[:, :, None, :]
                    + h_g @ wg.to(cd)
                    + dij.to(cd) * wdij[0].to(cd)
                    + bias.to(cd))

        m = F.silu(preact(w_anchor, w_gathered, self.edge_w_dij, self.edge_b))
        m = F.silu(m @ self.edge_lin2_w.to(cd) + self.edge_lin2_b.to(cd))
        gate = _gate(m, self.attn_w, self.attn_b, cd)
        coeff = gate.to(m.dtype) * valid.to(m.dtype)  # (B, K, k)
        c = F.silu(preact(cw_anchor, cw_gathered, self.coord_w_dij, self.coord_b))
        scalar = _coord_scalar(self, c, cd, self.use_tanh, self.coords_range)
        coeff_x = valid.to(f32) * scalar / (dij[..., 0] + 1.0)

        if self.anchor_is_src:
            # scatter onto the gathered side, summed in f32
            flat = idx.reshape(b, K * k)
            msg = (coeff[..., None].float() * m.float()).reshape(b, K * k, -1)
            agg_h = torch.zeros((b, n_other, msg.shape[-1]), dtype=f32, device=msg.device)
            agg_h = agg_h.scatter_add_(1, flat[..., None].expand_as(msg), msg)
            mx = (coeff_x[..., None] * diff).reshape(b, K * k, 3)
            agg_x = torch.zeros((b, n_other, 3), dtype=f32, device=mx.device)
            agg_x = agg_x.scatter_add_(1, flat[..., None].expand_as(mx), mx)
            return agg_h, agg_x
        agg_h = torch.einsum("bek,bekh->beh", coeff.float(), m.float())
        agg_x = torch.einsum("bek,bekc->bec", coeff_x, diff)
        return agg_h, agg_x


class EGNNEdgeNbrList(_EdgeParams):
    """EGNN edge math over a destination-major neighbor list
    (kpdiff_tpu/models/egnn.py:534-686): nbr_idx (B, Nd, K) into the sources,
    aggregation is a masked sum over K, in plain PyTorch.

    The dynamics' kk_nbr runs it in training and on the CPU. Where the edge
    kernel is taken (CUDA tensors, no autograd recording) the dynamics
    scatters the same list into a dense (B, Ns, Nd) mask for edge_kk, whose
    parameters kk_nbr shares (models/dynamics_egnn.py). The learned EGNN
    encoder's neighbor-list layout runs it on every device."""

    def __init__(self, f_in: int, hidden_size: int, gen: torch.Generator, use_tanh: bool = False,
                 coords_range: float = 10.0, coord_hidden_layers: int = 2, compute_coord: bool = True,
                 edge_feat_size: int = 0, dtype: str = "float32"):
        super().__init__(f_in, hidden_size, gen, coord_hidden_layers, compute_coord, edge_feat_size)
        self.use_tanh = use_tanh
        self.coords_range = float(coords_range)
        self.cd = compute_dtype(dtype)

    def forward(self, h_src, h_dst, x_src, x_dst, nbr_idx, nbr_valid, edge_feat=None):
        cd, f32 = self.cd, torch.float32
        h_nbr = gather_rows(h_src, nbr_idx)
        x_nbr = gather_rows(x_src, nbr_idx)
        diff = x_nbr - x_dst[:, :, None, :]
        diff = torch.where(nbr_valid[..., None], diff, 0.0)
        dij = torch.linalg.norm(diff + 1e-30, dim=-1, keepdim=True)
        scalars = dij if edge_feat is None else torch.cat([dij, edge_feat], dim=-1)

        def pair_preact(w_s, w_d, w_dij, bias):
            return (h_nbr.to(cd) @ w_s.to(cd)
                    + (h_dst.to(cd) @ w_d.to(cd))[:, :, None, :]
                    + scalars.to(cd) @ w_dij.to(cd)
                    + bias.to(cd))

        m = F.silu(pair_preact(self.edge_w_src, self.edge_w_dst, self.edge_w_dij, self.edge_b))
        m = F.silu(m @ self.edge_lin2_w.to(cd) + self.edge_lin2_b.to(cd))
        gate = _gate(m, self.attn_w, self.attn_b, cd)
        coeff = gate.to(m.dtype) * nbr_valid.to(m.dtype)
        agg_h = torch.sum((m * coeff[..., None]).float(), dim=2)
        if not self.compute_coord:
            return agg_h, torch.zeros_like(x_dst)
        c = F.silu(pair_preact(self.coord_w_src, self.coord_w_dst, self.coord_w_dij, self.coord_b))
        scalar = _coord_scalar(self, c, cd, self.use_tanh, self.coords_range)
        coeff_x = nbr_valid.to(f32) * scalar / (dij[..., 0] + 1.0)
        agg_x = torch.einsum("bdk,bdkc->bdc", coeff_x, diff)
        return agg_h, agg_x


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
