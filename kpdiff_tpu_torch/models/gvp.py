"""Geometric vector perceptrons and their edge messages (kpdiff_tpu/models/gvp.py).

Scalars are (..., S) and vectors (..., V, 3) over any leading dims, so one
module serves nodes, neighbor lists and dense pair grids. The JAX package
stores vectors flat as (..., 3V), a layout chosen for the TPU's lanes; the
port keeps (..., V, 3) and writes the channel maps as einsums. It computes
what the flat path computes: per-channel norms in f32 before the compute
dtype, and the first GVP of every message chain factorised over the pieces
of its concatenated inputs (`GVPFactorizedFirst`), so that per-node pieces
are multiplied at node rank and broadcast in the sum.

Parameters keep the flax names and (in, out) layouts: `Wh` (V_in, H),
`Wu` (H, V_out), `to_feats_out`, `scalar_to_vector_gates`, chains as
`gvp0`, `gvp1`, ..., and GVPLayerNorm's `LayerNorm_0`, so the JAX archives
load unchanged.

Details kept from the reference:
  * norm_no_nan clamps the sum of squares at 1e-8 before the sqrt;
  * x_diff is divided by its clamped norm + 1e-8 (not by d + 1, as in the EGNN);
  * message scalars are [h_src, rbf(d)] (+ edge features, + h_dst with
    use_dst_feats), message vectors [x_unit, v_src (, v_dst)];
  * dropout drops whole vector channels.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from kpdiff_tpu_torch.models.nn import LayerNorm, TorchLinear, compute_dtype, torch_bias, torch_kernel, uniform_
from kpdiff_tpu_torch.ops.cuda import gvp_message
from kpdiff_tpu_torch.ops.edge_sets import Blocks, KernelList, NbrList, PairList, refuse
from kpdiff_tpu_torch.ops.geometry import norm_no_nan, rbf_embed
from kpdiff_tpu_torch.ops.neighbors import gather_rows


def _channel_norm(v: torch.Tensor) -> torch.Tensor:
    """(..., V, 3) -> (..., V) per-channel norm, in f32, sum of squares clamped at 1e-8."""
    return torch.sqrt(torch.clamp(torch.sum(torch.square(v.float()), dim=-1), min=1e-8))


def _vec_linear(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., V, 3) x (V, H) -> (..., H, 3)."""
    return torch.einsum("...vc,vh->...hc", v, w)


class _GVPBase(nn.Module):
    """Wh, Wu and the shared tail of a GVP: from the hidden vectors Vh and
    the scalar inputs to (feats_out, vectors_out)."""

    def __init__(self, dim_vectors_in: int, dim_vectors_out: int, gen: torch.Generator,
                 hidden_vectors: Optional[int], feats_activation: str, vectors_activation: str,
                 vector_gating: bool, dtype: str):
        super().__init__()
        if feats_activation not in ("silu", "identity"):
            raise ValueError(feats_activation)
        if vectors_activation not in ("sigmoid", "identity"):
            raise ValueError(vectors_activation)
        self.v_in = dim_vectors_in
        self.dim_h = hidden_vectors or max(dim_vectors_in, dim_vectors_out)
        self.v_out = dim_vectors_out
        self.Wh = nn.Parameter(uniform_((self.v_in, self.dim_h), 1.0 / math.sqrt(self.v_in), gen))
        self.Wu = nn.Parameter(uniform_((self.dim_h, self.v_out), 1.0 / math.sqrt(self.dim_h), gen))
        self.feats_activation = feats_activation
        self.vectors_activation = vectors_activation
        self.vector_gating = vector_gating
        self.cd = compute_dtype(dtype)

    def _gate(self, feats_out, Vu):
        if self.vector_gating:
            gating = self.scalar_to_vector_gates(feats_out)
        else:
            gating = _channel_norm(Vu).to(self.cd)
        gate = torch.sigmoid(gating) if self.vectors_activation == "sigmoid" else gating
        return feats_out, gate[..., None] * Vu

    def _act(self, feats_out):
        return F.silu(feats_out) if self.feats_activation == "silu" else feats_out


class GVP(_GVPBase):
    """One geometric vector perceptron (reference gvp.py:43-116)."""

    def __init__(self, dim_vectors_in: int, dim_vectors_out: int, dim_feats_in: int, dim_feats_out: int,
                 gen: torch.Generator, hidden_vectors: Optional[int] = None, feats_activation: str = "silu",
                 vectors_activation: str = "sigmoid", vector_gating: bool = True, dtype: str = "float32"):
        super().__init__(dim_vectors_in, dim_vectors_out, gen, hidden_vectors, feats_activation,
                         vectors_activation, vector_gating, dtype)
        self.to_feats_out = TorchLinear(dim_feats_in + self.dim_h, dim_feats_out, gen, dtype=dtype)
        if vector_gating:
            self.scalar_to_vector_gates = TorchLinear(dim_feats_out, dim_vectors_out, gen, dtype=dtype)

    def forward(self, feats: torch.Tensor, vectors: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cd = self.cd
        Vh = _vec_linear(vectors.to(cd), self.Wh.to(cd))
        Vu = _vec_linear(Vh, self.Wu.to(cd))
        s = torch.cat([feats.to(cd), _channel_norm(Vh).to(cd)], dim=-1)
        return self._gate(self._act(self.to_feats_out(s)), Vu)


class GVPChain(nn.Module):
    """A sequence of GVPs named gvp0, gvp1, ... (message and update functions)."""

    def __init__(self, specs: Sequence[dict], gen: torch.Generator, dtype: str = "float32"):
        super().__init__()
        self.n = len(specs)
        for i, spec in enumerate(specs):
            self.add_module(f"gvp{i}", GVP(**spec, gen=gen, dtype=dtype))

    def forward(self, feats, vectors):
        for i in range(self.n):
            feats, vectors = getattr(self, f"gvp{i}")(feats, vectors)
        return feats, vectors


class _SplitLinear(nn.Module):
    """TorchLinear over a concatenation without building it:
    concat(pieces) @ K + b == sum_i pieces[i] @ K[rows_i] + b, each term in
    the compute dtype, the pieces broadcast against each other in the sum.
    Parameters as TorchLinear's at fan_in = the pieces' total width."""

    def __init__(self, fan_in: int, features: int, gen: torch.Generator, dtype: str = "float32"):
        super().__init__()
        self.kernel = torch_kernel(fan_in, features, gen)
        self.bias = torch_bias(fan_in, features, gen)
        self.fan_in = fan_in
        self.cd = compute_dtype(dtype)

    def forward(self, pieces: List[torch.Tensor]) -> torch.Tensor:
        kc = self.kernel.to(self.cd)
        off, y = 0, None
        for piece in pieces:
            w = piece.shape[-1]
            t = piece.to(self.cd) @ kc[off:off + w]
            y = t if y is None else y + t
            off += w
        if off != self.fan_in:
            raise ValueError(f"pieces of total width {off}, expected {self.fan_in}")
        return y + self.bias.to(self.cd)


class GVPFactorizedFirst(_GVPBase):
    """The first GVP of a message chain on the pieces of its concatenated
    inputs: per-node pieces (broadcastable leading dims) meet the per-pair
    ones after their products, so the broadcast concat is never built.
    Parameters as GVP's (Wh, Wu, to_feats_out, scalar_to_vector_gates)."""

    def __init__(self, dim_vectors_in: int, dim_vectors_out: int, dim_feats_in: int, dim_feats_out: int,
                 gen: torch.Generator, hidden_vectors: Optional[int] = None, feats_activation: str = "silu",
                 vectors_activation: str = "sigmoid", vector_gating: bool = True, dtype: str = "float32"):
        super().__init__(dim_vectors_in, dim_vectors_out, gen, hidden_vectors, feats_activation,
                         vectors_activation, vector_gating, dtype)
        self.to_feats_out = _SplitLinear(dim_feats_in + self.dim_h, dim_feats_out, gen, dtype=dtype)
        if vector_gating:
            self.scalar_to_vector_gates = TorchLinear(dim_feats_out, dim_vectors_out, gen, dtype=dtype)

    def forward(self, scalar_pieces: List[torch.Tensor], vector_pieces: List[torch.Tensor]):
        cd = self.cd
        Wh = self.Wh.to(cd)
        off, Vh = 0, None
        for piece in vector_pieces:
            w = piece.shape[-2]
            t = _vec_linear(piece.to(cd), Wh[off:off + w])
            Vh = t if Vh is None else Vh + t
            off += w
        if off != self.v_in:
            raise ValueError(f"vector pieces of {off} channels, expected {self.v_in}")
        Vu = _vec_linear(Vh, self.Wu.to(cd))
        feats_out = self.to_feats_out(list(scalar_pieces) + [_channel_norm(Vh)])
        return self._gate(self._act(feats_out), Vu)


class FactorizedGVPChain(nn.Module):
    """GVPChain whose first GVP takes factorised inputs; same parameter names."""

    def __init__(self, specs: Sequence[dict], gen: torch.Generator, dtype: str = "float32"):
        super().__init__()
        self.n = len(specs)
        self.gvp0 = GVPFactorizedFirst(**specs[0], gen=gen, dtype=dtype)
        for i, spec in enumerate(specs[1:], start=1):
            self.add_module(f"gvp{i}", GVP(**spec, gen=gen, dtype=dtype))

    def forward(self, scalar_pieces, vector_pieces):
        feats, vectors = self.gvp0(scalar_pieces, vector_pieces)
        for i in range(1, self.n):
            feats, vectors = getattr(self, f"gvp{i}")(feats, vectors)
        return feats, vectors


class GVPLayerNorm(nn.Module):
    """LayerNorm on the scalars; vectors divided by
    sqrt(mean over channels of |v|^2 + eps) + eps (reference gvp.py:152-166),
    the norms in f32."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, eps)
        self.eps = eps

    def forward(self, feats, vectors):
        sq = torch.clamp(torch.sum(torch.square(vectors.float()), dim=-1), min=1e-8)  # (..., V)
        vn = torch.sqrt(torch.mean(sq, dim=-1, keepdim=True) + self.eps) + self.eps
        return self.LayerNorm_0(feats), vectors / vn[..., None].to(vectors.dtype)


def gvp_dropout_masks(gen: Optional[torch.Generator], feats: torch.Tensor, vectors: torch.Tensor, rate: float):
    """Keep masks for gvp_dropout: one per scalar, one per vector channel
    (all three components share it), drawn from `gen` (None: torch's
    default generator of the tensors' device)."""
    keep = 1.0 - rate
    ms = torch.rand(feats.shape, generator=gen, device=feats.device) < keep
    mv = torch.rand(vectors.shape[:-1], generator=gen, device=vectors.device) < keep
    return ms, mv


def apply_gvp_dropout(feats, vectors, masks, rate: float):
    ms, mv = masks
    keep = 1.0 - rate
    return feats * ms.to(feats.dtype) / keep, vectors * mv[..., None].to(vectors.dtype) / keep


def gvp_dropout(gen: Optional[torch.Generator], feats, vectors, rate: float):
    """Scalar dropout and vector-channel dropout (reference gvp.py:118-149)."""
    if rate == 0.0:
        return feats, vectors
    return apply_gvp_dropout(feats, vectors, gvp_dropout_masks(gen, feats, vectors, rate), rate)


def _message_specs(scalar_size, vector_size, n_gvps, extra_scalars, extra_vectors):
    """GVP dims of an edge message chain (reference gvp.py:198-224, 393-415)."""
    return [dict(dim_vectors_in=vector_size + (extra_vectors if i == 0 else 0), dim_vectors_out=vector_size,
                 dim_feats_in=scalar_size + (extra_scalars if i == 0 else 0), dim_feats_out=scalar_size)
            for i in range(n_gvps)]


def _update_specs(scalar_size, vector_size, n_gvps):
    return [dict(dim_vectors_in=vector_size, dim_vectors_out=vector_size, dim_feats_in=scalar_size,
                 dim_feats_out=scalar_size) for _ in range(n_gvps)]


class GVPEdgeMessages(nn.Module):
    """GVP edge messages of one edge type, aggregated to the destinations
    ('sum', or 'mean' over valid incoming edges). One parameter set
    (`message`, a FactorizedGVPChain) serves the three edge layouts of the
    JAX package's GVPEdgeMessages{Dense,Nbr,KNNPairs}, whose parameters are
    the same: `dense` over a (B, Ns, Nd) adjacency, `nbr` over a
    destination-major neighbor list (B, Nd, K), `pairs` over a kNN pair list
    (B, K, k) anchored at one node set. `forward` takes an edge set in any
    form of ops/edge_sets.py and runs the form it names; a `Blocks` runs
    `dense` on its windows, and a `KernelList` `nbr_kernel`. Only the GVP
    dynamics hands it a KernelList, where the message kernel runs: of a kk
    list and of both directions of the kNN pairs (`edge_sets.dst_major`: lk each
    keypoint's ligand sources, kl each ligand atom's keypoint senders), so
    that sampling on the card sums no message with a scatter-add."""

    def __init__(self, scalar_size: int, vector_size: int, gen: torch.Generator, n_message_gvps: int = 3,
                 rbf_dmax: float = 15.0, rbf_dim: int = 16, use_dst_feats: bool = False, edge_feat_size: int = 0,
                 agg: str = "sum", dtype: str = "float32"):
        super().__init__()
        if agg not in ("sum", "mean"):
            raise ValueError(agg)
        extra_v = 1 + (vector_size if use_dst_feats else 0)
        extra_s = rbf_dim + edge_feat_size + (scalar_size if use_dst_feats else 0)
        self.message = FactorizedGVPChain(_message_specs(scalar_size, vector_size, n_message_gvps, extra_s, extra_v),
                                          gen, dtype=dtype)
        self.rbf_dmax, self.rbf_dim = float(rbf_dmax), rbf_dim
        self.use_dst_feats = use_dst_feats
        self.edge_feat_size = edge_feat_size
        self.agg = agg
        self._pack = None  # (key, kernel operands) of nbr_kernel

    def forward(self, h_src, v_src, x_src, h_dst, v_dst, x_dst, edges, edge_feat=None, reduce=None):
        """-> (B, Nd, S), (B, Nd, V, 3) in f32 over the edge set `edges`.
        `reduce`, a kp-sharded rank's collective on its partial sums, as in
        `dense` (dense and pairs only)."""
        if torch.is_tensor(edges):
            return self.dense(h_src, v_src, x_src, h_dst, v_dst, x_dst, edges, edge_feat, reduce=reduce)
        if isinstance(edges, KernelList):
            return self.nbr_kernel(h_src, v_src, x_src, x_dst, edges)
        if isinstance(edges, NbrList):
            return self.nbr(h_src, v_src, x_src, h_dst, v_dst, x_dst, edges.idx, edges.valid, edge_feat)
        if isinstance(edges, PairList):
            src, dst = (h_src, v_src, x_src), (h_dst, v_dst, x_dst)
            anchor, other = (src, dst) if edges.anchor_is_src else (dst, src)
            return self.pairs(*anchor, *other, edges.idx, edges.valid, anchor_is_src=edges.anchor_is_src,
                              reduce=reduce)
        if isinstance(edges, Blocks):  # square over one node set: the sources'
            (hs, vs, xs), (hd, vd, xd), adj, ef = edges.grid((h_src, v_src, x_src), edge_feat)
            return edges.ungrid(*self.dense(hs, vs, xs, hd, vd, xd, adj, ef))
        refuse(edges)

    @property
    def kernel_ok(self) -> bool:
        """Whether the chain is in the message kernel's configuration
        (ops/cuda/gvp_message.py): three GVPs of its widths in bf16, the
        default activations and gates, no edge or destination features."""
        gvps = [getattr(self.message, f"gvp{i}") for i in range(self.message.n)]
        return (self.message.n == gvp_message.N_GVPS and self.edge_feat_size == 0 and not self.use_dst_feats
                and self.rbf_dim == gvp_message.RBF_DIM
                and all(g.cd == torch.bfloat16 and g.v_out == gvp_message.V_WIDTH and g.vector_gating
                        and g.feats_activation == "silu" and g.vectors_activation == "sigmoid"
                        and g.to_feats_out.kernel.shape[1] == gvp_message.S_WIDTH for g in gvps))

    def _kernel_weights(self):
        """nbr_kernel's operands of the chain, made once and cached until a
        parameter changes: its GVPLayers, the node matrix in the compute dtype
        (`gvp_message.node_matrix`) and, on CUDA, the kernel's images
        (`gvp_message.pack_weights`)."""
        params = tuple(self.parameters())
        key = tuple((p.data_ptr(), p._version, p.dtype) for p in params)
        if self._pack is None or self._pack[0] != key:
            layers = tuple(
                gvp_message.GVPLayer(g.Wh.detach(), g.Wu.detach(), g.to_feats_out.kernel.detach(),
                                     g.to_feats_out.bias.detach(), g.scalar_to_vector_gates.kernel.detach(),
                                     g.scalar_to_vector_gates.bias.detach())
                for g in (getattr(self.message, f"gvp{i}") for i in range(self.message.n)))
            dev = layers[0].k.device
            pack = gvp_message.pack_weights(layers, self.rbf_dmax) if gvp_message.kernel_device(dev) else None
            self._pack = (key, (layers, gvp_message.node_matrix(layers, self.message.gvp0.cd), pack))
        return self._pack[1]

    def nbr_kernel(self, h_src, v_src, x_src, x_dst, edges: NbrList):
        """Messages over a destination-major neighbor list through the
        message kernel's entry `gvp_message.gvp_message_list` (the CUDA
        kernel on CUDA tensors, its plain version on CPU tensors), forward
        only: GVP0's per-node pieces in one product, then the chain on the
        list's valid slots and their sum (or mean). The kernel's
        configuration only (`kernel_ok`)."""
        layers, node_w, pack = self._kernel_weights()
        f32 = torch.float32
        return gvp_message.gvp_message_list(
            gvp_message.node_rows(h_src, v_src, node_w), x_src.to(f32).contiguous(), x_dst.to(f32).contiguous(),
            layers, edges.idx, edges.valid, mean=self.agg == "mean", rbf_dmax=self.rbf_dmax,
            compute_dtype=self.message.gvp0.cd, pack=pack)

    def _messages(self, diff, valid, h_src, v_src, h_dst, v_dst, edge_feat=None):
        """Messages of the pairs whose (source - destination) offsets are
        `diff`; the node pieces broadcast to the pairs' rank."""
        diff = torch.where(valid[..., None], diff, 0.0)
        dij = norm_no_nan(diff, keepdim=True) + 1e-8
        x_unit = diff / dij
        rbf = rbf_embed(dij[..., 0], 0.0, self.rbf_dmax, self.rbf_dim)
        scalars = [h_src, rbf]
        vectors = [x_unit[..., None, :], v_src]
        if self.edge_feat_size > 0:
            scalars.append(edge_feat)
        if self.use_dst_feats:
            vectors.append(v_dst)
            scalars.append(h_dst)
        return self.message(scalars, vectors)

    def dense(self, h_src, v_src, x_src, h_dst, v_dst, x_dst, adj, edge_feat=None, reduce=None):
        """Messages over a dense (B, Ns, Nd) adjacency -> (B, Nd, S), (B, Nd, V, 3) in f32.
        `reduce(sum_s, sum_v, count)` (a kp-sharded rank's partial sums over
        its sources) runs on the sums and the mean's counts before the mean."""
        diff = x_src[:, :, None, :] - x_dst[:, None, :, :]
        ms, mv = self._messages(diff, adj, h_src[:, :, None], v_src[:, :, None], h_dst[:, None], v_dst[:, None],
                                edge_feat)
        a = adj.to(torch.float32)
        agg_s = torch.einsum("bsd,bsdf->bdf", a, ms.float())
        agg_v = torch.einsum("bsd,bsdvc->bdvc", a, mv.float())
        if reduce is not None:
            agg_s, agg_v, cnt = reduce(agg_s, agg_v, torch.sum(a, dim=1) if self.agg == "mean" else None)
        elif self.agg == "mean":
            cnt = torch.sum(a, dim=1)  # (B, Nd)
        if self.agg == "mean":
            cnt = torch.clamp(cnt, min=1.0)
            agg_s, agg_v = agg_s / cnt[..., None], agg_v / cnt[..., None, None]
        return agg_s, agg_v

    def _sum_over_k(self, ms, mv, valid):
        vf = valid[..., None].to(ms.dtype)
        agg_s = torch.sum((ms * vf).float(), dim=2)
        agg_v = torch.sum((mv * vf[..., None]).float(), dim=2)
        if self.agg == "mean":
            cnt = torch.clamp(torch.sum(vf.float(), dim=2), min=1.0)  # (B, N, 1)
            agg_s, agg_v = agg_s / cnt, agg_v / cnt[..., None]
        return agg_s, agg_v

    def nbr(self, h_src, v_src, x_src, h_dst, v_dst, x_dst, nbr_idx, nbr_valid, edge_feat=None):
        """Messages over a destination-major neighbor list (B, Nd, K) of
        source indices; a masked sum (or mean) over K."""
        diff = gather_rows(x_src, nbr_idx) - x_dst[:, :, None, :]
        ms, mv = self._messages(diff, nbr_valid, gather_rows(h_src, nbr_idx), gather_rows(v_src, nbr_idx),
                                h_dst[:, :, None], v_dst[:, :, None], edge_feat)
        return self._sum_over_k(ms, mv, nbr_valid)

    def pairs(self, h_anchor, v_anchor, x_anchor, h_other, v_other, x_other, idx, valid, anchor_is_src: bool,
              reduce=None):
        """Messages over a kNN pair list idx (B, K, k) into the other node set.
        anchor_is_src (kl): the anchor sends and the messages are summed onto
        the gathered nodes with a scatter-add (whose order on CUDA varies from
        run to run: the kernel's route takes kl as a destination-major list
        instead); otherwise (lk) the gathered nodes send to the anchor.
        `reduce` as in `dense` (kl only)."""
        b, K, k = idx.shape
        n_other = h_other.shape[1]
        h_g, x_g, v_g = gather_rows(h_other, idx), gather_rows(x_other, idx), gather_rows(v_other, idx)
        x_a = x_anchor[:, :, None, :]
        h_a, v_a = h_anchor[:, :, None], v_anchor[:, :, None]
        if anchor_is_src:
            ms, mv = self._messages(x_a - x_g, valid, h_a, v_a, h_g, v_g)
        else:
            ms, mv = self._messages(x_g - x_a, valid, h_g, v_g, h_a, v_a)
        if not anchor_is_src:
            return self._sum_over_k(ms, mv, valid)
        vf = valid[..., None].to(ms.dtype)
        flat = idx.reshape(b, K * k, 1)
        msg_s = (ms * vf).float().reshape(b, K * k, -1)
        msg_v = (mv * vf[..., None]).float().reshape(b, K * k, -1)
        agg_s = torch.zeros((b, n_other, msg_s.shape[-1]), dtype=torch.float32, device=ms.device)
        agg_s = agg_s.scatter_add_(1, flat.expand_as(msg_s), msg_s)
        agg_v = torch.zeros((b, n_other, msg_v.shape[-1]), dtype=torch.float32, device=ms.device)
        agg_v = agg_v.scatter_add_(1, flat.expand_as(msg_v), msg_v).reshape(b, n_other, *mv.shape[3:])
        cnt = None
        if self.agg == "mean":
            cnt = torch.zeros((b, n_other), dtype=torch.float32, device=ms.device)
            cnt = cnt.scatter_add_(1, flat[..., 0], valid.reshape(b, K * k).float())
        if reduce is not None:
            agg_s, agg_v, cnt = reduce(agg_s, agg_v, cnt)
        if self.agg == "mean":
            cnt = torch.clamp(cnt, min=1.0)
            agg_s, agg_v = agg_s / cnt[..., None], agg_v / cnt[..., None, None]
        return agg_s, agg_v
