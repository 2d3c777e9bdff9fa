"""GVP noise-prediction dynamics (kpdiff_tpu/models/dynamics_gvp.py).

Unlike the EGNN dynamics, the timestep joins the scalars before the
encoders, positions never move (the noise vector comes from a GVP chain,
`NoisePredictionBlock`), and with update_kp the last conv drops the lk and
kk edge types. message_norm: 'mean' averages over valid incoming edges,
0 divides the sums by the average in-degree + 1, a number divides the sums
by it.

Edges: ll is a dense grid rebuilt every call (the radius graph, or with
ll_k > 0 each ligand atom's ll_k nearest ligand atoms), kl and lk a kNN
pair list (`PairList`, kl_k per keypoint) or with kl_k == 0 the dense
radius grid on the kl cutoff and its transpose, kk the encoder's edge
set, dense (B, K, K), a `NbrList` or the banded block layout `Blocks`
(ops/edge_sets.py); each edge type's `GVPEdgeMessages` runs the form of
its edge set. The JAX package has no TPU kernel on this path. Where the
message kernel runs (`on_kernel`: CUDA tensors, nothing recording autograd,
no kp_shard, the message modules in the kernel's configuration), a kk
neighbor list and both directions of the kNN pairs reach their message
modules as `KernelList`s, which run the hand-written kernel
(ops/cuda/gvp_message.py): lk as each keypoint's list of ligand sources,
kl as each ligand atom's list of keypoint senders (`dst_major`, built once
a call for every conv; its sums in keypoint order, so no scatter-add and
one summation order from run to run). Everything else (training, the CPU,
the dense and block kk, kl_k 0's dense grids, the kp-sharded route) runs
in plain PyTorch. Counters dynamics.gvp_kl_route_kernel /
gvp_kl_route_pairs, dynamics.gvp_lk_route_kernel / gvp_lk_route_pairs and
dynamics.gvp_kk_route_kernel / gvp_kk_route_list count the kl, lk and kk
module calls by route. Dropout (training only) draws
its masks from a torch.Generator before each conv, so that `remat`
(torch.utils.checkpoint per conv) recomputes the backward with the same
masks.

With `kp_shard` (parallel/kp_shard.py::ShardContext) the keypoint tensors
are this rank's rows, as in the EGNN dynamics: kl messages into the
ligand (sums, and the counts of 'mean') are summed over the 'model' group,
kk takes the gathered keypoints as sources (the block layout runs on them
whole and keeps this rank's rows), lk and the keypoint updates stay local,
and the message_norm 0 counts are summed over the group. Keypoint dropout
masks are drawn for every keypoint and sliced, as the unsharded run draws them.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from kpdiff_tpu_torch.models.gvp import (
    GVP,
    GVPChain,
    GVPEdgeMessages,
    GVPLayerNorm,
    _update_specs,
    apply_gvp_dropout,
    gvp_dropout_masks,
)
from kpdiff_tpu_torch.models.egnn import records_grad
from kpdiff_tpu_torch.models.nn import LayerNorm, TorchLinear
from kpdiff_tpu_torch.ops.cuda.gvp_message import kernel_device
from kpdiff_tpu_torch.ops.edge_sets import KernelList, PairList, dst_major, edge_count, list_cap, transpose
from kpdiff_tpu_torch.ops.neighbors import dense_knn_adjacency, dense_radius_adjacency, knn_indices
from kpdiff_tpu_torch.utils import profiling
from kpdiff_tpu_torch.utils.profiling import device_mark

EDGE_SLOT = {"ll": "ll", "kl": "kl", "lk": "kl", "kk": "kk"}  # each edge type's device-timer slot


class GVPMultiEdgeConv(nn.Module):
    """One conv over several edge types with a residual update per
    destination node type (kpdiff_tpu's GVPMultiEdgeConvDense). Each edge
    type's layout follows its structure in `adj`."""

    def __init__(self, etypes: Tuple[Tuple[str, str, str], ...], scalar_size: int, vector_size: int,
                 gen: torch.Generator, n_message_gvps: int = 3, n_update_gvps: int = 2,
                 message_norm: Union[float, str] = 10, dropout: float = 0.0, dtype: str = "float32"):
        super().__init__()
        self.etypes = tuple(etypes)
        self.dst_ntypes = sorted({e[2] for e in self.etypes})
        self.message_norm = message_norm
        self.dropout = float(dropout)
        agg = "mean" if message_norm == "mean" else "sum"
        for _, ename, _ in self.etypes:
            self.add_module(f"message_{ename}", GVPEdgeMessages(
                scalar_size, vector_size, gen, n_message_gvps=n_message_gvps, rbf_dmax=15.0, agg=agg, dtype=dtype))
        for ntype in self.dst_ntypes:
            self.add_module(f"msg_norm_{ntype}", GVPLayerNorm(scalar_size))
            self.add_module(f"update_{ntype}", GVPChain(_update_specs(scalar_size, vector_size, n_update_gvps), gen,
                                                        dtype=dtype))
            self.add_module(f"upd_norm_{ntype}", GVPLayerNorm(scalar_size))

    def dropout_masks(self, node_data, gen: Optional[torch.Generator], kp_shard=None):
        """Keep masks of this conv's dropout: per destination node type, one
        pair for the aggregated messages and one for the update's residual."""
        if self.dropout <= 0:
            return None
        out = {}
        for ntype in self.dst_ntypes:
            h, _, v = node_data[ntype]
            if ntype == "kp" and kp_shard is not None and kp_shard.sharded:
                k = h.shape[1] * kp_shard.size
                h, v = h.new_empty((h.shape[0], k) + h.shape[2:]), v.new_empty((v.shape[0], k) + v.shape[2:])
                lo, hi = kp_shard.bounds(k)
                out[ntype] = tuple(tuple(m[:, lo:hi] for m in gvp_dropout_masks(gen, h, v, self.dropout))
                                   for _ in range(2))
            else:
                out[ntype] = (gvp_dropout_masks(gen, h, v, self.dropout), gvp_dropout_masks(gen, h, v, self.dropout))
        return out

    def _edge(self, src, ename, dst, node_data, a, kp_src=None, reduce=None):
        """kp_src: the keypoints as kk sources (a kp-sharded rank's gathered
        rows); reduce: the kl sums' collective (ShardContext.reduce)."""
        h_s, x_s, v_s = kp_src if (kp_src is not None and src == dst == "kp") else node_data[src]
        h_d, x_d, v_d = node_data[dst]
        return getattr(self, f"message_{ename}")(h_s, v_s, x_s, h_d, v_d, x_d, a, reduce=reduce)

    def forward(self, node_data, adj, masks, drop=None, kp_shard=None):
        """node_data: ntype -> (scalars, positions, vectors); drop: the masks
        of `dropout_masks`, or None (no dropout); kp_shard: a ShardContext
        when the keypoint tensors are this rank's rows."""
        agg_s = {n: 0.0 for n in self.dst_ntypes}
        agg_v = {n: 0.0 for n in self.dst_ntypes}
        sh = kp_shard
        data, kp_src = node_data, None
        if sh is not None:
            # the replicated ligand as the keypoint edges of this rank see it
            data = dict(node_data, lig=sh.enter(*node_data["lig"]))
            if any(e[0] == e[2] == "kp" for e in self.etypes):
                kp_src = sh.gather(*node_data["kp"])
        for src, ename, dst in self.etypes:
            if sh is None:
                # the device timers' edge sets (utils/profiling.py); the node tensors pass through the mark
                marked = device_mark(EDGE_SLOT[ename], *node_data["lig"], *node_data["kp"])
                ds, dv = self._edge(src, ename, dst, {"lig": marked[:3], "kp": marked[3:]}, adj[ename])
            elif src == dst == "lig":
                ds, dv = self._edge(src, ename, dst, node_data, adj[ename])
            else:
                ds, dv = self._edge(src, ename, dst, data, adj[ename], kp_src=kp_src,
                                    reduce=sh.reduce if dst == "lig" else None)
                if dst == "kp":
                    ds, dv = sh.dst_rows(adj[ename], ds, dv)
            agg_s[dst] = agg_s[dst] + ds
            agg_v[dst] = agg_v[dst] + dv
        n = len(self.dst_ntypes)
        marked = device_mark("rest", *(agg_s[t] for t in self.dst_ntypes), *(agg_v[t] for t in self.dst_ntypes))
        agg_s, agg_v = dict(zip(self.dst_ntypes, marked[:n])), dict(zip(self.dst_ntypes, marked[n:]))

        out = dict(node_data)
        for ntype in self.dst_ntypes:
            h, x, v = node_data[ntype]
            if self.message_norm == "mean":
                s_msg, v_msg = agg_s[ntype], agg_v[ntype]
            elif self.message_norm == 0:
                n_nodes = torch.sum(masks[ntype], dim=1)
                # edges with a keypoint end are a kp-sharded rank's (ShardContext.edge_count)
                counts = [(edge_count if sh is None or e[0] == e[2] == "lig" else sh.edge_count)(adj[e[1]]).float()
                          for e in self.etypes if e[2] == ntype]
                if sh is not None and ntype == "kp":
                    n_nodes = sh.count(n_nodes)
                n_nodes = torch.clamp(n_nodes, min=1).float()
                n_edges = sum(counts)
                norm = (n_edges / n_nodes + 1.0)[:, None, None]
                s_msg, v_msg = agg_s[ntype] / norm, agg_v[ntype] / norm[..., None]
            else:
                norm = float(self.message_norm)
                s_msg, v_msg = agg_s[ntype] / norm, agg_v[ntype] / norm
            if drop is not None:
                s_msg, v_msg = apply_gvp_dropout(s_msg, v_msg, drop[ntype][0], self.dropout)
            h, v = getattr(self, f"msg_norm_{ntype}")(h + s_msg, v + v_msg)
            s_res, v_res = getattr(self, f"update_{ntype}")(h, v)
            s_res, v_res = s_res.to(h.dtype), v_res.to(v.dtype)
            if drop is not None:
                s_res, v_res = apply_gvp_dropout(s_res, v_res, drop[ntype][1], self.dropout)
            h, v = getattr(self, f"upd_norm_{ntype}")(h + s_res, v + v_res)
            m = masks[ntype][..., None].to(h.dtype)
            out[ntype] = (h * m, x, v * m[..., None])
        return out


class NoisePredictionBlock(nn.Module):
    """GVP chain -> (scalar noise, one noise vector) (reference dynamics_gvp.py:10-44)."""

    def __init__(self, in_scalar_dim: int, out_scalar_dim: int, vector_size: int, gen: torch.Generator,
                 n_gvps: int = 3, intermediate_scalar_dim: int = 64):
        super().__init__()
        self.n = n_gvps
        for i in range(n_gvps):
            last = i == n_gvps - 1
            self.add_module(f"gvp{i}", GVP(vector_size, 1 if last else vector_size, in_scalar_dim,
                                           intermediate_scalar_dim if last else in_scalar_dim, gen,
                                           vectors_activation="identity" if last else "sigmoid"))
        self.to_scalar_output = TorchLinear(intermediate_scalar_dim, out_scalar_dim, gen)

    def forward(self, scalars, vectors):
        for i in range(self.n):
            scalars, vectors = getattr(self, f"gvp{i}")(scalars, vectors)
        return self.to_scalar_output(scalars), vectors[..., 0, :]


class GVPDynamics(nn.Module):
    """LigRecDynamicsGVP (kpdiff_tpu/models/dynamics_gvp.py:185-343)."""

    NO_KP_EDGES = (("lig", "ll", "lig"), ("kp", "kl", "lig"))
    KP_EDGES = NO_KP_EDGES + (("lig", "lk", "kp"), ("kp", "kk", "kp"))

    def __init__(self, n_lig_scalars: int, n_kp_scalars: int, gen: torch.Generator, vector_size: int = 16,
                 n_convs: int = 4, n_hidden_scalars: int = 128, message_norm: Union[float, str] = 1,
                 update_kp: bool = False, ll_k: int = 0, kl_k: int = 0, ll_cutoff: float = 9.0,
                 kl_cutoff: float = 8.0, n_message_gvps: int = 3, n_update_gvps: int = 2, n_noise_gvps: int = 3,
                 dropout: float = 0.0, compute_dtype: str = "float32", kk_layout: str = "dense",
                 kk_block_size: int = 64, remat: bool = False):
        super().__init__()
        # kk_layout and kk_block_size are read by KeypointDiffusion when it builds kk
        H = n_hidden_scalars
        self.vector_size = vector_size
        self.n_convs = n_convs
        self.update_kp = update_kp
        self.ll_k, self.kl_k = ll_k, kl_k
        self.ll_cutoff, self.kl_cutoff = ll_cutoff, kl_cutoff
        self.remat = remat
        self.lig_enc = TorchLinear(n_lig_scalars + 1, H, gen)
        self.kp_enc = TorchLinear(n_kp_scalars + 1, H, gen)
        self.LayerNorm_0 = LayerNorm(H)  # ligand scalars
        self.LayerNorm_1 = LayerNorm(H)  # keypoint scalars
        for i in range(n_convs):
            etypes = self.NO_KP_EDGES if (not update_kp or i == n_convs - 1) else self.KP_EDGES
            self.add_module(f"conv{i}", GVPMultiEdgeConv(
                etypes, H, vector_size, gen, n_message_gvps=n_message_gvps, n_update_gvps=n_update_gvps,
                message_norm=message_norm, dropout=dropout, dtype=compute_dtype))
        self.noise_predictor = NoisePredictionBlock(H, n_lig_scalars, vector_size, gen, n_gvps=n_noise_gvps)

    def kp_row_modules(self):
        """The modules that run on a kp-sharded rank's keypoint rows only: their
        parameter gradients are partial over the 'model' group."""
        mods = [self.kp_enc, self.LayerNorm_1]
        for i in range(self.n_convs):
            conv = getattr(self, f"conv{i}")
            mods += [getattr(conv, n) for n in ("message_kl", "message_lk", "message_kk", "msg_norm_kp",
                                                "update_kp", "upd_norm_kp") if hasattr(conv, n)]
        return mods

    def on_kernel(self, kp_shard, *inputs) -> bool:
        """Whether the kNN pairs and a kk neighbor list of a call on `inputs`
        go through the message kernel: the tensors where it runs (CUDA),
        nothing recording autograd, no kp_shard, and the convs' kl, lk and kk
        message modules in its configuration (`GVPEdgeMessages.kernel_ok`)."""
        mods = [getattr(getattr(self, f"conv{i}"), f"message_{e}") for i in range(self.n_convs)
                for e in ("kl", "lk", "kk") if hasattr(getattr(self, f"conv{i}"), f"message_{e}")]
        return (kernel_device(inputs[0].device) and kp_shard is None and not records_grad(self, *inputs)
                and all(m.kernel_ok for m in mods))

    def forward(self, lig_x, lig_h, lig_mask, kp_x, kp_h, kp_mask, t, kk_edges=None, kp_v=None,
                dropout: bool = False, generator: Optional[torch.Generator] = None, kp_shard=None):
        """-> (eps_h, eps_x). dropout=True (the training loss) applies the
        configured dropout with masks drawn from `generator`; kp_shard: a
        ShardContext when the keypoint tensors are this rank's rows."""
        b, nl = lig_mask.shape
        k = kp_mask.shape[1]
        t_col = t[:, None, None]
        lig_s = torch.cat([lig_h, t_col.expand(b, nl, 1).to(lig_h.dtype)], dim=-1)
        kp_s = torch.cat([kp_h, t_col.expand(b, k, 1).to(kp_h.dtype)], dim=-1)
        lig_s = self.LayerNorm_0(F.silu(self.lig_enc(lig_s))) * lig_mask[..., None]
        kp_s = self.LayerNorm_1(F.silu(self.kp_enc(kp_s))) * kp_mask[..., None]
        lig_v = torch.zeros((b, nl, self.vector_size, 3), dtype=lig_s.dtype, device=lig_s.device)
        if kp_v is None:
            kp_v = torch.zeros((b, k, self.vector_size, 3), dtype=kp_s.dtype, device=kp_s.device)

        if self.ll_k > 0:
            ll = dense_knn_adjacency(lig_x, lig_mask, lig_x, lig_mask, self.ll_k, per="dst", exclude_self=True)
        else:
            ll = dense_radius_adjacency(lig_x, lig_mask, lig_x, lig_mask, self.ll_cutoff, exclude_self=True)
        if self.kl_k > 0:
            kl_idx, _dist, kl_valid = knn_indices(lig_x, lig_mask, kp_x, kp_mask, self.kl_k)
            kl = PairList(kl_idx, kl_valid & kp_mask[:, :, None])
        else:
            kl = dense_radius_adjacency(kp_x, kp_mask, lig_x, lig_mask, self.kl_cutoff)
        adj = {"ll": ll, "kl": kl}
        on_kernel = self.on_kernel(kp_shard, lig_x, lig_h, kp_x, kp_h, t, kp_v)
        if isinstance(kl, PairList):
            profiling.count("dynamics.gvp_kl_route_kernel" if on_kernel else "dynamics.gvp_kl_route_pairs",
                            self.n_convs)
            if on_kernel:  # kl: each ligand atom's keypoint senders, int32, once a call for every conv
                adj["kl"] = KernelList.of(dst_major(kl, nl))
        if self.update_kp:
            if kk_edges is None:
                raise ValueError("kk_edges required when update_kp=True")
            adj["lk"] = transpose(kl)
            adj["kk"] = kk_edges
            n_kp_convs = self.n_convs - 1  # the last conv has no lk or kk
            if isinstance(kl, PairList):
                profiling.count("dynamics.gvp_lk_route_kernel" if on_kernel else "dynamics.gvp_lk_route_pairs",
                                n_kp_convs)
                if on_kernel:  # lk: each keypoint's list of ligand sources
                    adj["lk"] = KernelList.of(dst_major(adj["lk"], k))
            if list_cap(kk_edges):
                profiling.count("dynamics.gvp_kk_route_kernel" if on_kernel else "dynamics.gvp_kk_route_list",
                                n_kp_convs)
                if on_kernel:
                    adj["kk"] = KernelList.of(kk_edges)

        node_data = {"lig": (lig_s, lig_x, lig_v), "kp": (kp_s, kp_x, kp_v)}
        masks = {"lig": lig_mask, "kp": kp_mask}
        for i in range(self.n_convs):
            conv = getattr(self, f"conv{i}")
            drop = conv.dropout_masks(node_data, generator, kp_shard) if dropout else None
            if self.remat and torch.is_grad_enabled():
                # the masks are drawn above: the conv draws nothing, so no RNG state is saved
                node_data = checkpoint(conv, node_data, adj, masks, drop, kp_shard, use_reentrant=False,
                                       preserve_rng_state=False)
            else:
                node_data = conv(node_data, adj, masks, drop, kp_shard)

        lig_s, _, lig_v = node_data["lig"]
        eps_h, eps_x = self.noise_predictor(lig_s, lig_v)
        m = lig_mask[..., None]
        return eps_h * m, eps_x * m
