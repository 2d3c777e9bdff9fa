"""EGNN noise-prediction dynamics (kpdiff_tpu/models/dynamics_egnn.py:70-365).

Ligand-ligand edges are a dense grid, the radius graph or, with ll_k > 0,
each ligand atom's ll_k nearest ligand atoms. Keypoint-ligand edges are,
with kl_k > 0, each keypoint's kl_k nearest ligand atoms and, with
kl_k == 0, the dense radius grid (B, K, Nl) on the kl cutoff, lk its
transpose. All edges are rebuilt from current positions on every call;
the kk edge set comes in from the encoder: dense (B, K, K), a `NbrList`
or the banded block layout `Blocks` over spatially sorted keypoints
(kk_layout 'block', the all-atom configs). The timestep is appended as a
feature channel, so the working width is hidden_nf + 1. Each conv layer
calls one `EGNNEdge` per edge type on its edge set, whatever its form
(ops/edge_sets.py).

The kNN kl edges change form with the route, decided once a call here
(`on_kernel`: CUDA tensors, nothing recording autograd). Where the edge
kernel is taken they are a dense (B, K, Nl) mask (lk its transpose);
elsewhere (training, the CPU, where a dense plain version would do the
whole grid's pair work) they stay a `PairList`, which EGNNEdge runs in its
`pairs` form. A kk neighbor list stays a list on either route: on the
kernel's it is handed on as a `KernelList` (its indices cast to int32
once a call), which EGNNEdge runs through the kernel's list mode
(`nbr_kernel`), so no (B, K, K) mask is built; elsewhere as the `NbrList`
it is, run in its `nbr` form. message_norm's kk edge count is read from
the list's `valid` on both routes. The counters dynamics.kl_route_kernel /
dynamics.kl_route_pairs (kNN kl and lk module calls) and
dynamics.kk_route_kernel / dynamics.kk_route_list (kk module calls of a
neighbor-list kk; a dense or block kk counts on neither) in
utils/profiling.py count the calls by route.

Every dense edge grid (ll, kl and lk while dense or a kNN mask, kk while
dense or the block windows) and a kk neighbor list go through the CUDA
edge kernel under no_grad, as the JAX package's sampler does with
`dynamics.use_pallas_sampling` for ll, dense kl, lk and dense kk; the JAX
package's kNN pairs, kk neighbor list and block branch never take its
Pallas kernel, the port's do. While autograd records the dense grids take
the kernel's plain version. `remat` recomputes each conv layer in the
backward pass (torch.utils.checkpoint), storing only the layer boundaries.

With `kp_shard` (parallel/kp_shard.py::ShardContext) the keypoint tensors
are this rank's rows: kl messages into the replicated ligand are partial
over the rank's keypoint sources and summed over the 'model' group, kk
takes every keypoint as a source (gathered h and x; a dense kk arrives as
(B, K, K/n), a neighbor list as (B, K/n, cap) indexing the global rows,
the block layout runs on the gathered keypoints and keeps its rows), lk
and the keypoint update stay local, and the message_norm 0 counts are
summed over the group.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from kpdiff_tpu_torch.models.egnn import EGNNEdge, NodeUpdate, records_grad
from kpdiff_tpu_torch.models.nn import MLP
from kpdiff_tpu_torch.ops.cuda.egnn_edge import kernel_device
from kpdiff_tpu_torch.ops.edge_sets import KernelList, PairList, edge_count, list_cap, transpose
from kpdiff_tpu_torch.ops.neighbors import dense_knn_adjacency, dense_radius_adjacency, knn_indices
from kpdiff_tpu_torch.utils import profiling
from kpdiff_tpu_torch.utils.profiling import device_mark


class EGNNConvLayer(nn.Module):
    """One heterograph EGNN layer: ll, kl and, with update_kp_feat, lk and
    kk, each one `EGNNEdge` call on its edge set in the form the dynamics
    built it (ops/edge_sets.py)."""

    def __init__(self, hidden_size: int, gen: torch.Generator, use_tanh: bool, update_kp_feat: bool,
                 norm: bool, dtype: str = "float32"):
        super().__init__()
        h = hidden_size
        self.update_kp_feat = update_kp_feat
        edge = dict(use_tanh=use_tanh, coords_range=10.0, dtype=dtype)
        self.edge_ll = EGNNEdge(h, h, gen, **edge)
        self.edge_kl = EGNNEdge(h, h, gen, **edge)
        if update_kp_feat:
            self.edge_lk = EGNNEdge(h, h, gen, **edge)
            self.edge_kk = EGNNEdge(h, h, gen, **edge)
            # one edge module's draws, unused: `gen` then gives every later
            # parameter the value a seed has always given it
            EGNNEdge(h, h, gen, **edge)
        self.update_lig = NodeUpdate(h, h, h, gen, norm=norm, dtype=dtype)
        if update_kp_feat:
            self.update_kp = NodeUpdate(h, h, h, gen, norm=norm, dtype=dtype)

    def forward(self, h, x, edges, z, masks, kp_shard=None):
        agg_h = {"lig": 0.0, "kp": 0.0}
        agg_x = {"lig": 0.0, "kp": 0.0}
        sh = kp_shard

        def add(dst, out):
            agg_h[dst] = agg_h[dst] + out[0]
            agg_x[dst] = agg_x[dst] + out[1]

        # the device timers' edge sets (utils/profiling.py): each mark opens the
        # next segment of the step; the tensors passed are the segment's inputs
        h_ll, x_ll = device_mark("ll", h["lig"], x["lig"])
        add("lig", self.edge_ll(h_ll, h_ll, x_ll, x_ll, edges["ll"]))
        # the replicated ligand as the keypoint edges of this rank see it
        h_lig, x_lig = (h["lig"], x["lig"]) if sh is None else sh.enter(h["lig"], x["lig"])
        h_kp, x_kp, h_lig, x_lig = device_mark("kl", h["kp"], x["kp"], h_lig, x_lig)
        kl = self.edge_kl(h_kp, h_lig, x_kp, x_lig, edges["kl"])
        add("lig", kl if sh is None else sh.reduce(*kl))
        if self.update_kp_feat:
            add("kp", self.edge_lk(h_lig, h_kp, x_lig, x_kp, edges["lk"]))
            h_src, x_src = (h["kp"], x["kp"]) if sh is None else sh.gather(h["kp"], x["kp"])
            h_src, x_src, h_kp, x_kp = device_mark("kk", h_src, x_src, h["kp"], x["kp"])
            kk = self.edge_kk(h_src, h_kp, x_src, x_kp, edges["kk"])
            add("kp", kk if sh is None else sh.dst_rows(edges["kk"], *kk))
        agg_h["lig"], agg_h["kp"], agg_x["lig"], agg_x["kp"] = device_mark(
            "rest", agg_h["lig"], agg_h["kp"], agg_x["lig"], agg_x["kp"])

        updated = ["lig", "kp"] if self.update_kp_feat else ["lig"]
        h_out, x_out = dict(h), dict(x)
        for ntype in updated:
            hn = agg_h[ntype] / z[ntype]
            xn = agg_x[ntype] / z[ntype]
            new_h = getattr(self, f"update_{ntype}")(h[ntype], hn)
            m = masks[ntype][..., None].to(new_h.dtype)
            h_out[ntype] = new_h * m
            x_out[ntype] = (x[ntype] + xn) * m
        return h_out, x_out


class EGNNDynamics(nn.Module):
    """Encode features, append t, run n_layers hetero EGNN layers, decode
    noise predictions (kpdiff_tpu/models/dynamics_egnn.py:194-365)."""

    def __init__(self, atom_nf: int, rec_nf: int, gen: torch.Generator, n_layers: int = 6,
                 hidden_nf: int = 256, use_tanh: bool = False, message_norm: float = 1.0,
                 update_kp_feat: bool = False, norm: bool = False, ll_k: int = 0, kl_k: int = 0,
                 ll_cutoff: float = 9.0, kl_cutoff: float = 8.0, compute_dtype: str = "float32",
                 z_semantics: str = "intent", remat: bool = False):
        super().__init__()
        self.n_layers = n_layers
        self.message_norm = message_norm
        self.update_kp_feat = update_kp_feat
        self.ll_k, self.kl_k = ll_k, kl_k
        self.ll_cutoff, self.kl_cutoff = ll_cutoff, kl_cutoff
        self.z_semantics = z_semantics
        self.remat = remat
        self.lig_encoder = MLP(atom_nf, [64, hidden_nf], ["silu", "silu"], gen)
        self.kp_encoder = (MLP(rec_nf, [2 * rec_nf, hidden_nf], ["silu", "silu"], gen)
                           if rec_nf != hidden_nf else None)
        for i in range(n_layers):
            self.add_module(f"conv{i}", EGNNConvLayer(
                hidden_nf + 1, gen, use_tanh=use_tanh, update_kp_feat=update_kp_feat, norm=norm,
                dtype=compute_dtype))
        self.lig_decoder = MLP(hidden_nf, [2 * atom_nf, atom_nf], ["silu", ""], gen)

    def kp_row_modules(self):
        """The modules that run on a kp-sharded rank's keypoint rows only: their
        parameter gradients are partial over the 'model' group."""
        mods = [] if self.kp_encoder is None else [self.kp_encoder]
        for i in range(self.n_layers):
            conv = getattr(self, f"conv{i}")
            mods += [getattr(conv, n) for n in ("edge_kl", "edge_lk", "edge_kk", "update_kp") if hasattr(conv, n)]
        return mods

    def on_kernel(self, *inputs) -> bool:
        """Whether the kNN kl and lk edges of a call on `inputs` go through
        the edge kernel as dense masks, and a neighbor-list kk through its
        list mode: the tensors where the kernel runs (CUDA) and nothing
        recording autograd. edge_kl, edge_lk and edge_kk are always in the
        kernel's configuration."""
        return kernel_device(inputs[0].device) and not records_grad(self, *inputs)

    def forward(self, lig_x, lig_h, lig_mask, kp_x, kp_h, kp_mask, t, kk_edges=None, kp_shard=None):
        """kp_shard: a ShardContext when the keypoint tensors are this rank's rows."""
        sh = kp_shard
        b, nl = lig_mask.shape
        k = kp_mask.shape[1]
        lig_feat = self.lig_encoder(lig_h)
        kp_feat = self.kp_encoder(kp_h) if self.kp_encoder is not None else kp_h

        t_col = t.to(lig_feat.dtype)[:, None, None]
        lig_feat = torch.cat([lig_feat, t_col.expand(b, nl, 1)], dim=-1) * lig_mask[..., None]
        kp_feat = torch.cat([kp_feat, t_col.expand(b, k, 1).to(kp_feat.dtype)], dim=-1) * kp_mask[..., None]

        if self.ll_k > 0:
            ll = dense_knn_adjacency(lig_x, lig_mask, lig_x, lig_mask, self.ll_k, per="dst", exclude_self=True)
        else:
            ll = dense_radius_adjacency(lig_x, lig_mask, lig_x, lig_mask, self.ll_cutoff, exclude_self=True)
        on_kernel = self.on_kernel(lig_x, lig_h, kp_x, kp_h, t)
        if self.kl_k > 0:
            profiling.count("dynamics.kl_route_kernel" if on_kernel else "dynamics.kl_route_pairs",
                            self.n_layers * (1 + int(self.update_kp_feat)))
            if on_kernel:
                # each keypoint's k nearest ligand atoms as a dense mask (a rank's keypoint rows give its own)
                kl = dense_knn_adjacency(kp_x, kp_mask, lig_x, lig_mask, self.kl_k, per="src")
                lk = kl.transpose(1, 2).contiguous()
            else:
                # the same edge set as an explicit pair list
                kl_idx, _dist, kl_valid = knn_indices(lig_x, lig_mask, kp_x, kp_mask, self.kl_k)
                kl = PairList(kl_idx, kl_valid & kp_mask[:, :, None])
                lk = transpose(kl)
        else:
            kl = dense_radius_adjacency(kp_x, kp_mask, lig_x, lig_mask, self.kl_cutoff)
            lk = transpose(kl)
        edges: Dict[str, object] = {"ll": ll, "kl": kl, "lk": lk}
        e_kl = edge_count(kl)
        if self.update_kp_feat:
            if kk_edges is None:
                raise ValueError("kk_edges required when update_kp_feat=True")
            edges["kk"] = kk_edges
            if list_cap(kk_edges):
                # edge_kk reads the list as it is (a rank's list indexes the global rows) on either route
                profiling.count("dynamics.kk_route_kernel" if on_kernel else "dynamics.kk_route_list",
                                self.n_layers)
                if on_kernel:  # the list mode's operands (int32 indices) once a call, not once a layer
                    edges["kk"] = KernelList.of(kk_edges)

        z = {}
        if self.message_norm == 0 and self.z_semantics == "executed":
            z["lig"] = z["kp"] = 1.0
        elif self.message_norm == 0:
            if sh is not None:
                e_kl = sh.count(e_kl)
            n_lig = torch.clamp(torch.sum(lig_mask, dim=1), min=1)
            e_lig = edge_count(ll) + e_kl
            z["lig"] = (e_lig / n_lig + 1.0)[:, None, None]
            if self.update_kp_feat:
                # kk as encoded: a neighbor list counts its valid slots on either route
                n_kp = torch.sum(kp_mask, dim=1)
                if sh is None:
                    e_kk = edge_count(kk_edges)
                else:
                    n_kp, e_kk = sh.count(n_kp), sh.edge_count(kk_edges)
                n_kp = torch.clamp(n_kp, min=1)
                z["kp"] = ((e_kl + e_kk) / n_kp + 1.0)[:, None, None]
            else:
                z["kp"] = 1.0
        else:
            z["lig"] = z["kp"] = float(self.message_norm)

        h = {"lig": lig_feat, "kp": kp_feat}
        x = {"lig": lig_x, "kp": kp_x}
        masks = {"lig": lig_mask, "kp": kp_mask}
        kp_h0, kp_x0 = kp_feat, kp_x
        for i in range(self.n_layers):
            if not self.update_kp_feat:
                h["kp"], x["kp"] = kp_h0, kp_x0
            conv = getattr(self, f"conv{i}")
            if self.remat and torch.is_grad_enabled():
                # the conv draws nothing: no RNG state to save (torch's saving reads the default
                # generator, which a CUDA graph capture does not allow)
                h, x = checkpoint(conv, h, x, edges, z, masks, sh, use_reentrant=False, preserve_rng_state=False)
            else:
                h, x = conv(h, x, edges, z, masks, sh)

        eps_h = self.lig_decoder(h["lig"][..., :-1])
        eps_x = x["lig"] - lig_x
        m = lig_mask[..., None]
        return eps_h * m, eps_x * m
