"""The forms an edge set takes, and the functions that read any of them.

An edge set joins source nodes to destination nodes of one batch:

- a dense (B, Ns, Nd) bool Tensor: source s to destination d where set
  (ll, kl and lk on the kernel's route, a dense kk);
- `NbrList(idx, valid)`: a destination-major (B, Nd, cap) list of source
  indices (kk after compact_kk or with kk_layout 'nbr', the encoders' rr);
  `KernelList`, a NbrList that the dynamics hands to a hand-written
  kernel (the EGNN edge kernel's list mode, the GVP message kernel), reads
  as one everywhere else;
- `PairList(idx, valid, anchor_is_src)`: the keypoint-anchored kNN pairs
  (B, K, k), idx into the other node set; the keypoints send (kl,
  anchor_is_src) or receive (lk, its `transpose`);
- `Blocks(adj)`: the banded block layout (B, nt, 3 * tile, tile) over
  spatially sorted nodes, each tile of `tile` destinations against the
  3 * tile sources of the previous, own and next tiles. It is square over
  one node set, run as one dense (B * nt, 3 * tile, tile) grid (`grid`).

Any other structure is refused with a TypeError, a plain tuple or dict
included: a list rebuilt as `tuple(...)` fails here, not in a dense branch.
Only where compact_kk's result enters sampling (`as_kk`) is a plain
(idx, valid) pair taken as the NbrList it stands for, since compact_kk's
contract is a bool Tensor or a 2-tuple.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from kpdiff_tpu_torch.ops.spatial import block_windows


class NbrList(NamedTuple):
    """Destination-major neighbor list: idx (B, Nd, cap) source indices, valid (B, Nd, cap)."""

    idx: torch.Tensor
    valid: torch.Tensor

    def adjacency(self, n_src: int) -> torch.Tensor:
        """The dense (B, Ns, Nd) bool mask of the list: source idx[b, d, j] to
        destination d wherever valid[b, d, j]. A slot that is not valid
        neither adds nor clears an edge, whatever source its index names."""
        b, nd, _ = self.idx.shape
        adj = torch.zeros((b, nd, n_src + 1), dtype=torch.bool, device=self.idx.device)
        adj.scatter_(-1, torch.where(self.valid, self.idx, n_src), True)  # slots not valid: the spare column
        return adj[..., :n_src].transpose(1, 2).contiguous()


class KernelList(NbrList):
    """A NbrList on a hand-written kernel's route: int32 idx, both tensors
    contiguous. Only the dynamics make one, where they take their kernel
    (models/dynamics_egnn.py::EGNNDynamics.on_kernel, the edge kernel's list
    mode in EGNNEdge; models/dynamics_gvp.py::GVPDynamics.on_kernel, the GVP
    message kernel in GVPEdgeMessages); any other reader takes it as the
    NbrList it is."""

    __slots__ = ()


class PairList(NamedTuple):
    """kNN pairs anchored at the keypoints: idx (B, K, k) into the other node
    set, valid (B, K, k); anchor_is_src: the keypoints are the sources."""

    idx: torch.Tensor
    valid: torch.Tensor
    anchor_is_src: bool = True


class Blocks(NamedTuple):
    """The banded block layout: adj (B, nt, 3 * tile, tile), window row against tile column."""

    adj: torch.Tensor

    def grid(self, nodes: Sequence[torch.Tensor], edge_feat=None):
        """The windows as one dense grid over the node tensors (B, N, ...) of
        the one node set: (sources (B * nt, 3 * tile, ...), destinations
        (B * nt, tile, ...), adjacency (B * nt, 3 * tile, tile), edge
        features (B, nt, 3 * tile, tile, E) -> (B * nt, 3 * tile, tile, E))."""
        b, nt, w, tile = self.adj.shape
        src = [block_windows(t, tile).reshape(b * nt, w, *t.shape[2:]) for t in nodes]
        dst = [t.reshape(b * nt, tile, *t.shape[2:]) for t in nodes]
        ef = None if edge_feat is None else edge_feat.reshape(b * nt, w, tile, -1)
        return src, dst, self.adj.reshape(b * nt, w, tile), ef

    def ungrid(self, *outs):
        """Per-destination outputs of the grid (B * nt, tile, ...) -> (B, N, ...)."""
        b, nt, _, tile = self.adj.shape
        return tuple(o.reshape(b, nt * tile, *o.shape[2:]) for o in outs)


def as_kk(kk):
    """compact_kk's result as an edge set: a plain (idx, valid) 2-tuple of
    Tensors becomes a NbrList; anything else is returned as it is."""
    if type(kk) is tuple and len(kk) == 2 and all(torch.is_tensor(t) for t in kk):
        return NbrList(*kk)
    return kk


def refuse(e):
    """Raise the TypeError of a structure that is no edge set."""
    raise TypeError(f"an edge set is a bool Tensor, NbrList, PairList or Blocks, not {type(e).__name__}")


def edge_count(e) -> torch.Tensor:
    """Edges per graph (B,) of an edge set in any form (an integer count)."""
    if torch.is_tensor(e):
        return torch.sum(e, dim=(1, 2))
    if isinstance(e, (NbrList, PairList)):
        return torch.sum(e.valid, dim=(1, 2))
    if isinstance(e, Blocks):
        return torch.sum(e.adj, dim=(1, 2, 3))
    refuse(e)


def layout_name(e) -> str:
    """'dense', 'nbr{cap}', 'pairs{k}' or 'block': the serve.chunks_kk_<layout> counters' names."""
    if torch.is_tensor(e):
        return "dense"
    if isinstance(e, NbrList):
        return f"nbr{int(e.idx.shape[-1])}"
    if isinstance(e, PairList):
        return f"pairs{int(e.idx.shape[-1])}"
    if isinstance(e, Blocks):
        return "block"
    refuse(e)


def list_cap(e) -> int:
    """Slots per destination of a neighbor list; 0 for any other form."""
    return int(e.idx.shape[-1]) if isinstance(e, NbrList) else 0


def transpose(e):
    """The edge set with sources and destinations swapped (dense and pairs)."""
    if torch.is_tensor(e):
        return e.transpose(1, 2)
    if isinstance(e, PairList):
        return e._replace(anchor_is_src=not e.anchor_is_src)
    refuse(e)
