"""Keypoint-axis model parallelism (kpdiff_tpu/parallel/kp_shard.py).

Each rank of the 'model' axis holds K/n keypoint rows and a whole copy of
the ligand. In JAX this is sharding annotations only and XLA inserts the
collectives; PyTorch has no such partitioner, so the port writes each one
and the models call them through a `ShardContext` (their `kp_shard=`
argument; None runs the single-device path unchanged):

- a replicated tensor entering a rank's rows (`rows`, `enter`): forward
  the identity (or a slice), backward an all-reduce of the gradient;
- partial sums leaving them (`reduce`: the kl messages into the ligand,
  counts, keypoint centres of mass): forward an all-reduce, backward the
  identity;
- `gather` of every keypoint's node tensors (kk needs all of them as
  sources): forward an all-gather, backward a reduce-scatter.

Collectives touch (B, K, H)- and (B, N_lig, H)-sized node tensors and
per-complex counts only, never a pair grid. kk is kept destination-major
on each rank: a dense kk becomes (B, K, K/n), every source to this rank's
destinations, and a neighbor list (B, K/n, cap) keeps its indices into the
global rows. If K does not divide the axis, the keypoint set is first
padded with masked rows (`pad_kp`), which is exact.

A ShardContext also carries the 'data' axis: the rows of the global batch
this rank holds, so that noise is drawn for the global batch and sliced
(each row gets the draw the single-device run gives it), and the data
group over which the training loss's normalising counts are summed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
from torch.autograd import Function

from kpdiff_tpu_torch.models.complex import PaddedComplex
from kpdiff_tpu_torch.ops.edge_sets import Blocks, NbrList, as_kk, edge_count, refuse

_gather_fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_scatter_fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _flat(xs, dim_keep: int):
    """Tensors sharing their first `dim_keep` dims -> one f32 tensor (..., F) and the pieces' layout."""
    meta = [(x.dtype, x.shape[dim_keep:]) for x in xs]
    flat = torch.cat([x.reshape(x.shape[:dim_keep] + (-1,)).float() for x in xs], dim=-1)
    return flat, meta


def _unflat(flat, meta):
    out, i = [], 0
    for dtype, tail in meta:
        n = int(torch.Size(tail).numel())
        out.append(flat[..., i:i + n].reshape(flat.shape[:-1] + tail).to(dtype))
        i += n
    return tuple(out)


def _all_reduce(flat, group):
    flat = flat.contiguous().clone()
    dist.all_reduce(flat, group=group)
    return flat


def _gather_rows(flat, group, n):
    """(B, k, F) -> (B, n*k, F): the group's rows in rank order."""
    xt = flat.transpose(0, 1).contiguous()
    out = torch.empty((n * xt.shape[0],) + xt.shape[1:], dtype=xt.dtype, device=xt.device)
    _gather_fn(out, xt, group=group)
    return out.transpose(0, 1)


def _scatter_rows(flat, group, n):
    """(B, n*k, F) summed over the group -> this rank's (B, k, F)."""
    xt = flat.transpose(0, 1).contiguous()
    out = torch.empty((xt.shape[0] // n,) + xt.shape[1:], dtype=xt.dtype, device=xt.device)
    _scatter_fn(out, xt, group=group)
    return out.transpose(0, 1)


class _Enter(Function):
    """Replicated -> used for this rank's part: forward identity, backward all-reduce."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat, meta = _flat(gs, 0)
        return (None,) + _unflat(_all_reduce(flat, ctx.group), meta)


class _Reduce(Function):
    """Partial sums -> sums over the group: forward all-reduce, backward identity."""

    @staticmethod
    def forward(ctx, group, *xs):
        flat, meta = _flat(xs, 0)
        return _unflat(_all_reduce(flat, group), meta)

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + gs


class _Gather(Function):
    """This rank's keypoint rows (dim 1) -> every row: forward all-gather, backward reduce-scatter."""

    @staticmethod
    def forward(ctx, group, n, *xs):
        ctx.group, ctx.n = group, n
        flat, meta = _flat(xs, 2)
        return _unflat(_gather_rows(flat, group, n), meta)

    @staticmethod
    def backward(ctx, *gs):
        flat, meta = _flat(gs, 2)
        return (None, None) + _unflat(_scatter_rows(flat, ctx.group, ctx.n), meta)


@dataclasses.dataclass(frozen=True)
class ShardContext:
    """A rank's place in a ('data', 'model') mesh, as the models see it.

    group/size/rank: the 'model' axis that splits the keypoints (group None:
    one rank, no collective). batch_rows/global_batch: this rank's rows of
    the global batch (None: it holds the whole batch). data_group/data_size:
    the 'data' axis, over which the loss sums its normalising counts."""

    group: Optional[Any] = None
    size: int = 1
    rank: int = 0
    batch_rows: Optional[slice] = None
    global_batch: Optional[int] = None
    data_group: Optional[Any] = None
    data_size: int = 1

    @property
    def sharded(self) -> bool:
        return self.group is not None

    def bounds(self, k_global: int) -> Tuple[int, int]:
        per = k_global // self.size
        return self.rank * per, (self.rank + 1) * per

    # ------------------------------------------------------------ collectives

    def enter(self, *xs):
        """Replicated tensors used by this rank's part of a sum."""
        out = _Enter.apply(self.group, *xs) if self.sharded else xs
        return out if len(xs) > 1 else out[0]

    def reduce(self, *xs):
        """Partial sums over this rank's keypoints -> the sums over all of them (None passes through)."""
        if not self.sharded:
            return xs if len(xs) > 1 else xs[0]
        idx = [i for i, x in enumerate(xs) if x is not None]
        red = _Reduce.apply(self.group, *(xs[i] for i in idx))
        out = list(xs)
        for i, r in zip(idx, red):
            out[i] = r
        return tuple(out) if len(xs) > 1 else out[0]

    def count(self, c: torch.Tensor) -> torch.Tensor:
        """A count over this rank's keypoints -> over all of them (no gradient)."""
        if not self.sharded:
            return c
        c = c.detach().clone()
        dist.all_reduce(c, group=self.group)
        return c

    def edge_count(self, e) -> torch.Tensor:
        """Edges per graph of edge set `e` into the keypoints, over every
        keypoint: this rank's summed over the group, but for the block
        layout, which every rank holds whole."""
        c = edge_count(e)
        return c if isinstance(e, Blocks) else self.count(c)

    def dst_rows(self, e, *outs):
        """Outputs of edge set `e` into the keypoints -> this rank's rows: the
        block layout runs on every keypoint (the gathered ones), any other
        form on this rank's destinations already."""
        if not isinstance(e, Blocks):
            return outs
        lo, hi = self.bounds(outs[0].shape[1])
        return tuple(o[:, lo:hi] for o in outs)

    def gather(self, *xs):
        """This rank's keypoint rows (dim 1) -> every keypoint's."""
        out = _Gather.apply(self.group, self.size, *xs) if self.sharded else xs
        return out if len(xs) > 1 else out[0]

    def rows(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's keypoint rows (dim 1) of a replicated tensor."""
        if x is None:
            return None
        lo, hi = self.bounds(x.shape[1])
        return (self.enter(x) if x.requires_grad else x)[:, lo:hi]

    def masked_com(self, pos: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Centre of mass over every keypoint of (B, k, 3) rows -> (B, 3)."""
        m = mask[..., None].to(pos.dtype)
        total, cnt = self.reduce(torch.sum(pos * m, dim=1), torch.sum(m, dim=1))
        return total / torch.clamp(cnt, min=1.0)

    # ------------------------------------------------------------- data axis

    def local_batch(self, x, dim: int = 0):
        """This rank's rows of a tensor holding the global batch along `dim`
        (unchanged when it already holds only this rank's rows)."""
        if x is None or self.batch_rows is None or x.shape[dim] != self.global_batch:
            return x
        return x.narrow(dim, self.batch_rows.start, self.batch_rows.stop - self.batch_rows.start)

    def draw_shape(self, shape, dim: int = 0):
        """The shape of a draw for the global batch."""
        if self.batch_rows is None:
            return tuple(shape)
        s = list(shape)
        s[dim] = self.global_batch
        return tuple(s)

    def mean_den(self, count: torch.Tensor, floor: float = 1.0) -> torch.Tensor:
        """A loss's normalising count summed over the data axis, divided by its
        size: each rank's loss is then its part of the global mean times the
        axis size, so the mean over ranks (and of their gradients) is the
        global one."""
        if self.data_group is None:
            return torch.clamp(count, min=floor)
        c = count.detach().clone()
        dist.all_reduce(c, group=self.data_group)
        return torch.clamp(c, min=floor) / self.data_size

    # ------------------------------------------------------------ the complex

    def split(self, cpx: PaddedComplex, kk):
        """This rank's keypoint rows of an encoded complex and its kk edges
        (K must divide the axis size; `shard_encoded` pads first).
        Differentiable: the rows' gradients reach the replicated encoder."""
        K = cpx.kp_x.shape[1]
        if K % self.size:
            raise ValueError(f"n_keypoints {K} must be divisible by the 'model' axis size {self.size} for "
                             "kp-sharded training (sampling pads instead: shard_encoded)")
        if not self.sharded:
            return cpx, kk
        lo, hi = self.bounds(K)
        cpx = cpx.replace(kp_x=self.rows(cpx.kp_x), kp_h=self.rows(cpx.kp_h), kp_mask=cpx.kp_mask[:, lo:hi],
                          kp_v=self.rows(cpx.kp_v))
        if isinstance(kk, NbrList):  # (B, K, cap) into the global rows
            kk = NbrList(kk.idx[:, lo:hi], kk.valid[:, lo:hi])
        elif torch.is_tensor(kk):  # dense (B, Ns, Nd): every source to this rank's destinations
            kk = kk[:, :, lo:hi]
        elif not isinstance(kk, Blocks):  # the block layout stays whole: the dynamics run it on gathered keypoints
            refuse(kk)
        return cpx, kk


def _pad_axis(x: torch.Tensor, dim: int, new: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = new - x.shape[dim]
    return torch.cat([x, torch.zeros(shape, dtype=x.dtype, device=x.device)], dim=dim)


def pad_kp(enc: PaddedComplex, kk, multiple: int):
    """Pad the keypoint axis of an encoded complex (and its kk edges) with
    masked rows up to the next multiple of `multiple`. Exact: every keypoint
    consumer reduces under kp_mask, and neighbor-list indices keep referring
    to the original (unmoved) rows."""
    K = enc.kp_x.shape[1]
    Kp = -(-K // multiple) * multiple
    if isinstance(kk, Blocks) and Kp != K:
        raise ValueError("block kk layout tiles the kp axis and cannot be row-padded; "
                         "use compact_kk (exact) before kp-sharding")
    if Kp == K:
        return enc, kk
    enc = enc.replace(kp_x=_pad_axis(enc.kp_x, 1, Kp), kp_h=_pad_axis(enc.kp_h, 1, Kp),
                      kp_mask=_pad_axis(enc.kp_mask, 1, Kp),
                      kp_v=None if enc.kp_v is None else _pad_axis(enc.kp_v, 1, Kp))
    if isinstance(kk, NbrList):
        kk = NbrList(_pad_axis(kk.idx, 1, Kp), _pad_axis(kk.valid, 1, Kp))
    elif torch.is_tensor(kk):  # dense (B, K, K)
        kk = _pad_axis(_pad_axis(kk, 1, Kp), 2, Kp)
    else:
        refuse(kk)
    return enc, kk


def kp_constraint(mesh, local_batch: int, axis: str = "model", batch_axis: str = "data") -> ShardContext:
    """The ShardContext of this rank for a training step on its `local_batch`
    rows: keypoints split over `axis` (K must divide its size; checked when
    the loss splits them), the batch over `batch_axis`. The encoder runs
    unsharded on every rank of `axis`, and the loss splits its outputs."""
    nd, d = mesh.size(batch_axis), mesh.index(batch_axis)
    return ShardContext(
        group=mesh.group(axis), size=mesh.size(axis), rank=mesh.index(axis),
        batch_rows=slice(d * local_batch, (d + 1) * local_batch), global_batch=local_batch * nd,
        data_group=mesh.group(batch_axis), data_size=nd)


def shard_encoded(enc: PaddedComplex, kk, mesh, axis: str = "model", batch_axis: Optional[str] = None):
    """This rank's part of an encoded complex of the global batch: its
    keypoint rows over `axis` (K padded to a multiple of the axis size first)
    and, with `batch_axis`, its batch rows. Returns (enc, kk, ShardContext)
    for `KeypointDiffusion.sample(..., kp_shard=)`."""
    from kpdiff_tpu_torch.parallel.mesh import batch_rows, shard_batch

    n = mesh.size(axis)
    kk = as_kk(kk)
    if isinstance(kk, Blocks) and n > 1:
        raise ValueError("kp-sharding the block kk layout is unsupported; run model.compact_kk first "
                         "(exact rebuild)")
    b = enc.batch_size
    rows_ = None
    if batch_axis is not None:
        rows_ = batch_rows(b, mesh, batch_axis)
        enc, kk = shard_batch(enc, mesh, batch_axis), shard_batch(kk, mesh, batch_axis)
    enc, kk = pad_kp(enc, kk, n)
    ctx = ShardContext(group=mesh.group(axis), size=n, rank=mesh.index(axis), batch_rows=rows_,
                       global_batch=b if rows_ is not None else None,
                       data_group=mesh.group(batch_axis) if batch_axis else None,
                       data_size=mesh.size(batch_axis) if batch_axis else 1)
    enc, kk = ctx.split(enc, kk)
    return enc, kk, ctx


def data_shard(mesh, global_batch: int, axis: str = "data") -> ShardContext:
    """The ShardContext of a data-parallel sample: this rank's rows of the
    global batch, keypoints whole."""
    from kpdiff_tpu_torch.parallel.mesh import batch_rows

    return ShardContext(batch_rows=batch_rows(global_batch, mesh, axis), global_batch=global_batch,
                        data_group=mesh.group(axis), data_size=mesh.size(axis))
