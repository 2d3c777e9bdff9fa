"""Device mesh over the ranks of a process group (kpdiff_tpu/parallel/mesh.py).

A JAX mesh is an array of devices that XLA's partitioner reads. Here each
rank is one device, and a mesh is this rank's coordinates on named axes
plus one process group per axis (the ranks that differ from it along that
axis only). Rank r sits at np.unravel_index(r, shape): with a
('data', 'model') mesh of (dp, mp), the model groups are runs of mp
consecutive ranks. The 'data' axis splits the batch (`shard_batch`);
parameters are replicated (`replicate_params`). Outside a process group
a mesh has one rank and no groups, and every collective on it is skipped.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from kpdiff_tpu_torch.device import resolve_device
from kpdiff_tpu_torch.parallel.distributed import in_group, local_device, rank, visible_devices, world_size
from kpdiff_tpu_torch.utils import remake


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]  # this rank's index along each axis
    groups: Tuple[Optional[Any], ...]  # one process group per axis; None outside a group
    device: torch.device

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))

    def _axis(self, axis: str) -> int:
        return self.axis_names.index(axis)

    def size(self, axis: str) -> int:
        return self.shape[self._axis(axis)] if axis in self.axis_names else 1

    def index(self, axis: str) -> int:
        return self.coords[self._axis(axis)] if axis in self.axis_names else 0

    def group(self, axis: str):
        return self.groups[self._axis(axis)] if axis in self.axis_names else None

    @property
    def world(self):
        """The group of every rank of the mesh (None outside a group)."""
        return dist.group.WORLD if self.groups[0] is not None else None


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              axis_sizes: Optional[Sequence[int]] = None, device: str = "cuda") -> Mesh:
    """axis_sizes: ranks per axis (e.g. (2, 4) for a dp x mp mesh); default
    puts every rank on the first axis. Every rank of the group must call it,
    in the same order as its other group calls (it creates the axis groups)."""
    dev = resolve_device(device)
    n = int(n_devices) if n_devices else world_size()
    if n > visible_devices(dev):
        raise ValueError(f"requested a {n}-device mesh but only {visible_devices(dev)} device(s) are visible: "
                         "a silently truncated mesh would no-op the requested sharding")
    if n != world_size():
        raise ValueError(f"requested a {n}-device mesh but the process group has {world_size()} rank(s); "
                         "run one rank per device (parallel.distributed.spawn, torchrun --nproc_per_node "
                         f"{n}, or the CLIs' --n_devices {n})")
    shape = tuple(int(s) for s in axis_sizes) if axis_sizes is not None else (n,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != n:
        raise ValueError(f"axis sizes {shape} do not multiply to {n} devices over axes {tuple(axis_names)}")
    coords = tuple(int(c) for c in np.unravel_index(rank(), shape))
    groups = [None] * len(shape)
    if in_group():
        ranks = np.arange(n).reshape(shape)
        for a in range(len(shape)):
            # every line of ranks along axis a is a group; all ranks create all groups, in one order
            lines = np.moveaxis(ranks, a, -1).reshape(-1, shape[a])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if rank() in line:
                    groups[a] = g
    return Mesh(tuple(axis_names), shape, coords, tuple(groups), local_device(dev))


def padded_batch(batch: int, n: int) -> int:
    """`batch` rounded up to a multiple of n (kpdiff_tpu/cli/sample.py:135-136)."""
    return -(-batch // n) * n


def batch_rows(global_batch: int, mesh: Mesh, axis: str = "data") -> slice:
    n, i = mesh.size(axis), mesh.index(axis)
    if global_batch % n:
        raise ValueError(f"batch {global_batch} does not divide over the {n} ranks of '{axis}'; "
                         f"pad it to {padded_batch(global_batch, n)} (mesh.padded_batch)")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def shard_batch(x, mesh: Mesh, axis: str = "data", micro_batches: int = 1):
    """This rank's rows of a batch: a tensor or array (dim 0), a tuple or
    list of them, or a PaddedComplex (every field); None stays None.

    With `micro_batches` k the batch is k contiguous micro-batches (the
    trainer's grad_accum), and the rank takes its rows of each in turn, so
    that its micro-batch i is its share of the global micro-batch i."""
    from kpdiff_tpu_torch.models.complex import PaddedComplex

    if x is None:
        return None
    if isinstance(x, PaddedComplex):
        return x.replace(**{f.name: shard_batch(getattr(x, f.name), mesh, axis, micro_batches)
                            for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return remake(x, [shard_batch(a, mesh, axis, micro_batches) for a in x])
    if micro_batches == 1:
        return x[batch_rows(x.shape[0], mesh, axis)]
    if x.shape[0] % micro_batches:
        raise ValueError(f"{micro_batches} micro-batches must divide batch {x.shape[0]}")
    m = x.shape[0] // micro_batches
    parts = [x[i * m:(i + 1) * m][batch_rows(m, mesh, axis)] for i in range(micro_batches)]
    return torch.cat(parts) if torch.is_tensor(x) else np.concatenate(parts)


def replicate_params(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast every parameter and buffer from global rank 0 (in place)."""
    if mesh.world is not None:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0, group=mesh.world)
    return module


def params_checksum(module: torch.nn.Module) -> float:
    """Sum of every parameter, in float64: equal across ranks when replicated."""
    return float(sum(p.detach().double().sum() for p in module.parameters()))


def gather_batch(x: torch.Tensor, mesh: Mesh, axis: str = "data", dim: int = 0) -> torch.Tensor:
    """Every rank's rows of `axis` (dim `dim`), in rank order: the global batch."""
    g = mesh.group(axis)
    if g is None:
        return x
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    parts = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, src.contiguous(), group=g)
    out = torch.cat(parts, dim=dim)
    return out.bool() if x.dtype == torch.bool else out
