"""Process groups of the port's parallel layer (kpdiff_tpu/parallel/distributed.py).

One process per device, joined by torch.distributed. The backend follows
the device the caller asked for: NCCL for `cuda`, gloo for `cpu`; it is
never chosen by probing. Three ways to get a group:

- `spawn(fn, n, device=...)` starts n local ranks (a `file://` rendezvous
  in a fresh temporary directory, so no port is taken) and joins them with
  a time limit; the CLIs use it when given `--n_devices N > 1` outside a
  group;
- `torchrun --nproc_per_node N` sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE
  and RANK, and `initialize_multihost()` reads them (or takes them as
  arguments on a cluster of hosts); the CLIs call it through
  `join_launcher_group` when they find those variables;
- a caller may init the default group itself; every entry point then uses
  the group it finds.

Every group carries a `timeout`, so a rank that dies makes the others fail
instead of hanging.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from datetime import timedelta
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from kpdiff_tpu_torch.device import resolve_device

DEFAULT_TIMEOUT = timedelta(minutes=30)


def backend_for(device) -> str:
    """nccl for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if in_group() else 1


def rank() -> int:
    return dist.get_rank() if in_group() else 0


def visible_devices(device) -> int:
    """Devices one host can give ranks: the visible CUDA cards, or the CPU's cores."""
    dev = torch.device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else (os.cpu_count() or 1)


def resolve_n_devices(n_devices: int, device) -> int:
    """`--n_devices`: 0 means every visible device (kpdiff_tpu/cli/train.py:40,202);
    more than are visible raises."""
    n = int(n_devices) or visible_devices(device)
    if n < 1 or n > visible_devices(device):
        raise ValueError(f"requested {n} device(s) but only {visible_devices(device)} "
                         f"{torch.device(device).type} device(s) are visible")
    return n


def local_device(device) -> torch.device:
    """This rank's device: its CUDA card (set by the group's init) or the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _set_cuda_device(r: int, local_rank: Optional[int] = None):
    n = torch.cuda.device_count()
    torch.cuda.set_device(local_rank if local_rank is not None else r % n)


def initialize_multihost(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device: str = "cuda",
                         timeout: timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Init the default process group. Arguments left out come from
    torchrun's environment: MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK (and
    LOCAL_RANK for the card). `coordinator_address` is host:port or a
    URL (tcp://, file://). Returns this rank's device."""
    dev = resolve_device(device)
    env = os.environ
    try:
        addr = coordinator_address or f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        n = int(num_processes if num_processes is not None else env["WORLD_SIZE"])
        r = int(process_id if process_id is not None else env["RANK"])
    except KeyError as e:
        raise ValueError(f"initialize_multihost: pass the coordinator address, process count and id, or "
                         f"run under torchrun ({e.args[0]} is not set)") from None
    if dev.type == "cuda":
        _set_cuda_device(r, int(env["LOCAL_RANK"]) if "LOCAL_RANK" in env else None)
    init = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend_for(dev), init_method=init, world_size=n, rank=r, timeout=timeout)
    return local_device(dev)


def join_launcher_group(device: str = "cuda") -> bool:
    """Init the default group from torchrun's environment when the process
    was started by it and no group exists yet; True when in a group after."""
    env = os.environ
    if not in_group() and all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
        initialize_multihost(device=device)
    return in_group()


def global_data_mesh(axis_names: Sequence[str] = ("data",), device: str = "cuda"):
    """Mesh over every rank of the group, all on the first axis."""
    from kpdiff_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(world_size(), axis_names, device=device)


def process_local_batch_slice(global_batch: int) -> slice:
    """The rows of the global batch this process loads (per-rank data loading)."""
    n, i = world_size(), rank()
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def _rank_main(r: int, fn: Callable, world: int, init_method: str, device: str, timeout: timedelta,
               threads: Optional[int], args: tuple):
    if threads:
        torch.set_num_threads(threads)
    if torch.device(device).type == "cuda":
        _set_cuda_device(r)
    dist.init_process_group(backend_for(device), init_method=init_method, world_size=world, rank=r,
                            timeout=timeout)
    try:
        fn(r, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable[..., Any], nprocs: int, args: tuple = (), device: str = "cuda",
          timeout: timedelta = DEFAULT_TIMEOUT, join_timeout: Optional[float] = None,
          threads: Optional[int] = None, init_method: Optional[str] = None) -> None:
    """Run fn(rank, *args) in `nprocs` new processes joined in one group
    (backend from `device`; each group operation fails after `timeout`).
    Raises the first rank's exception; past `join_timeout` seconds the ranks
    are killed and TimeoutError is raised. `threads` sets each rank's
    torch.set_num_threads. `fn` must be importable (a module-level function)."""
    import torch.multiprocessing as mp

    resolve_device(device)
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="kpdiff_rdzv_")
        init_method = "file://" + os.path.join(tmp, "store")
    ctx = mp.start_processes(_rank_main, args=(fn, nprocs, init_method, str(device), timeout, threads, args),
                             nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if join_timeout is None else time.monotonic() + join_timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"{nprocs} ranks still running after {join_timeout} s; killed")
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
