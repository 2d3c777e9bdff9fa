"""The reverse chain as a captured CUDA graph of one reverse step, replayed K
times: the port's counterpart of kpdiff_tpu's jitted `lax.scan`.

kpdiff_tpu runs the whole reverse chain as one `jax.lax.scan` inside one
`jit` (kpdiff_tpu/models/diffusion.py:586-587), and its serving API keeps
one compiled executable per (ligand bucket, kk cap) across requests
(kpdiff_tpu/serve.py:99-104). Here `KeypointDiffusion.reverse_step`, a
function of device tensors only that updates the chain's state in place and
advances its step index, is captured once per shape into a
`torch.cuda.CUDAGraph`; a chain of K steps is K replays of it, one host
call each instead of the step's 1,000-3,500 kernel launches.

`ChainGraphs` owns:
  * static buffers: a copy of every tensor the step reads (the state, the
    masks, kk, the schedule tables, the step index, injected noise); a run
    copies its inputs into them and returns clones of the state, since the
    next replay overwrites them;
  * warm-up before capture on a side stream, as torch's CUDA-graph
    documentation prescribes: the chain's first step runs eagerly there (it
    builds the edge kernel, the compute-dtype weights, cuBLAS's handles) and
    its result is kept, so that a run that captures makes K steps all the same;
  * capture of one step with `torch.cuda.graph` on that stream, the
    sampling generator registered with the graph so that every replay
    advances its Philox offset exactly as an eager step's draws do;
  * one memory pool shared by all of a model's graphs (they replay one at a
    time, never concurrently);
  * a bounded LRU cache keyed by the shapes and types of the inputs (batch,
    ligand bucket, keypoints, kk layout and cap, injected noise), eta, the
    compute dtype, the generator, and the model's parameter key: a
    parameter update drops every graph, since each reads the weights'
    buffers as they were at capture.
There is no fallback: a failure to capture or replay raises.

Launch counting: the edge kernel's wrapper counts a call made while a
stream captures in `egnn_edge.captured`, not in `launches` (and a list
mode call in `list_captured` too), and the GVP message kernel's in
`gvp_message.captured`; a graph keeps the numbers it captured and each
replay adds them to `egnn_edge.launches`, `list_launches` and
`gvp_message.launches`.

Tracing (utils/profiling.py): every CUDA capture is armed, so that the
step's `device_mark`s and the begin and end stamps the runner adds time its
edge sets on every replay (`ChainGraph.timers`); the capture counts the
graph's kernel nodes. Host spans: "<name>.capture" around each capture and
"<name>.replays" around a chain's replay loop (`name`: "chain" here; the
train and held-out loss runners take "train" and "loss").
"""
from __future__ import annotations

import collections
import dataclasses
import types
from typing import Any, Callable, Dict, Optional

import torch

from kpdiff_tpu_torch.ops.cuda import egnn_edge, gvp_message
from kpdiff_tpu_torch.utils import profiling, remake

STATE = ("lig_x", "lig_h", "kp_x")


def tree_signature(tree) -> tuple:
    """Hashable structure of a dict / tuple / tensor / None tree: every
    tensor's shape, dtype and device, and each sequence's type (a NbrList
    is not a plain tuple)."""
    if tree is None:
        return (None,)
    if torch.is_tensor(tree):
        return ("t", tuple(tree.shape), str(tree.dtype), str(tree.device))
    if isinstance(tree, dict):
        return ("d",) + tuple((k, tree_signature(tree[k])) for k in sorted(tree))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,) + tuple(tree_signature(x) for x in tree)
    raise TypeError(f"a chain input of type {type(tree).__name__}")


def tree_shapes(tree, prefix: str = "") -> Dict[str, tuple]:
    """{path: shape} of every tensor of a dict / tuple / tensor tree."""
    if torch.is_tensor(tree):
        return {prefix: tuple(tree.shape)}
    items = (tree.items() if isinstance(tree, dict) else tree._asdict().items() if hasattr(tree, "_fields")
             else enumerate(tree) if isinstance(tree, (tuple, list)) else ())
    out = {}
    for k, v in items:
        out.update(tree_shapes(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def clone_tree(tree, device=None):
    """A copy of a tree with every tensor cloned (new buffers), on `device` if given."""
    if torch.is_tensor(tree):
        return tree.clone() if device is None else tree.to(device, copy=True)
    if isinstance(tree, dict):
        return {k: clone_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return remake(tree, [clone_tree(x, device) for x in tree])
    return tree


def copy_tree(dst, src):
    """Copy every tensor of `src` into the same place of `dst` (same structure)."""
    if torch.is_tensor(dst):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            copy_tree(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            copy_tree(d, s)


def _device(tree) -> Optional[torch.device]:
    if torch.is_tensor(tree):
        return tree.device
    items = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, (tuple, list)) else ()
    for x in items:
        dev = _device(x)
        if dev is not None:
            return dev
    return None


def cuda_capture(step, static, generator, pool, stream):
    """One call of `step(static)` captured into a CUDA graph on `stream`, in
    memory `pool`; `generator` (if any) registered with the graph first (the
    default CUDA generator always is)."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        step(static)
    return graph


def host_capture(step, static, generator, pool, stream):
    """The CPU stand-in for `cuda_capture`: each replay calls the step on the
    same static buffers, as a CUDA graph replays its kernels on them. It lets
    the tests on the CPU drive the runner's buffers, cache and frame
    handling; sampling on the CPU runs eager."""
    return types.SimpleNamespace(replay=lambda: step(static))


@dataclasses.dataclass
class ChainGraph:
    """One captured reverse step and its static buffers."""
    key: tuple
    static: Dict[str, Any]
    generator: Optional[torch.Generator] = None  # held so that the key's id() stays this generator's
    graph: Any = None
    launches: int = 0  # edge-kernel launches a replay makes (captured calls)
    list_launches: int = 0  # of them, the kernel's list mode
    gvp_launches: int = 0  # GVP message kernel launches a replay makes (captured calls)
    replays: int = 0
    timers: Optional[profiling.GraphTimers] = None  # the device timers of an armed capture

    def replay(self):
        self.graph.replay()
        egnn_edge.launches += self.launches
        egnn_edge.list_launches += self.list_launches
        gvp_message.launches += self.gvp_launches
        self.replays += 1


class ChainGraphs:
    """A model's captured reverse steps, cached by shape (see the module
    docstring). `capture` turns (step, static, generator, pool, stream) into
    an object with `replay()`: `cuda_capture` (None, the default) or
    `host_capture` (the CPU stand-in of the tests). `name` is the runner's
    kind in the tracer's spans and timers."""

    def __init__(self, max_graphs: int = 16, capture: Optional[Callable] = None, name: str = "chain"):
        self.name = name
        self.max_graphs = max_graphs
        self._capture = capture or cuda_capture
        self._entries: "collections.OrderedDict[tuple, ChainGraph]" = collections.OrderedDict()
        self._params_key = None
        self._pool = None
        self._stream = None
        self.last: Optional[ChainGraph] = None  # the entry of the newest run
        self.captures = []  # one record per capture: input shapes, seconds, pool bytes, launches, kernels a replay
        profiling.TRACER.register(self)

    def __len__(self):
        return len(self._entries)

    def clear(self):
        """Drop every graph (the pool keeps its memory for the next captures)."""
        self._entries.clear()
        self.last = None

    def run(self, inputs: Dict[str, Any], step: Callable, n_steps: int, *, key: tuple, params_key,
            generator: Optional[torch.Generator] = None,
            after_step: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
        """n_steps of `step` (which updates its dict argument in place) from
        `inputs`: the cached graph's replays, or, for a shape not seen with
        these parameters, one eager warm-up step, the capture and n_steps - 1
        replays. after_step(i, static) runs after step i (frames: clone what
        you keep). Returns clones of the final state (STATE).
        generator: the torch.Generator the step draws from (None: it draws
        from the default generator, or nothing)."""
        if self._capture is cuda_capture:
            dev = _device(inputs)
            if dev is None or dev.type != "cuda":
                raise ValueError(f"a CUDA graph of the reverse step needs CUDA tensors, got {dev}")
        if params_key != self._params_key:
            self.clear()
            self._params_key = params_key
        full_key = (tree_signature(inputs),) + tuple(key) + (None if generator is None else id(generator),)
        entry = self._entries.get(full_key)
        if entry is None:
            entry = ChainGraph(full_key, clone_tree(inputs), generator)
            self._entries[full_key] = entry
            while len(self._entries) > self.max_graphs:
                self._entries.popitem(last=False)
        else:
            self._entries.move_to_end(full_key)
            copy_tree(entry.static, inputs)
        self.last = entry
        first = 0
        if entry.graph is None:
            self._warm_up(entry, step)
            if after_step is not None:
                after_step(0, entry.static)
            self._capture_step(entry, step)
            first = 1
        with profiling.span(f"{self.name}.replays"):
            for i in range(first, n_steps):
                entry.replay()
                if after_step is not None:
                    after_step(i, entry.static)
        return {k: entry.static[k].clone() for k in STATE}

    def _warm_up(self, entry, step):
        """The chain's first step, eagerly, on the side stream (CUDA)."""
        if self._capture is not cuda_capture:
            step(entry.static)
            return
        dev = _device(entry.static)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
            self._pool = torch.cuda.graph_pool_handle()
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self._stream):
            step(entry.static)
        torch.cuda.current_stream(dev).wait_stream(self._stream)

    def _capture_step(self, entry, step):
        before, list_before, pool_before = egnn_edge.captured, egnn_edge.list_captured, self.pool_bytes()
        gvp_before = gvp_message.captured
        with profiling.span(f"{self.name}.capture") as sp:
            if self._capture is cuda_capture:
                entry.graph, entry.timers = self._timed_capture(entry, step)
            else:
                entry.graph = self._capture(step, entry.static, entry.generator, self._pool, self._stream)
        entry.launches = egnn_edge.captured - before
        entry.list_launches = egnn_edge.list_captured - list_before
        entry.gvp_launches = gvp_message.captured - gvp_before
        pool = self.pool_bytes()
        self.captures.append(dict(inputs=tree_shapes(entry.static),
                                  capture_s=sp.seconds, pool_bytes=pool,
                                  pool_growth=None if pool is None or pool_before is None else pool - pool_before,
                                  launches_per_replay=entry.launches,
                                  kernels_per_replay=None if entry.timers is None else entry.timers.kernels))

    def _timed_capture(self, entry, step):
        """cuda_capture of the step between the tracer's begin and end
        stamps, with its device_marks armed; (graph, its GraphTimers)."""
        stream = self._stream.cuda_stream

        with profiling.armed(self.name, _device(entry.static), stream) as armed:
            def timed(static):
                armed.begin()
                step(static)
                armed.end()
                kernels, _ = egnn_edge.capture_kernel_nodes(stream)
                armed.timers.kernels = kernels - armed.timers.stamps

            graph = cuda_capture(timed, entry.static, entry.generator, self._pool, self._stream)
        return graph, armed.timers

    def pool_bytes(self) -> Optional[int]:
        """Bytes of the segments of the graphs' shared pool (the caching
        allocator's snapshot); None before the first capture or where the
        snapshot does not name pools."""
        if self._pool is None:
            return None
        total, named = 0, False
        for seg in torch.cuda.memory_snapshot():
            pool = seg.get("segment_pool_id")
            if pool is None:
                continue
            named = True
            if tuple(pool) == tuple(self._pool):
                total += int(seg["total_size"])
        return total if named else None
