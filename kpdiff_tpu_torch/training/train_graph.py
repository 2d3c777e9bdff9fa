"""The optimizer step and the held-out loss as captured CUDA graphs: the
port's counterparts of kpdiff_tpu's jitted train step
(kpdiff_tpu/training/trainer.py:91-223, one executable for loss,
value_and_grad, the grad_accum scan, clip, decay, Adam and keep_finite) and
of its jitted held-out loss (kpdiff_tpu/cli/train.py:376-385).

`TrainGraphs` is models/chain_graph.py's runner (its warm-up on a side
stream, `cuda_capture` / `host_capture`, shared memory pool, bounded cache,
capture records, captures armed with the tracer's device timers) with one
call per step instead of a chain of replays:
  * static buffers: a copy of every tensor of the step's inputs (the
    PaddedComplex batch's fields, injected (t_int, eps_x, eps_h)) and one
    0-d f32 tensor per host scalar (the learning rate, w_rec), filled with
    `fill_` before every step: a capture freezes every host value, so
    nothing that changes from step to step may be one;
  * the first step of the runner's first input shape (and the first after
    its graphs were dropped) runs eagerly on the side stream and counts as
    a real step: it makes what a capture cannot (the autograd engine's
    threads, cuBLAS's workspace, the weight caches); then the runner
    captures. A later input shape is captured at once, into the pool its
    live graphs share, and its first replay is the step: an eager warm-up
    would need a second copy of the step's memory beside the pool's (at
    egnn_ca's batch 32 the two do not fit in 80 GB). Later steps of a
    shape copy their inputs into the static buffers and replay;
  * the step's generator is registered with its graph, so that the
    loss's t and noise draws and the GVP dropout masks advance it as an
    eager step's draws do;
  * the cache key: the inputs' shapes and types, what the caller adds
    (the train config: grad_accum, clip, weights), the generator and the
    caller's parameter key. A change of the parameter key drops every
    graph. The train step's key is the buffers of the parameters, of the
    gradients and of the optimizer's state, with the optimizer's
    load_state_dict count; not their versions, since the graph itself
    updates those tensors. The held-out loss's key is the parameters'
    buffers and versions, as the chain graphs' is, since its graph reads
    the caches built from them (the edge kernel's packed weights).
The step writes the parameters and the optimizer's buffers in place; a
replay does not move their version counters, so the trainer moves them
after each step (trainer.py::_graph_step). There is no fallback: a failed
capture or replay raises.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from kpdiff_tpu_torch.models.chain_graph import (ChainGraph, ChainGraphs, clone_tree, copy_tree, cuda_capture,
                                                 tree_signature)
from kpdiff_tpu_torch.models.complex import PaddedComplex
from kpdiff_tpu_torch.models.diffusion import device_t_eps


def capture_refusal(model, mesh=None) -> Optional[str]:
    """Why a step or loss of `model` cannot be captured into a CUDA graph
    (None when it can): a mesh's collectives are queued from the host, and
    the exact OT plan is solved on the host (losses/ot.py)."""
    if mesh is not None:
        return "a step under a mesh runs eager (its collectives are queued from the host)"
    if model.rec_loss_type != "none" and model.rec_loss_kwargs.get("method", "sinkhorn") == "exact":
        return "the exact OT plan is solved on the host (rec_encoder_loss.method: exact)"
    return None


def batch_fields(batch: PaddedComplex) -> Dict[str, torch.Tensor]:
    """A PaddedComplex's tensors by field name (fields that are None left out)."""
    return {k: v for k, v in vars(batch).items() if v is not None}


class TrainGraphs(ChainGraphs):
    """A model's captured steps of one kind (optimizer steps, or held-out
    losses), cached by input shape; see the module docstring."""

    def run(self, fn: Callable[[Dict[str, Any]], Any], inputs, *, device, key: tuple = (), params_key=None,
            generator: Optional[torch.Generator] = None, scalars: Optional[Dict[str, float]] = None):
        """fn(static) on static copies of `inputs` (static["in"]) and of the
        host `scalars` (static[name], 0-d f32): the cached graph's replay;
        for an input shape not seen with this parameter key, its capture
        and first replay, or with no live graph the eager warm-up call (its
        result returned) and the capture. Returns fn's result; a replay's
        lives in the graph's buffers, which the next replay of any of this
        runner's graphs may overwrite: read it first. `entry` then `launch`
        is the same in two calls (the trainer's host spans end between them)."""
        return self.launch(self.entry(inputs, device=device, key=key, params_key=params_key, generator=generator,
                                      scalars=scalars), fn)

    def entry(self, inputs, *, device, key: tuple = (), params_key=None, generator: Optional[torch.Generator] = None,
              scalars: Optional[Dict[str, float]] = None) -> ChainGraph:
        """The graph entry of `run`'s arguments, its static buffers filled
        (no graph yet where `entry.graph` is None)."""
        device = torch.device(device)
        if self._capture is cuda_capture and device.type != "cuda":
            raise ValueError(f"a CUDA graph of the step needs CUDA tensors, got {device}")
        if params_key != self._params_key:
            self.clear()
            self._params_key = params_key
        scalars = scalars or {}
        full_key = ((tree_signature(inputs), tuple(sorted(scalars))) + tuple(key)
                    + (None if generator is None else id(generator),))
        entry = self._entries.get(full_key)
        if entry is None:
            static = {"in": clone_tree(inputs, device)}
            static.update({k: torch.zeros((), dtype=torch.float32, device=device) for k in scalars})
            entry = ChainGraph(full_key, static, generator)
            self._entries[full_key] = entry
            while len(self._entries) > self.max_graphs:
                self._entries.popitem(last=False)
        else:
            self._entries.move_to_end(full_key)
            copy_tree(entry.static["in"], inputs)
        for k, v in scalars.items():
            entry.static[k].fill_(v)
        self.last = entry
        return entry

    def launch(self, entry: ChainGraph, fn: Callable[[Dict[str, Any]], Any]):
        """`run`'s second half on an entry of `entry`: the replay, or the
        warm-up and capture."""
        def step(s):
            s["out"] = fn(s)

        if entry.graph is None:
            if len(self._entries) == 1:  # no live graph: an eager step first (see the module docstring)
                self._warm_up(entry, step)
                out = entry.static.pop("out")
                self._capture_step(entry, step)
                return out
            self._capture_step(entry, step)
        entry.replay()
        return entry.static["out"]


def loss_vector(model, batch: PaddedComplex, generator: Optional[torch.Generator] = None, t_eps=None):
    """(the losses stacked in the order of keys, keys) of `model.loss`: one
    device vector, read by the host once."""
    losses = model.loss(batch, t_eps_override=t_eps, generator=generator)
    keys = sorted(losses)
    return torch.stack([losses[k] for k in keys]), keys


def heldout_loss(model, batch: PaddedComplex, generator: Optional[torch.Generator] = None, t_eps=None,
                 cuda_graph: Optional[bool] = None) -> Dict[str, float]:
    """The training losses of `batch` under no_grad (the held-out loss of
    cli/train.py::evaluate), as floats. cuda_graph: None (the default)
    replays a captured graph of the loss (`model.loss_graphs`) on CUDA
    unless the OT plan is solved on the host; False runs eagerly; True asks
    for the graph and raises where it cannot be captured. Both run
    `loss_vector`; under no_grad the dense edges go through the CUDA edge
    kernel on a card."""
    refusal = capture_refusal(model)
    if cuda_graph is None:
        cuda_graph = refusal is None and batch.device.type == "cuda"
    elif cuda_graph and refusal:
        raise ValueError(f"cuda_graph=True: {refusal}")
    t_eps = device_t_eps(t_eps, batch.device)
    with torch.no_grad():
        if cuda_graph:
            vec, keys = model.loss_graphs.run(
                lambda s: loss_vector(model, PaddedComplex(**s["in"]["batch"]), generator, s["in"]["t_eps"]),
                {"batch": batch_fields(batch), "t_eps": t_eps}, device=batch.device, key=("loss",),
                params_key=model._params_key(), generator=generator)
        else:
            vec, keys = loss_vector(model, batch, generator, t_eps)
        return dict(zip(keys, vec.tolist()))
