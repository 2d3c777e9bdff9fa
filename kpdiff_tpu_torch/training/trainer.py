"""Training (kpdiff_tpu/training/trainer.py): the train step, its Adam,
checkpoints and metric logs.

The optimisation is the JAX package's recipe: gradient values clipped at
clip_value, then Adam with coupled weight decay (the decay is added to the
gradient before the moments, as torch.optim.Adam does and as optax's
clip -> add_decayed_weights -> adam chain does), betas (0.9, 0.999), eps
1e-8, and the learning rate of the warm-up/restart schedule set before
every update. The loss is l2 + w_rec * rec_encoder (+ w_rl * rl_hinge).
A step whose loss or gradients are not finite is skipped, as JAX's
keep_finite does: the update is computed, then the parameters and Adam's
moments and count keep their old values, and the step counter advances.

The step is one function of device tensors (`train_step_body`): the
learning rate and w_rec are device scalars set from the host schedule
before it, the skip is a select on a device flag, and the metrics come
back as one device vector that the host reads once, after the step. On
CUDA without a mesh, `make_train_step` replays a captured CUDA graph of it
(training/train_graph.py), the counterpart of the JAX package's jitted
step; otherwise it calls it eagerly. The optimizer (`Adam`) keeps the
gradients and both moments of all parameters as views of one flat buffer
each, allocated once, so that the clip, the update and the select are a
few kernels whatever the parameter count.

Given a mesh (parallel/mesh.py), the step is data parallel over its 'data'
axis: each rank passes its rows of the global batch (with grad_accum,
its rows of each micro-batch: `mesh.shard_batch(..., micro_batches=
grad_accum)`, so that its micro-batch i is its share of the global
micro-batch i), the loss is each rank's part of the global loss (kp_shard.py::ShardContext.mean_den), and
the flattened gradients are all-reduced over the 'data' group and divided
by its size, which is the gradient of the global batch's loss. With
`kp_axis`, the keypoints are split over that axis too (dp x mp): the
gradients of the parameters that run on a rank's keypoint rows
(`KeypointDiffusion.kp_row_parameters`) are summed over the 'model' group
first; the ligand and encoder paths' gradients are whole on every rank
already. The non-finite check is agreed by every rank, and the metrics are
the global means. The reductions are explicit all-reduces, not DDP, which
would trip over the parameters the loss does not reach and the
grad_accum loop. A step under a mesh runs eagerly.
"""
from __future__ import annotations

import dataclasses
import pickle
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from kpdiff_tpu_torch.models.complex import PaddedComplex
from kpdiff_tpu_torch.models.diffusion import KeypointDiffusion, device_t_eps
from kpdiff_tpu_torch.training.scheduler import SchedulerConfig, learning_rate, rec_encoder_weight
from kpdiff_tpu_torch.training.train_graph import batch_fields, capture_refusal
from kpdiff_tpu_torch.utils import profiling

ADAM_BETAS = (0.9, 0.999)  # optax.adam's defaults
ADAM_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 1e-12
    clip_grad: bool = True
    clip_value: float = 1.5
    batch_size: int = 32
    epochs: int = 3
    rec_encoder_loss_weight: float = 0.1
    rl_hinge_loss_weight: float = 0.0
    # each batch is split into grad_accum contiguous micro-batches whose
    # gradients and losses are averaged before the update
    grad_accum: int = 1
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)


@dataclasses.dataclass
class TrainState:
    model: KeypointDiffusion
    optimizer: "Adam"
    step: int = 0


class Adam(torch.optim.Optimizer):
    """Adam with coupled weight decay whose whole state lives on the
    parameters' device, so that a step holds no host value: the gradients
    and both moments of all parameters are views of one flat buffer each
    (allocated once, by `prepare`, outside any capture), the step count is a
    0-d f32 tensor per parameter (views of one flat buffer, all equal, as
    optax keeps one count), and `update` takes the learning rate as a device
    scalar. The state keys ('step', 'exp_avg', 'exp_avg_sq') and the
    state_dict are torch.optim.Adam's, so a checkpoint of either loads into
    the other; `load_state_dict` re-flattens what it loads. One parameter
    group, one device, one floating dtype."""

    def __init__(self, params, lr: float, betas=ADAM_BETAS, eps: float = ADAM_EPS, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        if len(self.param_groups) != 1:
            raise ValueError("Adam here takes one parameter group")
        self.generation = 0  # counts load_state_dict calls: a captured step of older buffers is dropped
        self._flat: Optional[Dict[str, torch.Tensor]] = None
        self.grads = []  # the flat gradient's views, one per parameter (prepare)

    @property
    def params(self):
        return list(self.param_groups[0]["params"])

    @property
    def device(self) -> torch.device:
        return self.param_groups[0]["params"][0].device

    def _views(self, flat: torch.Tensor):
        out, i = [], 0
        for p in self.params:
            out.append(flat[i:i + p.numel()].view_as(p))
            i += p.numel()
        return out

    def prepare(self):
        """Allocate the flat gradient, moment and count buffers, once (and
        after load_state_dict): from the state where there is one, zeros
        and a count of 0 where there is none, as torch.optim.Adam starts."""
        if self._flat is not None:
            return
        params = self.params
        dev, dtype = params[0].device, params[0].dtype
        if any(p.device != dev or p.dtype != dtype or not p.is_contiguous() for p in params):
            raise ValueError("Adam's flat buffers need contiguous parameters of one device and dtype")
        n = sum(p.numel() for p in params)
        flat = {k: torch.zeros(n, dtype=dtype, device=dev) for k in ("grad", "exp_avg", "exp_avg_sq")}
        flat["step"] = torch.zeros(len(params), dtype=torch.float32, device=dev)
        old = [self.state.get(p) for p in params]
        if any(old):
            if not all(old):
                raise ValueError("optimizer state holds some parameters only")
            counts = {float(s["step"]) for s in old}
            if len(counts) != 1:
                raise ValueError(f"Adam step counts differ across parameters: {sorted(counts)}")
            flat["step"].fill_(counts.pop())
            for key in ("exp_avg", "exp_avg_sq"):
                for view, s in zip(self._views(flat[key]), old):
                    view.copy_(s[key])
        for i, (p, m, v) in enumerate(zip(params, self._views(flat["exp_avg"]), self._views(flat["exp_avg_sq"]))):
            self.state[p] = {"step": flat["step"][i], "exp_avg": m, "exp_avg_sq": v}
        self._flat = flat
        self.grads = self._views(flat["grad"])

    @property
    def flat_grad(self) -> torch.Tensor:
        return self._flat["grad"]

    def buffers(self):
        """The flat buffers a step writes (gradients, moments, counts)."""
        return list(self._flat.values())

    def buffers_key(self) -> tuple:
        return tuple(b.data_ptr() for b in self.buffers()) + (self.generation,)

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        self._flat = None
        self.generation += 1
        self.prepare()

    @torch.no_grad()
    def update(self, lr: torch.Tensor, finite: torch.Tensor):
        """One Adam update from the flat gradient, device tensors only: `lr`
        a 0-d f32 tensor, `finite` a 0-d bool tensor. The parameters,
        moments and counts take their new values where `finite` holds and
        keep their old ones where it does not (the JAX package's
        keep_finite); the update is computed either way."""
        group = self.param_groups[0]
        b1, b2 = group["betas"]
        flat, params = self._flat, self.params
        grad = flat["grad"]
        if group["weight_decay"]:
            grad = grad.add(torch.cat([p.reshape(-1) for p in params]), alpha=group["weight_decay"])
        m = torch.lerp(flat["exp_avg"], grad, 1.0 - b1)
        v = flat["exp_avg_sq"].mul(b2).addcmul_(grad, grad, value=1.0 - b2)
        t = flat["step"][0] + 1.0
        step_size = lr / (1.0 - torch.pow(b1, t))
        denom = (v.sqrt() / torch.sqrt(1.0 - torch.pow(b2, t))).add_(group["eps"])
        upd = torch.where(finite, (m / denom).mul_(step_size), 0.0)
        torch.where(finite, m, flat["exp_avg"], out=flat["exp_avg"])
        torch.where(finite, v, flat["exp_avg_sq"], out=flat["exp_avg_sq"])
        flat["step"].add_(finite.to(flat["step"].dtype))
        torch._foreach_sub_(params, self._views(upd))

    def step(self, closure=None):
        """torch.optim's interface: one update from the parameters' .grad
        (None counts as zero) at the group's learning rate."""
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        self.prepare()
        with torch.no_grad():
            for p, g in zip(self.params, self.grads):
                if p.grad is None:
                    g.zero_()
                elif p.grad.data_ptr() != g.data_ptr():
                    g.copy_(p.grad)
        self.update(torch.full((), self.param_groups[0]["lr"], dtype=torch.float32, device=self.device),
                    torch.ones((), dtype=torch.bool, device=self.device))


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig) -> Adam:
    """Adam with coupled weight decay; the learning rate is set per step."""
    return Adam(model.parameters(), lr=cfg.learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS,
                weight_decay=cfg.weight_decay)


def init_train_state(model: KeypointDiffusion, cfg: TrainConfig) -> TrainState:
    return TrainState(model=model, optimizer=make_optimizer(model, cfg), step=0)


def _micro(x, accum: int, i: int):
    """Rows [i*B/accum, (i+1)*B/accum) of a tensor, array or PaddedComplex."""
    if isinstance(x, PaddedComplex):
        return x.replace(**{f.name: _micro(getattr(x, f.name), accum, i)
                            for f in dataclasses.fields(x) if getattr(x, f.name) is not None})
    n = x.shape[0]
    if n % accum:
        raise ValueError(f"grad_accum={accum} must divide batch {n}")
    m = n // accum
    return x[i * m:(i + 1) * m]


def _all_reduce_flat(tensors, group, scale: float = 1.0):
    """All-reduce (sum) a list of tensors as one flat buffer, in place, times `scale`."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if scale != 1.0:
        flat.mul_(scale)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


def loss_and_grads(model: KeypointDiffusion, cfg: TrainConfig, batch: PaddedComplex, w_rec,
                   params, generator: Optional[torch.Generator] = None,
                   t_eps: Optional[Tuple[Any, Any, Any]] = None, mesh=None, kp_axis: Optional[str] = None):
    """The step's forward and backward: (total, {loss: value}) as tensors and
    the gradients accumulated into every parameter's .grad (a zero tensor
    is given to each that has none first, so that the ones the loss does not
    reach are zero: Adam still decays them, as optax does), each reduced
    over the mesh as the module docstring says. `w_rec`: a float or a 0-d
    device tensor."""
    from kpdiff_tpu_torch.parallel.kp_shard import kp_constraint

    accum = max(int(cfg.grad_accum or 1), 1)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    total_sum, loss_sums = 0.0, {}
    for i in range(accum):
        mb = batch if accum == 1 else _micro(batch, accum, i)
        te = t_eps if accum == 1 or t_eps is None else tuple(_micro(a, accum, i) for a in t_eps)
        shard = None if mesh is None else kp_constraint(mesh, mb.batch_size, axis=kp_axis or "model")
        losses = model.loss(mb, t_eps_override=te, generator=generator, kp_shard=shard)
        total = losses["l2"] + w_rec * losses["rec_encoder"]
        if "rl_hinge" in losses:
            total = total + cfg.rl_hinge_loss_weight * losses["rl_hinge"]
        total.backward()
        total_sum = total_sum + total.detach()
        for k, v in losses.items():
            loss_sums[k] = loss_sums.get(k, 0.0) + v.detach()
    if mesh is not None:
        if kp_axis is not None and mesh.group(kp_axis) is not None:
            partial = {id(p) for p in model.kp_row_parameters()}
            _all_reduce_flat([p.grad for p in params if id(p) in partial], mesh.group(kp_axis))
        if mesh.group("data") is not None:
            _all_reduce_flat([p.grad for p in params], mesh.group("data"), 1.0 / mesh.size("data"))
    if accum > 1:
        torch._foreach_mul_([p.grad for p in params], 1.0 / accum)
        total_sum = total_sum * (1.0 / accum)
        loss_sums = {k: v * (1.0 / accum) for k, v in loss_sums.items()}
    return total_sum, loss_sums


def train_step_body(model: KeypointDiffusion, cfg: TrainConfig, opt: Adam, batch: PaddedComplex, t_eps,
                    generator: Optional[torch.Generator], lr: torch.Tensor, w_rec: torch.Tensor, mesh=None,
                    kp_axis: Optional[str] = None):
    """One optimizer step on device tensors only: zero the flat gradient,
    forward and backward of every micro-batch, the finite check, clip,
    Adam with the non-finite select. `lr` and `w_rec` are 0-d device
    tensors, `t_eps` None or device tensors; no host value of the step
    changes from one step to the next and nothing waits for the device, so
    the eager step and the captured graph run this one function. Returns
    (vec, keys): vec holds the finite flag (summed over the ranks under a
    mesh), the total and the losses in the order of keys."""
    params, grads = opt.params, opt.grads
    for p, g in zip(params, grads):  # the flat buffer's views: backward accumulates into them in place
        p.grad = g
    opt.flat_grad.zero_()
    total, loss_sums = loss_and_grads(model, cfg, batch, w_rec, params, generator, t_eps, mesh, kp_axis)
    profiling.device_mark("rest")  # the device timers' segments (utils/profiling.py)
    keys = sorted(loss_sums)
    finite = torch.isfinite(total) & torch.isfinite(opt.flat_grad).all()
    vec = torch.stack([finite.to(total.dtype), total] + [loss_sums[k] for k in keys])
    if mesh is not None and mesh.world is not None:
        # an agreed skip and the global means: sums over every rank (the host divides by the rank count)
        dist.all_reduce(vec, group=mesh.world)
        finite = vec[0] == mesh.n_devices
    profiling.device_mark("optimizer")
    if cfg.clip_grad:
        opt.flat_grad.clamp_(-cfg.clip_value, cfg.clip_value)
    opt.update(lr, finite)
    for p in params:
        p.grad = None
    return vec, keys


def make_train_step(cfg: TrainConfig, iters_per_epoch: int, mesh=None, kp_axis: Optional[str] = None,
                    cuda_graph: Optional[bool] = None) -> Callable[..., Dict[str, float]]:
    """Returns step(state, batch, generator=None, t_eps=None) -> metrics.

    The step updates `state` in place. `t_eps` = (t_int, eps_x, eps_h)
    replaces the loss's draws (the tests' seam); otherwise they come from
    `generator`. Metrics: the losses, total, lr, rec_enc_weight and
    skipped_nonfinite, as floats, read from the device once per step. With
    a `mesh` every rank passes its rows of the batch and of t_eps
    (`shard_batch(..., micro_batches=cfg.grad_accum)`) and a generator in
    the same state, and `kp_axis` names the axis that splits the keypoints.

    cuda_graph: None (the default) replays a captured CUDA graph of the
    step (training/train_graph.py, `model.train_graphs`) when the model is
    on CUDA, no mesh is given and the OT plan is solved on the device, and
    runs eagerly otherwise; False runs eagerly anywhere; True asks for the
    graph and raises ValueError where the step cannot be captured. There
    is no fallback: a failed capture or replay raises."""
    if cuda_graph and mesh is not None:
        raise ValueError(f"cuda_graph=True: {capture_refusal(None, mesh)}")
    sched = cfg.scheduler

    def step_fn(state: TrainState, batch: PaddedComplex, generator: Optional[torch.Generator] = None,
                t_eps: Optional[Tuple[Any, Any, Any]] = None) -> Dict[str, float]:
        with profiling.span("train.step", request=True):
            # host spans (utils/profiling.py): prepare, from here to the launch; launch; finish, the
            # version bumps and the readback wait
            prep = profiling.span("train.prepare").__enter__()
            model, opt = state.model, state.optimizer
            epoch_exact = float(np.float32(state.step) / np.float32(iters_per_epoch))
            w_rec = rec_encoder_weight(sched, epoch_exact)
            lr = learning_rate(sched, epoch_exact)
            dev = opt.device
            refusal = capture_refusal(model, mesh)
            graph = cuda_graph
            if graph is None:
                graph = refusal is None and dev.type == "cuda"
            elif graph and refusal:
                raise ValueError(f"cuda_graph=True: {refusal}")
            t_eps = device_t_eps(t_eps, dev)
            opt.prepare()
            profiling.count("train.steps")
            if graph:
                vec, keys = _graph_step(model, cfg, opt, batch, t_eps, generator, lr, w_rec, prep)
            else:
                prep.stop(total_as="train.prepare.eager")
                with profiling.span("train.launch"):
                    vec, keys = train_step_body(model, cfg, opt, batch, t_eps, generator,
                                                torch.full((), lr, dtype=torch.float32, device=dev),
                                                torch.full((), w_rec, dtype=torch.float32, device=dev), mesh,
                                                kp_axis)
            with profiling.span("train.finish"):
                if graph:
                    # a replay does not move version counters: move them as an eager step's in-place ops
                    # would, so that the caches keyed on the parameters' versions (the sampler's
                    # compute-dtype copy, the edge kernel's packed weights, the chain and held-out loss
                    # graphs) rebuild
                    torch.autograd.graph.increment_version(opt.params + opt.buffers())
                n = mesh.n_devices if mesh is not None and mesh.world is not None else 1
                host = [v / n for v in vec.tolist()]
        for group in opt.param_groups:  # the last learning rate, as a float, for the checkpoint
            group["lr"] = lr
        state.step += 1
        metrics = dict(zip(keys, host[2:]))
        metrics.update(total=host[1], lr=lr, rec_enc_weight=w_rec, skipped_nonfinite=0.0 if host[0] == 1.0 else 1.0)
        return metrics

    return step_fn


def _graph_step(model, cfg, opt, batch, t_eps, generator, lr, w_rec, prep: profiling.Span):
    """The step through `model.train_graphs`: the batch and t_eps copied into
    the graph's static buffers, lr and w_rec filled into its scalars, then
    `prep` (the span train.prepare) ends and the replay (or, for a new
    shape, the eager warm-up step and the capture) is launched. The caller
    then moves the version counter of every tensor the step wrote. A step
    that captures, or runs while a profiler records, keeps its prepare time
    out of the train.prepare totals (train.prepare.capture,
    train.prepare.profiled)."""
    params = opt.params

    def body(s):
        return train_step_body(model, cfg, opt, PaddedComplex(**s["in"]["batch"]), s["in"]["t_eps"], generator,
                               s["lr"], s["w_rec"])

    runner = model.train_graphs
    entry = runner.entry({"batch": batch_fields(batch), "t_eps": t_eps}, device=opt.device, key=(cfg,),
                         params_key=(tuple(p.data_ptr() for p in params), opt.buffers_key()),
                         generator=generator, scalars={"lr": lr, "w_rec": w_rec})
    if entry.graph is None:
        profiling.count("train.steps_captured")
        prep.stop(total_as="train.prepare.capture")
    else:
        prep.stop(total_as="train.prepare.profiled" if profiling.tracing() else None)
    with profiling.span("train.launch"):
        return runner.launch(entry, body)


# --------------------------------------------------------------------------
# checkpoints: parameters, optimizer state and step in checkpoints/step_N.pt
# --------------------------------------------------------------------------

def save_checkpoint(ckpt_dir: str | Path, state: TrainState) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"step_{state.step}.pt"
    tmp = path.with_suffix(".pt.tmp")
    torch.save({"params": {n: p.detach().cpu() for n, p in state.model.named_parameters()},
                "optimizer": state.optimizer.state_dict(), "step": state.step}, tmp)
    tmp.replace(path)
    return path


def checkpoint_steps(ckpt_dir: str | Path):
    return sorted(int(p.stem.split("_")[1]) for p in Path(ckpt_dir).glob("step_*.pt"))


def read_checkpoint(ckpt_dir: str | Path, step: Optional[int] = None) -> Dict[str, Any]:
    """The stored dict of checkpoints/step_N.pt (the newest without `step`), on the CPU."""
    if step is None:
        steps = checkpoint_steps(ckpt_dir)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        step = steps[-1]
    return torch.load(Path(ckpt_dir) / f"step_{step}.pt", map_location="cpu", weights_only=True)


def load_checkpoint(ckpt_dir: str | Path, state: TrainState, step: Optional[int] = None) -> TrainState:
    """Restore parameters, optimizer state and step into `state` in place."""
    from kpdiff_tpu_torch.utils.params_io import load_params

    ckpt = read_checkpoint(ckpt_dir, step)
    load_params(state.model, {n: v.numpy() for n, v in ckpt["params"].items()})
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.model.train_graphs.clear()  # captured against the optimizer's old buffers
    state.step = int(ckpt["step"])
    return state


class MetricsLog:
    """Append-mode pickle metrics log (train_metrics.pkl / test_metrics.pkl):
    the whole list of rows is rewritten on every append; rows already in
    the file are kept, so a resumed run continues its history."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.rows = []
        if self.path.exists():
            with open(self.path, "rb") as f:
                self.rows = list(pickle.load(f))
        self._t0 = time.time()
        if self.rows:
            self._t0 -= float(self.rows[-1].get("time_passed", 0.0))

    def append(self, **row):
        row.setdefault("time_passed", time.time() - self._t0)
        self.rows.append({k: (float(v) if hasattr(v, "item") else v) for k, v in row.items()})
        with open(self.path, "wb") as f:
            pickle.dump(self.rows, f)
