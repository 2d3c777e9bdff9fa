"""Training (kpdiff_tpu/training/trainer.py): torch Adam, the train
step, checkpoints and metric logs.

The optimisation is the JAX package's recipe: gradient values clipped at
clip_value, then Adam with coupled weight decay (the decay is added to the
gradient before the moments, as torch.optim.Adam does and as optax's
clip -> add_decayed_weights -> adam chain does), betas (0.9, 0.999), eps
1e-8, and the learning rate of the warm-up/restart schedule set before
every update. The loss is l2 + w_rec * rec_encoder (+ w_rl * rl_hinge).
A step whose loss or gradients are not finite is skipped: the parameters
and Adam's moments and count stay as they were, and the step counter
advances.

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
grad_accum loop.
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
from kpdiff_tpu_torch.models.diffusion import KeypointDiffusion
from kpdiff_tpu_torch.training.scheduler import SchedulerConfig, learning_rate, rec_encoder_weight

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
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam with coupled weight decay; the learning rate is set per step."""
    return torch.optim.Adam(model.parameters(), lr=cfg.learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS,
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


def loss_and_grads(model: KeypointDiffusion, cfg: TrainConfig, batch: PaddedComplex, w_rec: float,
                   params, generator: Optional[torch.Generator] = None,
                   t_eps: Optional[Tuple[Any, Any, Any]] = None, mesh=None, kp_axis: Optional[str] = None):
    """The step's forward and backward: (total, {loss: value}) as tensors and
    every parameter's .grad set (zero where the loss does not reach), each
    reduced over the mesh as the module docstring says."""
    from kpdiff_tpu_torch.parallel.kp_shard import kp_constraint

    accum = max(int(cfg.grad_accum or 1), 1)
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
    for p in params:
        if p.grad is None:  # a parameter the loss does not reach: Adam still decays it, as optax does
            p.grad = torch.zeros_like(p)
    if mesh is not None:
        if kp_axis is not None and mesh.group(kp_axis) is not None:
            partial = {id(p) for p in model.kp_row_parameters()}
            _all_reduce_flat([p.grad for p in params if id(p) in partial], mesh.group(kp_axis))
        if mesh.group("data") is not None:
            _all_reduce_flat([p.grad for p in params], mesh.group("data"), 1.0 / mesh.size("data"))
    if accum > 1:
        for p in params:
            p.grad.mul_(1.0 / accum)
        total_sum = total_sum * (1.0 / accum)
        loss_sums = {k: v * (1.0 / accum) for k, v in loss_sums.items()}
    return total_sum, loss_sums


def make_train_step(cfg: TrainConfig, iters_per_epoch: int, mesh=None,
                    kp_axis: Optional[str] = None) -> Callable[..., Dict[str, float]]:
    """Returns step(state, batch, generator=None, t_eps=None) -> metrics.

    The step updates `state` in place. `t_eps` = (t_int, eps_x, eps_h)
    replaces the loss's draws (the tests' seam); otherwise they come from
    `generator`. Metrics: the losses, total, lr, rec_enc_weight and
    skipped_nonfinite, as floats. With a `mesh` every rank passes its rows
    of the batch and of t_eps (`shard_batch(..., micro_batches=
    cfg.grad_accum)`) and a generator in the same state, and
    `kp_axis` names the axis that splits the keypoints."""
    sched = cfg.scheduler

    def step_fn(state: TrainState, batch: PaddedComplex, generator: Optional[torch.Generator] = None,
                t_eps: Optional[Tuple[Any, Any, Any]] = None) -> Dict[str, float]:
        model, opt = state.model, state.optimizer
        epoch_exact = float(np.float32(state.step) / np.float32(iters_per_epoch))
        w_rec = rec_encoder_weight(sched, epoch_exact)
        lr = learning_rate(sched, epoch_exact)
        params = [p for g in opt.param_groups for p in g["params"]]

        opt.zero_grad(set_to_none=True)
        total_sum, loss_sums = loss_and_grads(model, cfg, batch, w_rec, params, generator, t_eps, mesh, kp_axis)
        grads = [p.grad for p in params]

        keys = sorted(loss_sums)
        finite = torch.stack([torch.isfinite(total_sum)] + [torch.isfinite(g).all() for g in grads]).all()
        vec = torch.stack([finite.float(), total_sum] + [loss_sums[k] for k in keys])
        n = 1
        if mesh is not None and mesh.world is not None:
            # an agreed skip and the global means: sums over every rank, divided by the rank count
            dist.all_reduce(vec, group=mesh.world)
            n = mesh.n_devices
        host = [v / n for v in vec.tolist()]
        ok = host[0] == 1.0
        if ok:
            for group in opt.param_groups:
                group["lr"] = lr
            if cfg.clip_grad:
                torch.nn.utils.clip_grad_value_(params, cfg.clip_value)
            opt.step()
        opt.zero_grad(set_to_none=True)
        state.step += 1

        metrics = dict(zip(keys, host[2:]))
        metrics.update(total=host[1], lr=lr, rec_enc_weight=w_rec, skipped_nonfinite=0.0 if ok else 1.0)
        return metrics

    return step_fn


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
