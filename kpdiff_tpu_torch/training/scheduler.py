"""Learning rate and loss-weight schedules as plain float functions of the
fractional epoch (kpdiff_tpu/training/scheduler.py): linear warm-up,
optional linear or cosine restarts, sigmoid decay of the receptor-encoder
loss weight. The JAX package evaluates them in float32 inside its jitted
step; these evaluate them in float32 on the host, so both give the same
numbers."""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    base_lr: float = 1e-4
    warmup_length: float = 0.0  # epochs
    restart_interval: float = 0.0  # epochs; 0 -> no restarts
    restart_type: str = "cosine"  # 'linear' | 'cosine'
    rec_enc_loss_weight: float = 0.1
    rec_enc_weight_decay_midpoint: float = 0.0  # 0 -> constant weight
    rec_enc_weight_decay_scale: float = 1.0


def learning_rate(cfg: SchedulerConfig, epoch_exact: float) -> float:
    """LR at a fractional epoch: base_lr * epoch / warmup during the warm-up,
    then constant or cycling on (epoch - warmup) mod restart_interval."""
    f = np.float32
    e = f(epoch_exact)
    base = f(cfg.base_lr)
    warm = base * e / f(max(cfg.warmup_length, 1e-9))
    if cfg.restart_interval > 0:
        into = np.fmod(e - f(cfg.warmup_length), f(cfg.restart_interval))
        if into < 0:  # jnp.mod takes the divisor's sign
            into = into + f(cfg.restart_interval)
        if cfg.restart_type == "linear":
            after = base * (f(1.0) - into / f(cfg.restart_interval))
        elif cfg.restart_type == "cosine":
            after = f(0.5) * base * (f(1.0) + np.cos(into * f(math.pi) / f(cfg.restart_interval)))
        else:
            raise NotImplementedError(cfg.restart_type)
    else:
        after = base
    if cfg.warmup_length > 0 and e <= f(cfg.warmup_length):
        return float(warm)
    return float(after)


def rec_encoder_weight(cfg: SchedulerConfig, epoch_exact: float) -> float:
    """Sigmoid decay of the OT-loss weight around its midpoint epoch."""
    f = np.float32
    if cfg.rec_enc_weight_decay_midpoint == 0:
        return float(f(cfg.rec_enc_loss_weight))
    e = f(epoch_exact)
    coeff = f(1.0) - f(1.0) / (f(1.0) + np.exp(-(e - f(cfg.rec_enc_weight_decay_midpoint))
                                               * f(cfg.rec_enc_weight_decay_scale)))
    return float(coeff * f(cfg.rec_enc_loss_weight))


def is_restart_boundary(cfg: SchedulerConfig, prev_epoch: float, epoch: float) -> bool:
    """Whether a restart lies between prev_epoch and epoch (a checkpoint is
    saved at each restart)."""
    if cfg.restart_interval <= 0:
        return False
    if epoch <= cfg.warmup_length:
        return False
    k_prev = int(max(prev_epoch - cfg.warmup_length, 0) // cfg.restart_interval)
    k_now = int(max(epoch - cfg.warmup_length, 0) // cfg.restart_interval)
    return k_now > k_prev
