"""Variance-preserving noise schedules and transition algebra
(kpdiff_tpu/ops/schedule.py).

The gamma table is built in numpy float64 and stored as float32, exactly as
the JAX package builds it; the transition coefficients keep its
`_softplus`/`_log_sigmoid` forms.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "cosine_beta_schedule",
    "clip_noise_schedule",
    "polynomial_schedule",
    "NoiseSchedule",
    "sigma_from_gamma",
    "alpha_from_gamma",
    "sigma_and_alpha_t_given_s",
]


def cosine_beta_schedule(timesteps: int, s: float = 0.008, raise_to_power: float = 1.0) -> np.ndarray:
    steps = timesteps + 2
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    betas = np.clip(betas, a_min=0, a_max=0.999)
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    if raise_to_power != 1:
        alphas_cumprod = np.power(alphas_cumprod, raise_to_power)
    return alphas_cumprod


def clip_noise_schedule(alphas2: np.ndarray, clip_value: float = 0.001) -> np.ndarray:
    alphas2 = np.concatenate([np.ones(1), alphas2], axis=0)
    alphas_step = np.clip(alphas2[1:] / alphas2[:-1], a_min=clip_value, a_max=1.0)
    return np.cumprod(alphas_step, axis=0)


def polynomial_schedule(timesteps: int, s: float = 1e-4, power: float = 3.0) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas2 = (1 - np.power(x / steps, power)) ** 2
    alphas2 = clip_noise_schedule(alphas2, clip_value=0.001)
    precision = 1 - 2 * s
    return precision * alphas2 + s


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """gamma(t) = -log(alpha^2/sigma^2) on a (T+1)-point grid."""

    timesteps: int
    gamma_table: np.ndarray  # (timesteps + 1,) float32
    # the table on each device it was read on, copied there once: a step captured into a CUDA graph must not
    # copy from host memory
    _on_device: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @staticmethod
    def create(noise_schedule: str = "polynomial_2", timesteps: int = 1000,
               precision: float = 1e-4) -> "NoiseSchedule":
        if noise_schedule == "cosine":
            alphas2 = cosine_beta_schedule(timesteps)
        elif noise_schedule.startswith("polynomial"):
            splits = noise_schedule.split("_")
            if len(splits) != 2:
                raise ValueError(f"bad polynomial schedule name: {noise_schedule}")
            alphas2 = polynomial_schedule(timesteps, s=precision, power=float(splits[1]))
        else:
            raise ValueError(f"unknown noise schedule: {noise_schedule}")
        sigmas2 = 1 - alphas2
        gamma = -(np.log(alphas2) - np.log(sigmas2))
        return NoiseSchedule(timesteps=timesteps, gamma_table=gamma.astype(np.float32))

    def gamma(self, t: torch.Tensor) -> torch.Tensor:
        """gamma at continuous t in [0, 1]; indexes the table at round(t*T)."""
        table = self._on_device.get(t.device)
        if table is None:
            table = self._on_device[t.device] = torch.as_tensor(self.gamma_table, device=t.device)
        return table[torch.round(t * self.timesteps).long()]


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def sigma_from_gamma(gamma: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_sigmoid(gamma))


def alpha_from_gamma(gamma: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_sigmoid(-gamma))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -_softplus(-x)


def sigma_and_alpha_t_given_s(gamma_t: torch.Tensor, gamma_s: torch.Tensor):
    """(sigma^2_{t|s}, sigma_{t|s}, alpha_{t|s}) of q(z_t | z_s), s < t."""
    sigma2_t_given_s = -torch.expm1(_softplus(gamma_s) - _softplus(gamma_t))
    alpha_t_given_s = torch.exp(0.5 * (_log_sigmoid(-gamma_t) - _log_sigmoid(-gamma_s)))
    return sigma2_t_given_s, torch.sqrt(sigma2_t_given_s), alpha_t_given_s
