"""Small building blocks with torch-default initialisation
(a frozen copy of kpdiff_tpu_torch/models/nn.py; the compute dtype
follows `precision.py`).

Parameters are named after the flax leaves and keep flax's (in, out)
weight layout, so `utils/params_io.py` copies JAX archives over unchanged:
`TorchLinear` holds `kernel` (in, out) and `bias`, `LayerNorm` holds
`scale` and `bias`. Initialisation draws from an explicit
`torch.Generator`.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import precision

def compute_dtype(name) -> torch.dtype:
    """float32 for 'float32'; a site the configuration computes in
    'bfloat16' takes `precision.site_dtype()`: float32 in the reference, the
    fp8 marker in the control."""
    if name in ("float32", torch.float32):
        return torch.float32
    if name in ("bfloat16", torch.bfloat16):
        return precision.site_dtype()
    raise ValueError(f"unsupported compute dtype {name!r}")


def uniform_(shape, bound: float, gen: torch.Generator) -> torch.Tensor:
    """U(-bound, bound) drawn from `gen`."""
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def torch_kernel(d_in: int, d_out: int, gen: torch.Generator) -> nn.Parameter:
    """(in, out) weight, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch Linear default)."""
    return nn.Parameter(uniform_((d_in, d_out), 1.0 / math.sqrt(d_in), gen))


def torch_bias(fan_in: int, d_out: int, gen: torch.Generator) -> nn.Parameter:
    return nn.Parameter(uniform_((d_out,), 1.0 / math.sqrt(fan_in), gen))


def xavier_uniform_scaled(d_in: int, d_out: int, gain: float, gen: torch.Generator) -> nn.Parameter:
    """xavier_uniform times `gain` (coord output layers use gain 0.001)."""
    return nn.Parameter(uniform_((d_in, d_out), math.sqrt(6.0 / (d_in + d_out)), gen) * gain)


def act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name:
        raise ValueError(f"activation {name!r} is not ported")
    return x


class TorchLinear(nn.Module):
    """y = x @ kernel + bias in the compute dtype (params stay float32)."""

    def __init__(self, d_in: int, d_out: int, gen: torch.Generator, use_bias: bool = True,
                 dtype: str = "float32"):
        super().__init__()
        self.kernel = torch_kernel(d_in, d_out, gen)
        self.bias = torch_bias(d_in, d_out, gen) if use_bias else None
        self.cd = compute_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.cd) @ self.kernel.to(self.cd)
        if self.bias is not None:
            y = y + self.bias.to(self.cd)
        return y


class MLP(nn.Module):
    """Linear/activation chain; acts[i] follows layer i ('' = none)."""

    def __init__(self, d_in: int, features: Sequence[int], acts: Sequence[str], gen: torch.Generator,
                 dtype: str = "float32"):
        super().__init__()
        self.acts = list(acts)
        dims = [d_in, *features]
        for i in range(len(features)):
            self.add_module(f"lin{i}", TorchLinear(dims[i], dims[i + 1], gen, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, a in enumerate(self.acts):
            x = act(a, getattr(self, f"lin{i}")(x))
        return x


class LayerNorm(nn.Module):
    """LayerNorm over the last dim (eps 1e-5), flax parameter names."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale.to(x.dtype), self.bias.to(x.dtype), self.eps)
