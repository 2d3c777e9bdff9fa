"""The reference's two precisions.

The reference computes in float32 with TF32 off. The control is the same
reference one precision lower at every site: where the configuration states
bfloat16, fp8 (e4m3, one scale per tensor); where it states float32, TF32
for the matrix products. Modules built inside `control_sites()` take a
marker dtype at the bfloat16 sites; under `FP8Sites` every cast to the
marker returns the tensor rounded through fp8 and held in float32, so
products and sums accumulate in float32 on fp8 operands, as an fp8 matrix
unit does, and every float32 operand of a matrix product is rounded to
TF32's 10-bit mantissa first (emulated, so the CPU tests see it too).
Gradients are rounded the same way on their way back.
"""
from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode

MARKER = torch.float16  # never computed in: only names the control's fp8 sites
FP8_MAX = 448.0  # largest finite e4m3 value

_site = {"dtype": torch.float32}


def site_dtype() -> torch.dtype:
    """The dtype of a site the configuration computes in bfloat16."""
    return _site["dtype"]


@contextlib.contextmanager
def control_sites():
    """Build modules whose bfloat16 sites carry the control's marker."""
    old = _site["dtype"]
    _site["dtype"] = MARKER
    try:
        yield
    finally:
        _site["dtype"] = old


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = torch.clamp(torch.amax(torch.abs(x)), min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _FP8(torch.autograd.Function):
    """Rounding through fp8 both ways: the values going forward, the
    gradients coming back."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x)

    @staticmethod
    def backward(ctx, grad):
        return _round_fp8(grad.float())


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest at 10 mantissa bits (TF32's operands)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_tf32(x)

    @staticmethod
    def backward(ctx, grad):
        return _round_tf32(grad)


def round_tf32(x):
    if not torch.is_tensor(x) or x.dtype != torch.float32:
        return x
    return _TF32.apply(x) if x.requires_grad else _round_tf32(x)


MATMULS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__, torch.mm,
           torch.bmm, torch.nn.functional.linear}


def quantize_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 with one scale for the whole tensor, back in float32
    (and its gradient rounded so on the way back)."""
    x = x.float()
    return _FP8.apply(x) if x.requires_grad else _round_fp8(x)


class FP8Sites(TorchFunctionMode):
    """Turns every `Tensor.to(MARKER)` into `quantize_fp8`, and rounds the
    float32 operands of matrix products and einsums to TF32."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.to:
            dtype = kwargs.get("dtype")
            if dtype is None:
                dtype = next((a for a in args[1:] if isinstance(a, torch.dtype)), None)
            if dtype is MARKER:
                return quantize_fp8(args[0])
        elif func in MATMULS:
            args = tuple(round_tf32(a) for a in args)
        elif func is torch.einsum:
            ops = args[1:]
            if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
                ops = tuple(ops[0])
            args = (args[0], *(round_tf32(a) for a in ops))
        return func(*args, **kwargs)


def reference_matmul_precision():
    """Plain float32 matrix products on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
