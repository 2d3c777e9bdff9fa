"""Device resolution for the port's entry points.

Entry points default to CUDA and raise when it is missing: nothing in the
port carries on silently on the CPU. A caller that wants the CPU (the tests)
asks for it with `device="cpu"`.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
