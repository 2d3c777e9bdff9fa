"""PyTorch/CUDA port of kpdiff_tpu for NVIDIA Hopper (H100).

Module paths mirror `kpdiff_tpu/` so each module's JAX counterpart sits at
the same relative path. This package imports torch, numpy and scipy only:
no JAX, flax, optax, orbax, PyYAML and nothing from `kpdiff_tpu` (it keeps
its own copies of the host helpers it needs). Entry points default to
`device="cuda"` and raise when CUDA is missing; pass `device="cpu"` to run
the plain PyTorch versions of the kernels on the CPU.
"""
